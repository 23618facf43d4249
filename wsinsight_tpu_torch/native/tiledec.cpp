// Native slide region decoder: the CPU hot loop that feeds the card.
//
// The reference gets patch decode throughput from torch DataLoader worker
// PROCESSES wrapping libtiff/openslide (reference: wsinsight/modellib/
// data.py:198-236, run_inference.py:288-299).  Here the whole per-batch path —
// pread of compressed tiles, JPEG (libjpeg-turbo, JCS_EXT_RGB) / Deflate /
// LZW decode, tile LRU, and patch assembly — runs in one C call with the GIL
// released, so Python threads only orchestrate.
//
// Exposed (ctypes, see native/__init__.py):
//   wsi_open(...)          -> int64 handle (or -1)
//   wsi_read_patches(...)  -> batch of (ph, pw, 3) uint8 patches
//   wsi_read_region(...)   -> single region
//   wsi_close(handle)
//   wsi_has_jpeg()         -> 1 when built with libjpeg, else 0
//
// Built with -DWSI_NO_JPEG (the build's choice when it finds no libjpeg),
// the JPEG codec is left out: wsi_open declines JPEG pages, and the caller
// decodes them through its Python tile path.
//
// All decode output is 3-channel RGB (gray replicated, alpha dropped),
// mirroring TpuSlide._get_segment.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <fcntl.h>
#include <unistd.h>
#include <list>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>

#ifndef WSI_NO_JPEG
#include <jpeglib.h>
#endif
#include <zlib.h>

// from lzw.cpp (same shared object)
extern "C" int64_t lzw_decode(const uint8_t* src, int64_t src_len, uint8_t* out,
                              int64_t out_cap);

namespace {

constexpr int32_t COMP_NONE = 1;
constexpr int32_t COMP_LZW = 5;
constexpr int32_t COMP_JPEG_OLD = 6;
constexpr int32_t COMP_JPEG = 7;
constexpr int32_t COMP_DEFLATE_ADOBE = 8;
constexpr int32_t COMP_PACKBITS = 32773;
constexpr int32_t COMP_DEFLATE = 32946;

#ifndef WSI_NO_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_silence(j_common_ptr, int) {}
#endif  // WSI_NO_JPEG

struct Page {
  int fd = -1;
  std::vector<uint64_t> offsets;
  std::vector<uint64_t> bytecounts;
  int32_t compression = COMP_NONE;
  int32_t predictor = 1;
  int32_t samples = 3;
  bool tiled = true;
  int32_t tile_w = 0, tile_h = 0;  // for strips: tile_w = page_w, tile_h = rows_per_strip
  int64_t page_w = 0, page_h = 0;
  // DCT-domain scaled decode (JPEG only): libjpeg decodes each segment at
  // 1/scale_denom via a smaller IDCT; all Page geometry (tile/page dims) is
  // stored pre-halved (ceil), so the blit/read logic is scale-agnostic and
  // callers address the page in SCALED pixel coordinates.
  int32_t scale_denom = 1;
  std::vector<uint8_t> jpeg_tables;

  // LRU of decoded RGB tiles (tile_h * tile_w * 3 bytes each). Entries are
  // shared_ptr so a reader holding a pin survives concurrent eviction.
  std::mutex mu;
  std::list<std::pair<int64_t, std::shared_ptr<std::vector<uint8_t>>>> lru;
  std::unordered_map<int64_t, decltype(lru)::iterator> index;
  size_t cache_bytes = 0;
  size_t cache_budget = 0;

  int64_t tiles_across() const {
    return tiled ? (page_w + tile_w - 1) / tile_w : 1;
  }
  int64_t tiles_down() const {
    return (page_h + tile_h - 1) / tile_h;
  }

  ~Page() {
    if (fd >= 0) close(fd);
  }
};

std::mutex g_registry_mu;
// Pages are shared_ptr so wsi_close during an in-flight read (a decode
// thread racing PatchBatchSource.close()) can never free memory under a
// reader — the last pin wins, not the close.
std::unordered_map<int64_t, std::shared_ptr<Page>> g_registry;
int64_t g_next_handle = 1;

std::shared_ptr<Page> lookup(int64_t handle) {
  std::lock_guard<std::mutex> g(g_registry_mu);
  auto it = g_registry.find(handle);
  return it == g_registry.end() ? nullptr : it->second;
}

#ifndef WSI_NO_JPEG
// Decode one JPEG stream (abbreviated streams use the separate-tables
// two-phase read).  When the image is RGB and exactly (exp_w, exp_h), rows
// are written straight into `out` (no intermediate buffer); otherwise the
// decode lands in a temp and is padded/cropped into the nominal tile shape.
// Returns false on any libjpeg error.
bool decode_jpeg(const Page& pg, const uint8_t* data, size_t len,
                 std::vector<uint8_t>& out, int exp_w, int exp_h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_error_exit;
  err.mgr.emit_message = jpeg_silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  if (pg.jpeg_tables.size() > 4) {
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(pg.jpeg_tables.data()),
                 pg.jpeg_tables.size());
    jpeg_read_header(&cinfo, FALSE);
  }
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  if (pg.scale_denom > 1) {  // DCT-scaled decode: 4x4 IDCT at denom 2
    cinfo.scale_num = 8 / pg.scale_denom;
    cinfo.scale_denom = 8;
  }
  bool gray = cinfo.num_components == 1;
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_EXT_RGB;
#else
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
#endif
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width;
  int h = cinfo.output_height;
  int ch = cinfo.output_components;

  if (ch == 3 && w == exp_w && h == exp_h) {  // fast path: decode in place
    out.resize((size_t)w * h * 3);
    size_t stride = (size_t)w * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* row = out.data() + (size_t)cinfo.output_scanline * stride;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
  }

  std::vector<uint8_t> raw((size_t)w * h * ch);
  size_t stride = (size_t)w * ch;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = raw.data() + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // pad/crop to the nominal tile shape, replicating gray to RGB
  out.assign((size_t)exp_w * exp_h * 3, 0);
  int cw = std::min(w, exp_w), chh = std::min(h, exp_h);
  for (int y = 0; y < chh; y++) {
    uint8_t* dst = out.data() + (size_t)y * exp_w * 3;
    const uint8_t* src = raw.data() + (size_t)y * stride;
    if (ch == 3) {
      memcpy(dst, src, (size_t)cw * 3);
    } else {
      for (int x = 0; x < cw; x++) {
        uint8_t v = src[x * ch];
        dst[3 * x] = v;
        dst[3 * x + 1] = v;
        dst[3 * x + 2] = v;
      }
    }
  }
  return true;
}
#endif  // WSI_NO_JPEG

// PackBits (TIFF 32773).
void packbits_decode(const uint8_t* src, size_t len, uint8_t* out,
                     size_t out_cap) {
  size_t i = 0, o = 0;
  while (i < len && o < out_cap) {
    int8_t n = (int8_t)src[i++];
    if (n >= 0) {
      size_t cnt = std::min((size_t)n + 1, std::min(len - i, out_cap - o));
      memcpy(out + o, src + i, cnt);
      i += cnt;
      o += cnt;
    } else if (n != -128) {
      if (i >= len) break;
      size_t cnt = std::min((size_t)(-n) + 1, out_cap - o);
      memset(out + o, src[i++], cnt);
      o += cnt;
    }
  }
}

// Decode segment `idx` into a nominal (seg_h, seg_w, 3) RGB buffer.
// seg_h for strips is clipped at the page edge like the Python reader.
bool decode_segment(Page& pg, int64_t idx, std::vector<uint8_t>& out) {
  int seg_w, seg_h;
  if (pg.tiled) {
    seg_w = pg.tile_w;
    seg_h = pg.tile_h;
  } else {
    seg_w = (int)pg.page_w;
    int64_t row0 = idx * pg.tile_h;
    seg_h = (int)std::min<int64_t>(pg.tile_h, pg.page_h - row0);
    if (seg_h <= 0) return false;
  }
  if (idx < 0 || idx >= (int64_t)pg.offsets.size()) return false;
  uint64_t cnt = pg.bytecounts[idx];
  if (cnt == 0) {  // sparse tile -> zeros
    out.assign((size_t)seg_w * seg_h * 3, 0);
    return true;
  }

  std::vector<uint8_t> raw(cnt);
  ssize_t got = pread(pg.fd, raw.data(), cnt, (off_t)pg.offsets[idx]);
  if (got != (ssize_t)cnt) return false;

  if (pg.compression == COMP_JPEG || pg.compression == COMP_JPEG_OLD) {
#ifndef WSI_NO_JPEG
    return decode_jpeg(pg, raw.data(), raw.size(), out, seg_w, seg_h);
#else
    return false;  // not reached: wsi_open declines JPEG pages
#endif
  }
  out.assign((size_t)seg_w * seg_h * 3, 0);

  // Byte-oriented codecs: decompress samples, then predictor + channel fix.
  int s = pg.samples;
  size_t out_size = (size_t)seg_w * seg_h * s;
  std::vector<uint8_t> data(out_size, 0);
  switch (pg.compression) {
    case COMP_NONE: {
      memcpy(data.data(), raw.data(), std::min(raw.size(), out_size));
      break;
    }
    case COMP_DEFLATE:
    case COMP_DEFLATE_ADOBE: {
      uLongf dlen = out_size;
      if (uncompress(data.data(), &dlen, raw.data(), raw.size()) != Z_OK)
        return false;
      break;
    }
    case COMP_LZW: {
      if (lzw_decode(raw.data(), (int64_t)raw.size(), data.data(),
                     (int64_t)out_size) < 0)
        return false;
      break;
    }
    case COMP_PACKBITS: {
      packbits_decode(raw.data(), raw.size(), data.data(), out_size);
      break;
    }
    default:
      return false;
  }
  if (pg.predictor == 2) {  // horizontal differencing, per row, per channel
    for (int y = 0; y < seg_h; y++) {
      uint8_t* row = data.data() + (size_t)y * seg_w * s;
      for (int x = 1; x < seg_w; x++)
        for (int c = 0; c < s; c++)
          row[x * s + c] = (uint8_t)(row[x * s + c] + row[(x - 1) * s + c]);
    }
  }
  // channel fix -> 3
  if (s == 3) {
    out.swap(data);
  } else if (s == 1) {
    for (size_t i = 0, n = (size_t)seg_w * seg_h; i < n; i++) {
      uint8_t v = data[i];
      out[3 * i] = v;
      out[3 * i + 1] = v;
      out[3 * i + 2] = v;
    }
  } else {  // s >= 4: drop extra samples
    for (size_t i = 0, n = (size_t)seg_w * seg_h; i < n; i++) {
      memcpy(out.data() + 3 * i, data.data() + (size_t)s * i, 3);
    }
  }
  return true;
}

// Cache get/put with shared_ptr pinning: decode runs unlocked (same
// discipline as the Python tile cache, wsi/slide.py:104-124); a reader's pin
// keeps a tile alive across concurrent eviction.
std::shared_ptr<std::vector<uint8_t>> cache_get(Page& pg, int64_t idx) {
  std::lock_guard<std::mutex> g(pg.mu);
  auto it = pg.index.find(idx);
  if (it == pg.index.end()) return nullptr;
  pg.lru.splice(pg.lru.begin(), pg.lru, it->second);
  return it->second->second;
}

void cache_put(Page& pg, int64_t idx,
               std::shared_ptr<std::vector<uint8_t>> tile) {
  std::lock_guard<std::mutex> g(pg.mu);
  if (pg.index.count(idx)) return;
  pg.cache_bytes += tile->size();
  pg.lru.emplace_front(idx, std::move(tile));
  pg.index[idx] = pg.lru.begin();
  while (pg.cache_bytes > pg.cache_budget && pg.lru.size() > 1) {
    auto& back = pg.lru.back();
    pg.cache_bytes -= back.second->size();
    pg.index.erase(back.first);
    pg.lru.pop_back();
  }
}

// Copy the intersection of tile (tx, ty) with the request window into out.
bool blit_tile(Page& pg, int64_t tx, int64_t ty, int64_t x0, int64_t y0,
               int32_t w, int32_t h, uint8_t* out) {
  int64_t tidx = pg.tiled ? ty * pg.tiles_across() + tx : ty;
  std::shared_ptr<std::vector<uint8_t>> tile = cache_get(pg, tidx);
  if (!tile) {
    auto fresh = std::make_shared<std::vector<uint8_t>>();
    if (!decode_segment(pg, tidx, *fresh)) return false;
    cache_put(pg, tidx, fresh);
    tile = std::move(fresh);
  }
  int64_t gx0 = pg.tiled ? tx * pg.tile_w : 0;
  int64_t gy0 = ty * pg.tile_h;
  int seg_w = pg.tiled ? pg.tile_w : (int)pg.page_w;
  int64_t seg_h = pg.tiled
                      ? pg.tile_h
                      : std::min<int64_t>(pg.tile_h, pg.page_h - gy0);
  // window intersect, also clipped to page bounds
  int64_t ix0 = std::max<int64_t>({x0, gx0, (int64_t)0});
  int64_t iy0 = std::max<int64_t>({y0, gy0, (int64_t)0});
  int64_t ix1 = std::min<int64_t>({x0 + w, gx0 + seg_w, pg.page_w});
  int64_t iy1 = std::min<int64_t>({y0 + h, gy0 + seg_h, pg.page_h});
  for (int64_t y = iy0; y < iy1; y++) {
    if (ix1 <= ix0) break;
    memcpy(out + ((y - y0) * w + (ix0 - x0)) * 3,
           tile->data() + ((y - gy0) * seg_w + (ix0 - gx0)) * 3,
           (size_t)(ix1 - ix0) * 3);
  }
  return true;
}

bool read_region(Page& pg, int64_t x0, int64_t y0, int32_t w, int32_t h,
                 uint8_t* out) {
  memset(out, 0, (size_t)w * h * 3);
  int64_t lx0 = std::max<int64_t>(x0, 0), ly0 = std::max<int64_t>(y0, 0);
  int64_t lx1 = std::min<int64_t>(x0 + w, pg.page_w);
  int64_t ly1 = std::min<int64_t>(y0 + h, pg.page_h);
  if (lx1 <= lx0 || ly1 <= ly0) return true;  // fully out of bounds -> zeros
  int64_t tw = pg.tiled ? pg.tile_w : pg.page_w;
  int64_t th = pg.tile_h;
  int64_t ty0 = ly0 / th, ty1 = (ly1 - 1) / th;
  int64_t tx0 = lx0 / tw, tx1 = (lx1 - 1) / tw;
  for (int64_t ty = ty0; ty <= ty1; ty++)
    for (int64_t tx = tx0; tx <= tx1; tx++)
      if (!blit_tile(pg, tx, ty, x0, y0, w, h, out)) return false;
  return true;
}

}  // namespace

extern "C" {

int32_t wsi_has_jpeg() {
#ifndef WSI_NO_JPEG
  return 1;
#else
  return 0;
#endif
}

int64_t wsi_open(const char* path, int64_t n_segments, const uint64_t* offsets,
                 const uint64_t* bytecounts, int32_t compression,
                 int32_t predictor, int32_t samples, int32_t tiled,
                 int32_t tile_w, int32_t tile_h, int64_t page_w,
                 int64_t page_h, const uint8_t* jpeg_tables,
                 int64_t tables_len, int64_t cache_mb, int32_t scale_denom) {
  switch (compression) {
    case COMP_NONE:
    case COMP_LZW:
#ifndef WSI_NO_JPEG
    case COMP_JPEG_OLD:
    case COMP_JPEG:
#endif
    case COMP_DEFLATE_ADOBE:
    case COMP_PACKBITS:
    case COMP_DEFLATE:
      break;
    default:
      return -1;  // unsupported -> caller falls back to Python decode
  }
  if (scale_denom != 1) {
    // DCT-scaled decode needs libjpeg's scaled IDCT; only denom 2 is wired
    // (the fast-input mode), and only for JPEG-compressed pages.
    if (scale_denom != 2 ||
        (compression != COMP_JPEG && compression != COMP_JPEG_OLD))
      return -1;
    // Odd segment dims would break the scaled tiling arithmetic (segment k
    // must start at k * ceil(seg/denom) in scaled space). JPEG tiles are
    // MCU-multiples in practice, so this never fires for real slides.
    if ((tile_w % scale_denom) || (tile_h % scale_denom)) return -1;
  }
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  auto pg = std::make_shared<Page>();
  pg->fd = fd;
  pg->offsets.assign(offsets, offsets + n_segments);
  pg->bytecounts.assign(bytecounts, bytecounts + n_segments);
  pg->compression = compression;
  pg->predictor = predictor;
  pg->samples = samples;
  pg->tiled = tiled != 0;
  pg->scale_denom = scale_denom;
  // Store geometry pre-scaled (ceil): callers address SCALED coordinates
  // and libjpeg's scaled output dims are exactly ceil(dim / denom).
  pg->tile_w = (tile_w + scale_denom - 1) / scale_denom;
  pg->tile_h = (tile_h + scale_denom - 1) / scale_denom;
  pg->page_w = (page_w + scale_denom - 1) / scale_denom;
  pg->page_h = (page_h + scale_denom - 1) / scale_denom;
  if (jpeg_tables && tables_len > 0)
    pg->jpeg_tables.assign(jpeg_tables, jpeg_tables + tables_len);
  pg->cache_budget = (size_t)cache_mb << 20;
  std::lock_guard<std::mutex> g(g_registry_mu);
  int64_t h = g_next_handle++;
  g_registry[h] = std::move(pg);
  return h;
}

int32_t wsi_read_region(int64_t handle, int64_t x0, int64_t y0, int32_t w,
                        int32_t h, uint8_t* out) {
  std::shared_ptr<Page> pg = lookup(handle);  // pins across the read
  if (!pg) return -1;
  return read_region(*pg, x0, y0, w, h, out) ? 0 : -2;
}

// Batch: n patches of (ph, pw, 3) at level coords (x, y) interleaved in `xy`.
int32_t wsi_read_patches(int64_t handle, int64_t n, const int64_t* xy,
                         int32_t pw, int32_t ph, uint8_t* out) {
  std::shared_ptr<Page> pg = lookup(handle);  // pins across the batch
  if (!pg) return -1;
  size_t stride = (size_t)pw * ph * 3;
  for (int64_t i = 0; i < n; i++) {
    if (!read_region(*pg, xy[2 * i], xy[2 * i + 1], pw, ph, out + i * stride))
      return -2;
  }
  return 0;
}

void wsi_close(int64_t handle) {
  std::shared_ptr<Page> pg;
  {
    std::lock_guard<std::mutex> g(g_registry_mu);
    auto it = g_registry.find(handle);
    if (it != g_registry.end()) {
      pg = std::move(it->second);
      g_registry.erase(it);
    }
  }
  // pg destructs here — or when the last in-flight reader drops its pin
}

}  // extern "C"
