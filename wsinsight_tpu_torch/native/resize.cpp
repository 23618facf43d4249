// PIL-exact bilinear (antialias) uint8 resize, batch API.
//
// The decode threads' host-resize path (engine/data.py) previously ran PIL
// per patch under the GIL — on a thin host that serialized the pool right
// where it should scale. This reimplements PIL's two-pass fixed-point
// resample (ImagingResampleHorizontal_8bpc: int32 coefficients at
// PRECISION_BITS=22, per-pass round + clip to uint8) so one ctypes call
// resizes a whole batch with the GIL released.
//
// Bit-identity is guaranteed by construction: the caller passes the SAME
// quantized coefficient matrices the device path uses
// (ops/preprocess.py:_pil_bilinear_weights scaled to int32), so this path,
// PIL, and the device's fixed-point resize all compute identical uint8 planes.
// (Reference transform semantics: wsinsight/modellib/transforms.py:22-38.)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 22;
constexpr int32_t kHalf = 1 << (kPrecisionBits - 1);

inline uint8_t clip8(int32_t v) {
  v = (v + kHalf) >> kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

// Per-output-row tap bounds of a banded (out, in) coefficient matrix.
struct Band {
  std::vector<int32_t> lo, hi;  // [lo, hi) tap range per output index
  void init(const int32_t* k, int out, int in) {
    lo.resize(out);
    hi.resize(out);
    for (int o = 0; o < out; ++o) {
      const int32_t* row = k + static_cast<int64_t>(o) * in;
      int a = 0, b = in;
      while (a < in && row[a] == 0) ++a;
      while (b > a && row[b - 1] == 0) --b;
      lo[o] = a;
      hi[o] = b;
    }
  }
};

}  // namespace

extern "C" {

// src: (n, h, w, c) uint8 contiguous; dst: (n, oh, ow, c) uint8 contiguous.
// kw: (ow, w) int32 row-major; kh: (oh, h) int32 row-major — PIL fixed-point
// coefficient matrices (already quantized to 2^22). Horizontal pass runs
// first, then vertical, with uint8 rounding after each pass, exactly like
// PIL / ops/preprocess.pil_resize_batch(exact=True).
int32_t pil_resize_u8_batch(const uint8_t* src, int64_t n, int32_t h,
                            int32_t w, int32_t c, const int32_t* kw,
                            int32_t ow, const int32_t* kh, int32_t oh,
                            uint8_t* dst) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || ow <= 0 || oh <= 0) return -1;
  if (c > 8) return -1;

  Band bw, bh;
  bw.init(kw, ow, w);
  bh.init(kh, oh, h);

  const int64_t src_img = static_cast<int64_t>(h) * w * c;
  const int64_t dst_img = static_cast<int64_t>(oh) * ow * c;
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * c);

  for (int64_t img = 0; img < n; ++img) {
    const uint8_t* s = src + img * src_img;
    uint8_t* d = dst + img * dst_img;

    // Pass 1: horizontal (width w -> ow), all h rows. RGB gets a scalar-
    // register specialization (acc arrays defeat the register allocator).
    for (int y = 0; y < h; ++y) {
      const uint8_t* srow = s + static_cast<int64_t>(y) * w * c;
      uint8_t* trow = tmp.data() + static_cast<int64_t>(y) * ow * c;
      if (c == 3) {
        for (int ox = 0; ox < ow; ++ox) {
          const int32_t* krow = kw + static_cast<int64_t>(ox) * w;
          int32_t a0 = 0, a1 = 0, a2 = 0;
          const int x_hi = bw.hi[ox];
          for (int x = bw.lo[ox]; x < x_hi; ++x) {
            const int32_t k = krow[x];
            const uint8_t* px = srow + 3 * static_cast<int64_t>(x);
            a0 += k * px[0];
            a1 += k * px[1];
            a2 += k * px[2];
          }
          trow[ox * 3] = clip8(a0);
          trow[ox * 3 + 1] = clip8(a1);
          trow[ox * 3 + 2] = clip8(a2);
        }
        continue;
      }
      for (int ox = 0; ox < ow; ++ox) {
        const int32_t* krow = kw + static_cast<int64_t>(ox) * w;
        int32_t acc[8] = {0};
        for (int x = bw.lo[ox]; x < bw.hi[ox]; ++x) {
          const int32_t k = krow[x];
          const uint8_t* px = srow + static_cast<int64_t>(x) * c;
          for (int ch = 0; ch < c; ++ch) acc[ch] += k * px[ch];
        }
        for (int ch = 0; ch < c; ++ch) trow[ox * c + ch] = clip8(acc[ch]);
      }
    }

    // Pass 2: vertical (height h -> oh) over the ow-wide intermediate.
    // Accumulate whole ow*c rows tap by tap: the inner loop is a contiguous
    // int32 += k * u8 stream the compiler vectorizes (AVX2/AVX512), unlike
    // the per-pixel gather formulation (~2.5x faster on the decode hosts).
    // Same MACs in the same int32 domain -> bit-identical output.
    const int rowlen = ow * c;
    std::vector<int32_t> accrow(rowlen);
    for (int oy = 0; oy < oh; ++oy) {
      const int32_t* krow = kh + static_cast<int64_t>(oy) * h;
      uint8_t* drow = d + static_cast<int64_t>(oy) * ow * c;
      const int y_lo = bh.lo[oy], y_hi = bh.hi[oy];
      std::memset(accrow.data(), 0, sizeof(int32_t) * rowlen);
      for (int y = y_lo; y < y_hi; ++y) {
        const int32_t k = krow[y];
        const uint8_t* trow = tmp.data() + static_cast<int64_t>(y) * rowlen;
        for (int i = 0; i < rowlen; ++i) accrow[i] += k * trow[i];
      }
      for (int i = 0; i < rowlen; ++i) drow[i] = clip8(accrow[i]);
    }
  }
  return 0;
}

}  // extern "C"
