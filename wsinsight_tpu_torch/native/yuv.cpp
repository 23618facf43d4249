// RGB -> planar YUV 4:2:0 batch packer: the "thin link" wire format.
//
// On hosts whose link to the card is thin, the host->device transfer of
// decoded uint8 patches can bound end-to-end throughput. Shipping BT.601
// YCbCr with 2x2-subsampled chroma halves the wire bytes (1.5 B/px vs
// 3 B/px); the device reconstructs RGB in the engine's step
// (ops/preprocess.yuv420_to_rgb). Opt-in (WSINSIGHT_WIRE=yuv420): chroma
// subsampling is lossy, so the exact RGB wire stays the default (reference
// decode path: wsinsight/modellib/data.py:283-314 ships full RGB tensors to
// the GPU).
//
// Layout per image (h, w even): (h*3/2, w) uint8 —
//   rows [0, h):        Y plane
//   rows [h, h*3/2):    chroma row r holds Cb at cols [0, w/2),
//                       Cr at cols [w/2, w)   (both (h/2, w/2))
//
// Forward transform: BT.601 full-range, 16-bit fixed point, round-half-up;
// chroma is the rounded mean of the 2x2 block's fixed-point Cb/Cr.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kHalf = 1 << 15;  // rounding for the >>16

inline int32_t y_fp(int r, int g, int b) {
  return 19595 * r + 38470 * g + 7471 * b;  // 0.299 / 0.587 / 0.114
}
inline int32_t cb_fp(int r, int g, int b) {
  return -11056 * r - 21712 * g + 32768 * b;  // -0.168736 / -0.331264 / 0.5
}
inline int32_t cr_fp(int r, int g, int b) {
  return 32768 * r - 27440 * g - 5328 * b;  // 0.5 / -0.418688 / -0.081312
}

inline uint8_t clamp_u8(int32_t v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// src: (n, h, w, 3) uint8 contiguous; out: (n, h*3/2, w) uint8 contiguous.
// h and w must be even. Returns 0 on success, nonzero on bad geometry.
int32_t rgb_to_yuv420_batch(const uint8_t* src, int64_t n, int32_t h,
                            int32_t w, uint8_t* out) {
  if (h <= 0 || w <= 0 || (h & 1) || (w & 1)) return 1;
  const int64_t in_stride = (int64_t)h * w * 3;
  const int64_t out_stride = (int64_t)h * w * 3 / 2;
  const int32_t cw = w / 2;

  // Per-row fixed-point chroma staging (two rows at a time for the 2x2 mean).
  std::vector<int32_t> cb_rows(2 * (size_t)w), cr_rows(2 * (size_t)w);

  for (int64_t i = 0; i < n; i++) {
    const uint8_t* img = src + i * in_stride;
    uint8_t* yp = out + i * out_stride;
    uint8_t* cp = yp + (int64_t)h * w;  // chroma rows

    for (int32_t y = 0; y < h; y += 2) {
      for (int32_t dy = 0; dy < 2; dy++) {
        const uint8_t* row = img + (int64_t)(y + dy) * w * 3;
        uint8_t* yrow = yp + (int64_t)(y + dy) * w;
        int32_t* cbr = cb_rows.data() + (size_t)dy * w;
        int32_t* crr = cr_rows.data() + (size_t)dy * w;
        for (int32_t x = 0; x < w; x++) {
          int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
          yrow[x] = (uint8_t)((y_fp(r, g, b) + kHalf) >> 16);
          cbr[x] = cb_fp(r, g, b);
          crr[x] = cr_fp(r, g, b);
        }
      }
      uint8_t* crow = cp + (int64_t)(y / 2) * w;
      for (int32_t x = 0; x < w; x += 2) {
        // mean of the 2x2 block in fixed point, then bias + round
        int64_t cb = (int64_t)cb_rows[x] + cb_rows[x + 1] +
                     cb_rows[w + x] + cb_rows[w + x + 1];
        int64_t cr = (int64_t)cr_rows[x] + cr_rows[x + 1] +
                     cr_rows[w + x] + cr_rows[w + x + 1];
        crow[x / 2] =
            clamp_u8((int32_t)(((cb + 2) / 4 + (128 << 16) + kHalf) >> 16));
        crow[cw + x / 2] =
            clamp_u8((int32_t)(((cr + 2) / 4 + (128 << 16) + kHalf) >> 16));
      }
    }
  }
  return 0;
}

}  // extern "C"
