// K1 on Hopper: fused uint8 -> PIL bilinear resize -> ToTensor/Normalize.
//
// Replaces the TPU kernel `_kernel` of wsinsight_tpu/ops/pallas_preprocess.py
// (launched by `fused_preprocess`, built by `make_fused_preprocess_fn`). Same
// contract: per pixel and channel,
//   1. horizontal PIL triangle-filter resize, rounded floor(y + 0.5) and
//      clipped to [0, 255] (PIL stores each pass as uint8);
//   2. vertical resize, rounded and clipped the same way;
//   3. z * scale[c] + shift[c], which folds ToTensor and Normalize.
//
// Bound: memory. About 4 taps per output per pass (350 -> 224), well under
// 1 GFLOP per 256-patch batch, so the tensor cores have nothing to do. The
// least traffic is the uint8 NHWC input read once, B*H*W*3 bytes, and the
// output written once, B*OH*OW*3 * (4 for f32 | 2 for bf16) bytes. At B=256,
// 350 -> 224 that is 94.1 MB in + 154.1 MB out (f32) or 77.1 MB out (bf16):
// about 74 us (f32) or 51 us (bf16) at an H100 SXM's 3.35 TB/s.
//
// Design, for the card rather than the TPU's (image, channel) planes:
// * One CTA per (image, tile of output rows). It stages the input rows its
//   tile needs, all three channels, as uint8 in shared memory (one
//   contiguous span of NHWC, copied with 16-byte loads), runs the horizontal
//   pass into a uint8 shared buffer (exact: the values are rounded integers),
//   then the vertical pass, and writes NHWC directly in the compute dtype.
//   Only the input and the output touch device memory.
// * No matrices: each output index has a (start, ntaps, f32 weights) band
//   built on the host from PIL's coefficients, and is a loop over its taps.
// * The loop multiplies and adds with __fmul_rn / __fadd_rn in tap order, and
//   the affine likewise, so no FMA contraction happens: the result is bit for
//   bit that of the plain torch version (fused_preprocess_reference), which
//   does the same operations in the same order. The TPU kernel's matmul sums
//   in another order, so against it a rounding tie can flip one uint8 level.
// * No transposes (the TPU kernel's exist for Mosaic): an NHWC output is
//   already a channels_last NCHW tensor after permute(0, 3, 1, 2).
// * bf16 output via __float2bfloat16_rn, as torch's .to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

struct Band {
  const int* start;  // (n_out,) first input index of each output
  const int* ntaps;  // (n_out,) number of taps of each output
  const float* w;    // (n_out, max_taps) weights, zero-padded
  int max_taps;
};

struct Affine {
  float scale[3];
  float shift[3];
};

__device__ __forceinline__ float round_clip(float y) {
  return fminf(fmaxf(floorf(__fadd_rn(y, 0.5f)), 0.0f), 255.0f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) fused_preprocess_kernel(
    const uint8_t* __restrict__ x, OutT* __restrict__ out, int H, int W, int OH,
    int OW, int tile_rows, int max_in_rows, Band hb, Band vb, Affine aff) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_lo, s_hi;
  __shared__ float s_aff[6];

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile_rows;
  const int r1 = min(r0 + tile_rows, OH);  // exclusive
  if (threadIdx.x == 0) {
    int lo = INT_MAX, hi = 0;
    for (int r = r0; r < r1; ++r) {
      lo = min(lo, vb.start[r]);
      hi = max(hi, vb.start[r] + vb.ntaps[r]);
    }
    s_lo = lo;
    s_hi = max(hi, lo);  // the host sized max_in_rows >= hi - lo
  }
  if (threadIdx.x < 3) {
    s_aff[threadIdx.x] = aff.scale[threadIdx.x];
    s_aff[3 + threadIdx.x] = aff.shift[threadIdx.x];
  }
  __syncthreads();
  const int lo = s_lo;
  const int n_rows = s_hi - s_lo;

  // Stage input rows [lo, lo + n_rows): one contiguous span of NHWC bytes.
  // Bytes before the first 16-byte boundary and after the last go one by
  // one; the rest as uint4. s_in is offset so that both sides are aligned.
  const int row_bytes = W * 3;
  const int span = n_rows * row_bytes;
  const uint8_t* src = x + ((size_t)b * H + lo) * row_bytes;
  const int head = min((int)((16 - ((uintptr_t)src & 15)) & 15), span);
  uint8_t* s_in = smem + ((16 - head) & 15);
  const int nvec = (span - head) / 16;
  for (int i = threadIdx.x; i < head; i += kThreads) s_in[i] = src[i];
  {
    const uint4* src4 = reinterpret_cast<const uint4*>(src + head);
    uint4* dst4 = reinterpret_cast<uint4*>(s_in + head);
    for (int i = threadIdx.x; i < nvec; i += kThreads) dst4[i] = src4[i];
  }
  for (int i = head + nvec * 16 + threadIdx.x; i < span; i += kThreads) s_in[i] = src[i];
  __syncthreads();

  // Horizontal pass: every staged row, every (output column, channel).
  uint8_t* s_h = smem + 16 + (size_t)max_in_rows * row_bytes;
  const int hrow = OW * 3;
  const int n_h = n_rows * hrow;
  for (int i = threadIdx.x; i < n_h; i += kThreads) {
    const int r = i / hrow;
    const int j = i - r * hrow;
    const int o = j / 3;
    const int c = j - o * 3;
    const int nt = hb.ntaps[o];
    const float* w = hb.w + (size_t)o * hb.max_taps;
    const uint8_t* px = s_in + r * row_bytes + hb.start[o] * 3 + c;
    float acc = 0.0f;
    for (int t = 0; t < nt; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], (float)px[3 * t]));
    s_h[i] = (uint8_t)round_clip(acc);
  }
  __syncthreads();

  // Vertical pass + affine, written NHWC in the output dtype.
  const int n_out = (r1 - r0) * hrow;
  OutT* dst = out + ((size_t)b * OH + r0) * hrow;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const int rr = i / hrow;
    const int j = i - rr * hrow;
    const int c = j % 3;
    const int r = r0 + rr;
    const int nt = vb.ntaps[r];
    const float* w = vb.w + (size_t)r * vb.max_taps;
    const uint8_t* px = s_h + (vb.start[r] - lo) * hrow + j;
    float acc = 0.0f;
    for (int t = 0; t < nt; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], (float)px[t * hrow]));
    store(dst + i, __fadd_rn(__fmul_rn(round_clip(acc), s_aff[c]), s_aff[3 + c]));
  }
}

template <typename OutT>
int launch(const uint8_t* x, void* out, int B, int H, int W, int OH, int OW, Band hb,
           Band vb, Affine aff, int tile_rows, int max_in_rows, cudaStream_t stream) {
  const size_t smem = 16 + (size_t)max_in_rows * (size_t)(W * 3 + OW * 3);
  auto kernel = fused_preprocess_kernel<OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((OH + tile_rows - 1) / tile_rows, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, static_cast<OutT*>(out), H, W, OH, OW,
                                           tile_rows, max_in_rows, hb, vb, aff);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, called through ctypes. Pointers are device pointers
// except `affine` (host, 6 floats: scale[3] then shift[3]); `stream` is the
// caller's cudaStream_t. Returns the launch's cudaError_t (0 on success).
extern "C" int wsi_fused_preprocess(const void* x, void* out, int out_bf16, int B, int H,
                                    int W, int OH, int OW, const void* h_start,
                                    const void* h_ntaps, const void* h_w, int h_max_taps,
                                    const void* v_start, const void* v_ntaps,
                                    const void* v_w, int v_max_taps, const float* affine,
                                    int tile_rows, int max_in_rows, void* stream) {
  const Band hb{static_cast<const int*>(h_start), static_cast<const int*>(h_ntaps),
                static_cast<const float*>(h_w), h_max_taps};
  const Band vb{static_cast<const int*>(v_start), static_cast<const int*>(v_ntaps),
                static_cast<const float*>(v_w), v_max_taps};
  Affine aff;
  std::memcpy(aff.scale, affine, 3 * sizeof(float));
  std::memcpy(aff.shift, affine + 3, 3 * sizeof(float));
  const auto* xin = static_cast<const uint8_t*>(x);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch<__nv_bfloat16>(xin, out, B, H, W, OH, OW, hb, vb, aff, tile_rows,
                                 max_in_rows, s);
  return launch<float>(xin, out, B, H, W, OH, OW, hb, vb, aff, tile_rows, max_in_rows, s);
}

extern "C" const char* wsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
