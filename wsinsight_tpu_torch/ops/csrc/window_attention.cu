// K2 on Hopper: fused multi-head window attention with SAM's decomposed
// relative positions.
//
// Replaces the TPU kernel built by `_make_kernel` in
// wsinsight_tpu/ops/flash_attn.py:87 and launched at :195 by
// `window_attention`. Same contract (see ops/flash_attn.py in this package):
// over a (B, HP, WP, 3*dim) qkv grid laid out [q | k | v], each split into
// heads, and for every (image, window, head):
//   S   = (q*scale) k^T            q*scale rounded to the input dtype,
//                                  products summed in f32;
//   S  += rel_h[kh] + rel_w[kw]    optional; rel_h[kh] = q . Rh[qh, kh] with q
//                                  unscaled, rounded to the input dtype;
//   P   = softmax(S) in f32, rounded to the input dtype;
//   out = P v, summed in f32, written (B, HP, WP, dim) in the input dtype.
// Windowed when `ah x aw` tiles the grid, global when it is the whole grid.
// The pad tokens of a padded window hold the qkv bias and take part, as in
// SAM; only the ragged edge of the last query and key tile is masked.
//
// Bound, at CellViT-SAM-H's shapes (dim 1280, 16 heads, hd 80) and B=32.
// Bytes: qkv read once and the output written once. Windowed blocks (16x16
// grid padded to 28x28, 4 windows of n=196): 192.7 MB + 64.2 MB in bf16, about
// 77 us at an H100 SXM's 3.35 TB/s (154 us in f32). Operations: 4*n^2*hd per
// (window, head) for QK^T and PV plus 2*n*(ah+aw)*hd for rel-pos, about
// 27 GFLOP: 27 us at the bf16 tensor-core peak of 989 TFLOP/s, 403 us at the
// 67 TFLOP/s of f32 FMAs. So bf16 is bytes-bound against the tensor cores,
// f32 is bound by operations. This first kernel runs every product as an f32
// FMA on upcast values (a bf16 x bf16 product is exact in f32, so this equals
// a tensor-core product up to summation order); its own ceiling is therefore
// the f32 one in both dtypes. wgmma, TMA and warp specialisation are later
// work.
//
// Design, for the card rather than the TPU's one-(image, window, head)-per-step
// grid with its lane-padded head transposes:
// * One CTA per (image x window, head, tile of 64 query rows); two threads per
//   query row, each holding half of the head's dims (interleaved 4-element
//   chunks, so the two threads of a row read neighbouring 16-byte words of a
//   shared-memory row: conflict-free). A dot product is two partial sums and
//   one __shfl_xor.
// * Direct reads: the CTA computes its window's token offsets from blockIdx
//   and reads q, k and v straight out of the qkv grid, and writes its output
//   rows straight into the (B, HP, WP, dim) result. No partition, head or
//   padding transposes in device memory.
// * Online softmax over key tiles of 64, each staged in shared memory as f32
//   (K and V, zero past the ragged edge), scored 16 keys at a time in
//   registers; so n is unbounded (a global block at 1024 px, n=4096, runs the
//   same loop).
// * Rel-pos: each row's rel_h[kh] and rel_w[kw] are computed once, rounded to
//   the input dtype and kept in shared memory (row stride odd, so rows fall in
//   different banks); each score adds rel_h[kh(k)] + rel_w[kw(k)] in registers,
//   in the plain version's order, with each staged key's (kh, kw) computed
//   once per tile. The TPU kernel's masked cross-product constants existed
//   for the MXU and are not needed.
// * Every dot product runs as four independent FMA chains (one per lane of a
//   4-element chunk), so a warp is not stalled on one chain's latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kTile = 64;            // query rows per CTA; keys per staged tile
constexpr int kThreads = 2 * kTile;  // two threads per query row
constexpr int kChunk = 16;           // keys scored per online-softmax step
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 x;
  *reinterpret_cast<__nv_bfloat162*>(&x.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&x.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = x;
}

// Round an f32 value to the input dtype and back.
__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Geometry {
  int HP, WP, dim, ah, aw, gw, nw;
};

template <typename T, int HD, bool REL>
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                            const T* __restrict__ rh, const T* __restrict__ rw, Geometry g,
                            float scale) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr int kHalf = HD / 2;    // dims held by each of a row's two threads
  constexpr int kVecs = kHalf / 4; // 4-element chunks per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // [kTile][HD]
  float* vs = ks + kTile * HD;   // [kTile][HD]
  float* rel = vs + kTile * HD;  // [kTile][rs]: rel_h (ah) then rel_w (aw)
  __shared__ int2 kpos[kTile];   // staged key j's (kh, ah + kw)

  const int n = g.ah * g.aw;
  const int rs = (g.ah + g.aw) | 1;
  const int b = blockIdx.x / g.nw;
  const int w = blockIdx.x - b * g.nw;
  const int wy = w / g.gw;
  const int wx = w - wy * g.gw;
  const int head = blockIdx.y;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int qi = blockIdx.z * kTile + row;
  const bool valid_q = qi < n;
  const int qic = valid_q ? qi : 0;  // rows past the edge compute on token 0

  // Offset of window token i's grid position, in tokens.
  auto token = [&](int i) -> size_t {
    const int ih = i / g.aw;
    const int iw = i - ih * g.aw;
    return ((size_t)b * g.HP + (size_t)(wy * g.ah + ih)) * g.WP + (size_t)(wx * g.aw + iw);
  };
  const size_t c3 = 3 * (size_t)g.dim;
  const T* base = qkv + (size_t)head * HD;

  // This thread's dims: chunk v covers dims 8*v + 4*half .. + 3.
  float q[kHalf];
  {
    const T* qp = base + token(qic) * c3 + 4 * half;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) load4(qp + 8 * v, q + 4 * v);
  }

  float* my_rel = rel + row * rs;
  if constexpr (REL) {
    const int qh = qic / g.aw;
    const int qw = qic - qh * g.aw;
    for (int t = 0; t < g.ah + g.aw; ++t) {
      const T* r = t < g.ah ? rh + ((size_t)qh * g.ah + t) * HD
                            : rw + ((size_t)qw * g.aw + (t - g.ah)) * HD;
      r += 4 * half;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        float x[4];
        load4(r + 8 * v, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[e] = fmaf(q[4 * v + e], x[e], part[e]);
      }
      float acc = (part[0] + part[1]) + (part[2] + part[3]);
      acc += __shfl_xor_sync(kFull, acc, 1);
      if (half == 0) my_rel[t] = rnd(acc, T());
    }
  }
#pragma unroll
  for (int c = 0; c < kHalf; ++c) q[c] = rnd(__fmul_rn(q[c], scale), T());

  float o[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) o[c] = 0.0f;
  float m = -INFINITY;
  float l = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    const int kn = min(kTile, n - k0);
    __syncthreads();  // the previous tile is consumed (and my_rel is written)
    for (int idx = threadIdx.x; idx < kTile * (HD / 4); idx += kThreads) {
      const int r = idx / (HD / 4);
      const int c = (idx - r * (HD / 4)) * 4;
      float kx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float vx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r < kn) {
        const T* p = base + token(k0 + r) * c3 + c;
        load4(p + g.dim, kx);
        load4(p + 2 * g.dim, vx);
      }
      *reinterpret_cast<float4*>(ks + r * HD + c) = make_float4(kx[0], kx[1], kx[2], kx[3]);
      *reinterpret_cast<float4*>(vs + r * HD + c) = make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    if (REL && threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      const int kh = kj / g.aw;
      kpos[threadIdx.x] = make_int2(kh, g.ah + kj - kh * g.aw);
    }
    __syncthreads();

    for (int c0 = 0; c0 < kn; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        // Four partial sums: independent FMA chains keep the pipes busy.
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
        if (j < kn) {  // uniform across the CTA
          const float* kr = ks + j * HD + 4 * half;
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            const float4 x = *reinterpret_cast<const float4*>(kr + 8 * v);
            p0 = fmaf(q[4 * v], x.x, p0);
            p1 = fmaf(q[4 * v + 1], x.y, p1);
            p2 = fmaf(q[4 * v + 2], x.z, p2);
            p3 = fmaf(q[4 * v + 3], x.w, p3);
          }
        }
        float acc = (p0 + p1) + (p2 + p3);
        acc += __shfl_xor_sync(kFull, acc, 1);
        if (j < kn) {
          if constexpr (REL) {
            const int2 kp = kpos[j];
            acc = (acc + my_rel[kp.x]) + my_rel[kp.y];
          }
          s[jj] = acc;
          cmax = fmaxf(cmax, acc);
        } else {
          s[jj] = -INFINITY;
        }
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) o[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        if (c0 + jj < kn) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float pr = rnd(p, T());
          const float* vr = vs + (c0 + jj) * HD + 4 * half;
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            const float4 x = *reinterpret_cast<const float4*>(vr + 8 * v);
            o[4 * v] = fmaf(pr, x.x, o[4 * v]);
            o[4 * v + 1] = fmaf(pr, x.y, o[4 * v + 1]);
            o[4 * v + 2] = fmaf(pr, x.z, o[4 * v + 2]);
            o[4 * v + 3] = fmaf(pr, x.w, o[4 * v + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (valid_q) {
    T* op = out + token(qi) * (size_t)g.dim + (size_t)head * HD + 4 * half;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = __fdiv_rn(o[4 * v + e], l);
      store4(op + 8 * v, x);
    }
  }
}

template <typename T, int HD, bool REL>
int launch(const void* qkv, void* out, const void* rh, const void* rw, int B, int heads,
           Geometry g, int gh, float scale, cudaStream_t stream) {
  const int n = g.ah * g.aw;
  const size_t smem = 2 * (size_t)kTile * HD * sizeof(float) +
                      (REL ? (size_t)kTile * ((g.ah + g.aw) | 1) * sizeof(float) : 0);
  auto kernel = window_attention_kernel<T, HD, REL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)B * gh * g.gw, heads, (n + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<const T*>(rh),
      static_cast<const T*>(rw), g, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool REL>
int dispatch_hd(int hd, const void* qkv, void* out, const void* rh, const void* rw, int B,
                int heads, Geometry g, int gh, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    case 64: return launch<T, 64, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    case 80: return launch<T, 80, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    case 128: return launch<T, 128, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, called through ctypes. Pointers are device pointers
// (rh and rw null without rel-pos); `stream` is the caller's cudaStream_t;
// `scale` is already rounded to the input dtype. Returns the launch's
// cudaError_t (0 on success).
extern "C" int wsi_window_attention(const void* qkv, void* out, const void* rh,
                                    const void* rw, int bf16, int hd, int B, int HP, int WP,
                                    int dim, int heads, int ah, int aw, int gh, int gw,
                                    float scale, void* stream) {
  const Geometry g{HP, WP, dim, ah, aw, gw, gh * gw};
  auto s = static_cast<cudaStream_t>(stream);
  const bool rel = rh != nullptr;
  if (bf16) {
    return rel ? dispatch_hd<__nv_bfloat16, true>(hd, qkv, out, rh, rw, B, heads, g, gh, scale, s)
               : dispatch_hd<__nv_bfloat16, false>(hd, qkv, out, rh, rw, B, heads, g, gh, scale, s);
  }
  return rel ? dispatch_hd<float, true>(hd, qkv, out, rh, rw, B, heads, g, gh, scale, s)
             : dispatch_hd<float, false>(hd, qkv, out, rh, rw, B, heads, g, gh, scale, s);
}

extern "C" const char* wsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
