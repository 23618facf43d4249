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
// Bound: memory, with instruction count close behind. The least traffic is the uint8
// NHWC input read once, B*H*W*3 bytes, and the output written once,
// B*OH*OW*3 * (4 for f32 | 2 for bf16) bytes. At B=256, 350 -> 224 that is
// 94.1 MB in + 154.1 MB out (f32) or 77.1 MB out (bf16): about 74 us (f32)
// or 51 us (bf16) at an H100 SXM's 3.35 TB/s. The arithmetic is about 3
// taps per output per pass, 2 FLOP each, well under 1 GFLOP per batch, but
// every tap also turns a byte into a float, so instructions, not FLOP, are
// what it costs: the design keeps them few.
//
// Design:
// * One CTA per (band of output rows, image); it walks down its band. The
//   input rows the band needs arrive in chunks of `chunk_rows`, double
//   buffered with 16-byte cp.async.cg, so the next chunk is in flight while
//   the current one computes. An image's rows start at any byte address
//   (350*350*3 = 367,500), so a chunk is copied as the 16-byte blocks that
//   cover it; blocks that stick out of the image's bytes go byte by byte.
// * Horizontal pass: each thread owns one output column, all three channels.
//   Its band (tap offsets and f32 weights, zero-padded to the template's
//   TAPS) is loaded into registers once per CTA and the tap loop is fully
//   unrolled. Threads take the columns in order of tap count (`h_cols`), so
//   a warp's columns mostly have the same count and the warp runs only the
//   taps one of them has (350 -> 224: 3 of 4 in six warps of seven); padded
//   taps that do run read the column the plain version clamps to and add an
//   exact +0. Results go, as uint8 (exact: rounded integers), into a ring of
//   `ring_rows` rows in shared memory, each input row computed once per band.
// * Vertical pass: after each chunk, the band's output rows whose taps are all
//   in the ring are written. A thread takes 4 adjacent elements of an output
//   row (one 32-bit shared load per tap, padded taps skipped), the row's band
//   comes from a shared table (broadcast), and the 4 results go out as one
//   float4 (f32) or one 8-byte store (bf16).
// * No type conversion instructions (they run at an eighth of FADD's rate):
//   bytes become floats, floor() and the uint8 store go through exact float
//   bit tricks (see kMagic). No integer division in the loops; the
//   band/ring/chunk plan is made on the host (fused_preprocess.py `_plan`),
//   which also sizes shared memory.
// * TAPS = 0 is the run-time-tap instantiation for bands wider than 16 taps
//   or outputs wider than 1024 columns: weights are read per tap and a thread
//   walks several columns.
// * Arithmetic: __fmul_rn / __fadd_rn in tap order, and the affine likewise,
//   so no FMA contraction happens: the result is bit for bit that of the
//   plain torch version (fused_preprocess_reference), which does the same
//   operations in the same order. The TPU kernel's matmul sums in another
//   order, so against it a rounding tie can flip one uint8 level.
// * bf16 output via __float2bfloat16_rn, as torch's .to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

struct Band {
  const int* start;  // (n_out,) first input index of each output
  const int* ntaps;  // (n_out,) number of taps of each output (vertical band)
  const float* w;    // (n_out, max_taps) weights, zero-padded
  int max_taps;
};

struct Affine {
  float scale[3];
  float shift[3];
};

struct Plan {
  int band_rows;   // output rows per CTA
  int chunk_rows;  // input rows per staged chunk
  int ring_rows;   // horizontal-pass rows kept, a power of two
};

// Shared memory, in this order: two input chunks, the ring, the band's
// vertical table (start, last row, weights). fused_preprocess.py `_plan`
// computes the same total.
__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int chunk_slot(int chunk_rows, int W) {
  return align16(chunk_rows * W * 3) + 32;
}
__host__ __device__ inline int ring_stride(int OW) { return align16(OW * 3); }
inline size_t smem_bytes(const Plan& p, int W, int OW, int vtaps) {
  return 2 * (size_t)chunk_slot(p.chunk_rows, W) + (size_t)p.ring_rows * ring_stride(OW) +
         (size_t)p.band_rows * (2 + vtaps) * 4;
}

// Conversions (I2F, F2I, FRND) run at an eighth of FADD's rate on Hopper,
// so bytes and floats meet through kMagic = 1.5 * 2^23, whose float has 22
// zero low bits and an ulp of 1: for an integer 0 <= v < 2^22 the float with
// bits 0x4B400000 | v is exactly kMagic + v, and for |t| < 2^22 the sum
// t + kMagic rounded down is exactly kMagic + floor(t).
constexpr float kMagic = 12582912.0f;

__device__ __forceinline__ float byte_to_float(uint32_t v) {  // v in [0, 255]
  return __fsub_rn(__uint_as_float(0x4B400000u | v), kMagic);
}

// Byte I of q as a float, by one byte permute: [q.byte_I, 0x00, 0x40, 0x4B].
template <int I>
__device__ __forceinline__ float byte_of(uint32_t q) {
  return __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B400000u, 0x7640 | I)), kMagic);
}

// kMagic + floor(y + 0.5): floorf's result, shifted so that its low byte is
// the uint8 PIL stores. The clip to [0, 255] that follows in the contract
// never acts here: every tap's weight is >= 0 and each output's weights sum
// to at most 1.001 (fused_preprocess.py `_plan` checks both), so for uint8
// inputs 0 <= y < 255.5.
__device__ __forceinline__ float round_shifted(float y) {
  return __fadd_rd(__fadd_rn(y, 0.5f), kMagic);
}

__device__ __forceinline__ uint8_t round_byte(float y) {
  return (uint8_t)__float_as_uint(round_shifted(y));
}

__device__ __forceinline__ float round_value(float y) {
  return __fsub_rn(round_shifted(y), kMagic);
}

__device__ __forceinline__ float tap(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy bytes [a, a + n) into dst + (a & 15), as the 16-byte blocks that cover
// them: cp.async where a block lies inside [lo, hi) (the image's bytes),
// byte by byte, and only the bytes of [a, a + n), where it does not.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* a, int n, const uint8_t* lo,
                                      const uint8_t* hi) {
  const uint8_t* g0 = reinterpret_cast<const uint8_t*>((uintptr_t)a & ~(uintptr_t)15);
  const int nblk = (int)((a + n - g0 + 15) >> 4);
  for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
    const uint8_t* blk = g0 + 16 * i;
    if (blk >= lo && blk + 16 <= hi) {
      cp_async16(dst + 16 * i, blk);
    } else {
      for (int k = 0; k < 16; ++k)
        if (blk + k >= a && blk + k < a + n) dst[16 * i + k] = blk[k];
    }
  }
}

__device__ __forceinline__ void store4(float* p, const float (&z)[4], int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(z[0], z[1], z[2], z[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = z[i];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&z)[4], int n, bool vec) {
  if (vec) {
    __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(z[0]), __float2bfloat16_rn(z[1]));
    __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(z[2]), __float2bfloat16_rn(z[3]));
    uint2 v;
    std::memcpy(&v.x, &lo, 4);
    std::memcpy(&v.y, &hi, 4);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = __float2bfloat16_rn(z[i]);
  }
}

// Horizontal pass of `nk` staged rows (`src`, `row_bytes` apart) into ring
// rows first, first + 1, ... for output column o: TAPS taps from registers.
// `nt` (<= TAPS, the same across the warp) is the most taps any column of
// the warp has; the taps after it have zero weight everywhere and are skipped.
template <int TAPS>
__device__ __forceinline__ void hpass_regs(const uint8_t* src, int row_bytes, int nk, int first,
                                           uint8_t* ring, int ring_mask, int stride, int o, int nt,
                                           const float (&w)[TAPS], const int (&off)[TAPS]) {
  for (int i = 0; i < nk; ++i) {
    const uint8_t* row = src + i * row_bytes;
    // The plain version adds the first product to +0: the same value, as
    // products are >= +0.
    float a0 = __fmul_rn(w[0], byte_to_float(row[off[0]]));
    float a1 = __fmul_rn(w[0], byte_to_float(row[off[0] + 1]));
    float a2 = __fmul_rn(w[0], byte_to_float(row[off[0] + 2]));
#pragma unroll
    for (int t = 1; t < TAPS; ++t) {
      if (t >= nt) break;
      const uint8_t* px = row + off[t];
      a0 = tap(a0, w[t], byte_to_float(px[0]));
      a1 = tap(a1, w[t], byte_to_float(px[1]));
      a2 = tap(a2, w[t], byte_to_float(px[2]));
    }
    uint8_t* d = ring + ((first + i) & ring_mask) * stride + 3 * o;
    d[0] = round_byte(a0);
    d[1] = round_byte(a1);
    d[2] = round_byte(a2);
  }
}

template <int TAPS, typename OutT>
__global__ void __maxnreg__(40) fused_preprocess_kernel(
    const uint8_t* __restrict__ x, OutT* __restrict__ out, int H, int W, int OH, int OW, Band hb,
    const int* __restrict__ h_cols, Band vb, Affine aff, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  // [0: scale | 1: shift][u % 3][i]: element 4u + i of a row has channel (u + i) % 3.
  __shared__ __align__(16) float s_aff[2][3][4];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * p.band_rows;
  const int nr = min(p.band_rows, OH - r0);
  const int row_bytes = W * 3, hrow = OW * 3;
  const int slot = chunk_slot(p.chunk_rows, W);
  const int stride = ring_stride(OW);
  const int ring_mask = p.ring_rows - 1;
  const int vt = TAPS ? TAPS : vb.max_taps;
  uint8_t* s_in = smem;
  uint8_t* s_ring = smem + 2 * slot;
  int* s_vs = reinterpret_cast<int*>(s_ring + p.ring_rows * stride);
  int* s_vl = s_vs + p.band_rows;
  float* s_vw = reinterpret_cast<float*>(s_vl + p.band_rows);

  // The band's input rows [lo, hi): bands are monotonic (checked by _plan).
  const int lo = vb.start[r0];
  const int hi = vb.start[r0 + nr - 1] + max(vb.ntaps[r0 + nr - 1], 1);
  const int n_in = hi - lo;
  const int C = p.chunk_rows;
  const int n_chunks = (n_in + C - 1) / C;
  const uint8_t* img = x + (size_t)b * H * row_bytes;
  const uint8_t* img_end = img + (size_t)H * row_bytes;
  const uint8_t* src0 = img + (size_t)lo * row_bytes;
  stage(s_in, src0, min(C, n_in) * row_bytes, img, img_end);
  cp_async_commit();

  // While chunk 0 is in flight: the vertical table, the affine, the taps.
  for (int i = tid; i < nr; i += nthr) {
    s_vs[i] = vb.start[r0 + i];
    s_vl[i] = vb.start[r0 + i] + max(vb.ntaps[r0 + i], 1) - 1;
  }
  for (int i = tid; i < nr * vt; i += nthr) {
    const int r = i / vt, t = i - r * vt;
    s_vw[i] = t < vb.max_taps ? vb.w[(size_t)(r0 + r) * vb.max_taps + t] : 0.0f;
  }
  if (tid < 12) {
    const int c0 = tid >> 2, i = tid & 3, c = (c0 + i) % 3;
    s_aff[0][c0][i] = aff.scale[c];
    s_aff[1][c0][i] = aff.shift[c];
  }
  constexpr int kRegTaps = TAPS ? TAPS : 1;
  float hw[kRegTaps];
  int hoff[kRegTaps];
  int col = 0, hnt = 0;  // this thread's output column; the warp's most taps
  if constexpr (TAPS > 0) {
    col = h_cols[min(tid, OW - 1)];
    const int st = hb.start[col];
    int nt = 0;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      hw[t] = t < hb.max_taps ? hb.w[(size_t)col * hb.max_taps + t] : 0.0f;
      hoff[t] = min(st + t, W - 1) * 3;
      if (hw[t] != 0.0f) nt = t + 1;
    }
    hnt = __reduce_max_sync(0xffffffffu, tid < OW ? nt : 0);
  }

  // The vertical pass's walk over (row, 4-element unit): a thread's next
  // item is nthr units on, i.e. drow rows and du units.
  const int units = (hrow + 3) >> 2;
  const int drow = nthr / units, du = nthr - drow * units;
  const int u0 = tid % units, row0 = tid / units;
  const bool vec = (hrow & 3) == 0;
  OutT* out_img = out + ((size_t)b * OH + r0) * hrow;

  int emitted = 0;  // band rows written so far
  for (int k = 0; k < n_chunks; ++k) {
    const int buf = k & 1;
    const int first = lo + k * C;
    const int nk = min(C, n_in - k * C);
    if (k + 1 < n_chunks) {
      const uint8_t* a = src0 + (size_t)(k + 1) * C * row_bytes;
      stage(s_in + (buf ^ 1) * slot, a, min(C, n_in - (k + 1) * C) * row_bytes, img, img_end);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    // Horizontal pass of input rows [first, first + nk).
    const uint8_t* src = s_in + buf * slot + ((uintptr_t)(src0 + (size_t)k * C * row_bytes) & 15);
    if constexpr (TAPS > 0) {
      if (tid < OW)
        hpass_regs<TAPS>(src, row_bytes, nk, first, s_ring, ring_mask, stride, col, hnt, hw,
                         hoff);
    } else {
      for (int o = tid; o < OW; o += nthr) {
        const int st = hb.start[o];
        const float* w = hb.w + (size_t)o * hb.max_taps;
        for (int i = 0; i < nk; ++i) {
          const uint8_t* row = src + i * row_bytes;
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
          for (int t = 0; t < hb.max_taps; ++t) {
            const uint8_t* px = row + min(st + t, W - 1) * 3;
            a0 = tap(a0, w[t], byte_to_float(px[0]));
            a1 = tap(a1, w[t], byte_to_float(px[1]));
            a2 = tap(a2, w[t], byte_to_float(px[2]));
          }
          uint8_t* d = s_ring + ((first + i) & ring_mask) * stride + 3 * o;
          d[0] = round_byte(a0);
          d[1] = round_byte(a1);
          d[2] = round_byte(a2);
        }
      }
    }
    __syncthreads();

    // Vertical pass of the band rows whose taps are all in the ring now.
    const int prod = first + nk;
    int end = emitted;
    while (end < nr && s_vl[end] < prod) ++end;
    int row = emitted + row0, u = u0;
    while (row < end) {
      const int vs = s_vs[row], vl = s_vl[row];
      const float* vw = s_vw + row * vt;
      const uint32_t q0 =
          *reinterpret_cast<const uint32_t*>(s_ring + (vs & ring_mask) * stride + 4 * u);
      float a[4] = {__fmul_rn(vw[0], byte_of<0>(q0)), __fmul_rn(vw[0], byte_of<1>(q0)),
                    __fmul_rn(vw[0], byte_of<2>(q0)), __fmul_rn(vw[0], byte_of<3>(q0))};
#pragma unroll
      for (int t = 1; t < (TAPS ? TAPS : vt); ++t) {
        if (vs + t > vl) break;  // padded taps would add +0
        const uint32_t q =
            *reinterpret_cast<const uint32_t*>(s_ring + ((vs + t) & ring_mask) * stride + 4 * u);
        const float wt = vw[t];
        a[0] = tap(a[0], wt, byte_of<0>(q));
        a[1] = tap(a[1], wt, byte_of<1>(q));
        a[2] = tap(a[2], wt, byte_of<2>(q));
        a[3] = tap(a[3], wt, byte_of<3>(q));
      }
      const int c0 = u % 3;
      const float4 sc = *reinterpret_cast<const float4*>(s_aff[0][c0]);
      const float4 sh = *reinterpret_cast<const float4*>(s_aff[1][c0]);
      const float z[4] = {__fadd_rn(__fmul_rn(round_value(a[0]), sc.x), sh.x),
                          __fadd_rn(__fmul_rn(round_value(a[1]), sc.y), sh.y),
                          __fadd_rn(__fmul_rn(round_value(a[2]), sc.z), sh.z),
                          __fadd_rn(__fmul_rn(round_value(a[3]), sc.w), sh.w)};
      store4(out_img + (size_t)row * hrow + 4 * u, z, hrow - 4 * u, vec);
      row += drow;
      u += du;
      if (u >= units) {
        u -= units;
        ++row;
      }
    }
    emitted = end;
  }
}

// cudaFuncSetAttribute once per instantiation and device (the attribute is
// per device): allow the device's whole opt-in shared memory (occupancy
// follows each launch's own size). Engines launch from one thread per card,
// so the table is guarded.
constexpr int kMaxDevices = 64;

template <int TAPS, typename OutT>
cudaError_t opt_in() {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  static cudaError_t result[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fused_preprocess_kernel<TAPS, OutT>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_preprocess_kernel<TAPS, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - (int)attr.sharedSizeBytes);
    result[dev] = e;
    done[dev] = true;
  }
  return result[dev];
}

template <int TAPS, typename OutT>
int launch(const uint8_t* x, void* out, int B, int H, int W, int OH, int OW, Band hb,
           const int* h_cols, Band vb, Affine aff, Plan p, int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, W, OW, TAPS ? TAPS : vb.max_taps);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in<TAPS, OutT>();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((OH + p.band_rows - 1) / p.band_rows, B);
  fused_preprocess_kernel<TAPS, OutT><<<grid, threads, smem, stream>>>(
      x, static_cast<OutT*>(out), H, W, OH, OW, hb, h_cols, vb, aff, p);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_taps(int taps, const uint8_t* x, void* out, int B, int H, int W, int OH, int OW,
                Band hb, const int* h_cols, Band vb, Affine aff, Plan p, int threads,
                cudaStream_t s) {
  switch (taps) {
    case 1: return launch<1, OutT>(x, out, B, H, W, OH, OW, hb, h_cols, vb, aff, p, threads, s);
    case 2: return launch<2, OutT>(x, out, B, H, W, OH, OW, hb, h_cols, vb, aff, p, threads, s);
    case 4: return launch<4, OutT>(x, out, B, H, W, OH, OW, hb, h_cols, vb, aff, p, threads, s);
    case 8: return launch<8, OutT>(x, out, B, H, W, OH, OW, hb, h_cols, vb, aff, p, threads, s);
    case 16: return launch<16, OutT>(x, out, B, H, W, OH, OW, hb, h_cols, vb, aff, p, threads, s);
    case 0: return launch<0, OutT>(x, out, B, H, W, OH, OW, hb, h_cols, vb, aff, p, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, called through ctypes. Pointers are device pointers
// except `affine` (host, 6 floats: scale[3] then shift[3]); `stream` is the
// caller's cudaStream_t. `h_cols` lists the OW output columns in the order
// the CTA's threads take them (by tap count, most first, so that a warp's
// columns have the same count). `taps` (1, 2, 4, 8, 16, or 0 for a run-time
// count), `threads` and the band/chunk/ring rows are fused_preprocess.py
// `_plan`'s. Returns the launch's cudaError_t (0 on success).
extern "C" int wsi_fused_preprocess_bands(
    const void* x, void* out, int out_bf16, int B, int H, int W, int OH, int OW,
    const void* h_start, const void* h_cols, const void* h_w, int h_max_taps,
    const void* v_start, const void* v_ntaps, const void* v_w, int v_max_taps,
    const float* affine, int taps, int threads, int band_rows, int chunk_rows, int ring_rows,
    void* stream) {
  const Band hb{static_cast<const int*>(h_start), nullptr, static_cast<const float*>(h_w),
                h_max_taps};
  const auto* cols = static_cast<const int*>(h_cols);
  const Band vb{static_cast<const int*>(v_start), static_cast<const int*>(v_ntaps),
                static_cast<const float*>(v_w), v_max_taps};
  Affine aff;
  std::memcpy(aff.scale, affine, 3 * sizeof(float));
  std::memcpy(aff.shift, affine + 3, 3 * sizeof(float));
  const Plan p{band_rows, chunk_rows, ring_rows};
  const auto* xin = static_cast<const uint8_t*>(x);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_taps<__nv_bfloat16>(taps, xin, out, B, H, W, OH, OW, hb, cols, vb, aff, p,
                                      threads, s);
  return launch_taps<float>(taps, xin, out, B, H, W, OH, OW, hb, cols, vb, aff, p, threads, s);
}

extern "C" const char* wsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
