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
// Real rows. The model pads its h x w token grid to HP x WP and crops the
// result back to h x w, so the f32 kernel computes only the query rows of
// real tokens: window (wy, wx) has rh = min(ah, h - wy ah) x rw = min(aw,
// w - wx aw) of them (none when either is <= 0), its top-left corner. Local
// row r is window token (r / rw) aw + r % rw. Each output row depends only
// on its own q and on all the keys, pad keys included, so every real row is
// what it would be at full rows; the other rows of `out` are not written.
// The bf16 kernel computes every row. (h, w) = (HP, WP) is the whole grid.
//
// Two kernels behind one entry point, one per input dtype, both on the
// tensor cores with f32 accumulators:
// * float32: `window_attention_kernel_tf32`, QK^T, PV and the rel-pos dot
//   products as 3xTF32 products (mma.sync m16n8k8 tf32): each f32 operand x
//   is split into hi = tf32(x) and lo = tf32(x - hi), both rounded to
//   nearest, and each product is lo*hi + hi*lo + hi*hi, about 22 bits of
//   mantissa. It is held to the f32 bar (2e-5 + 1e-5 |x| against the plain
//   version). Single-pass TF32 (10 bits) stays out: parity runs with TF32
//   off for cuBLAS and cuDNN, and so does this kernel.
// * bfloat16: `window_attention_kernel_mma`, the same products as bf16
//   tensor-core products (mma.sync m16n8k16).
//
// Bound, at CellViT-SAM-H's shapes (dim 1280, 16 heads, hd 80) and B=32.
// Bytes: qkv read once and the output written once. Windowed blocks (16x16
// grid padded to 28x28, 4 windows of n=196): 192.7 MB + 64.2 MB in bf16, about
// 77 us at an H100 SXM's 3.35 TB/s (154 us in f32). Operations: 4*n^2*hd per
// (window, head) for QK^T and PV plus 2*n*(ah+aw)*hd for rel-pos, about
// 27 GFLOP: 27 us at the bf16 tensor-core peak of 989 TFLOP/s. In f32 at the
// real rows (256 of 784 per image): q and the output of real tokens only,
// 341 MB, 102 us; 8.8 GFLOP, three tensor-core products each, 53 us at the
// dense TF32 peak of 494.7 TFLOP/s. So both are bound by bytes.
//
// The bf16 kernel, for the tensor cores. It is bound by bytes, so operands
// stay bf16 end to end, and what costs it time (measured by removing one
// phase at a time, PERF.md) is moving and reshaping data, not products:
// * 8 warps, each owning one m16 tile of 16 query rows: 128 rows per CTA, so
//   a SAM-H window of 196 rows takes two CTAs and its K and V are staged
//   twice, not four times. A warp whose rows all lie past n only helps stage.
//   128 registers a thread (a few bytes spilled at HD 64 and 80) let two
//   CTAs share an SM.
// * CTAs in the order query tile, head, (image, window): the query tiles of
//   one (window, head) run together and share its K and V in L2.
// * q, K and V are staged by cp.async, 16 B per thread, two threads per row
//   (full 32-byte sectors), each row's token offset computed once, without
//   an integer division. K and V tiles are bf16 (half the bytes of f32) and
//   double-buffered with one barrier per tile: the next tile lands while this
//   one is computed. Row stride HD + 8 elements, so the 8 rows of each
//   ldmatrix fall in distinct banks (HD 80: 44 words; rows at words 0, 12,
//   24, 4, ...). q is staged in the second stage, before its first key tile.
// * Rel-pos on the tensor cores: rows that share a table (the CTA's rows of
//   one qh for Rh, of one qw for Rw) form one A tile, gathered by ldmatrix's
//   per-lane row addresses; the table is the B operand. An FMA prologue cost
//   38% of the kernel's time at SAM-H's windowed shape.
// * QK^T: q * scale (rounded to bf16) as A fragments in registers; K's B
//   fragments by ldmatrix.x4; 8 n8 tiles of f32 accumulators per 64-key tile.
//   Full tiles run without per-column guards; the ragged last one skips
//   16-key column pairs past n and masks the rest to -inf.
// * Rel adds on the accumulators: each key's (kw, aw + kh) as byte offsets;
//   with aw even a thread's two columns of an n8 tile share kh, so one 8-byte
//   load gives both rel_w values (row stride 8 mod 32: conflict-free).
// * Softmax on the fragments: row max and sum by quad __shfl_xor; p is one
//   FFMA and one ex2; l sums the unrounded p.
// * PV: two adjacent n8 tiles of P become one bf16 A fragment in registers (no
//   trip through shared memory); V's B fragments by ldmatrix.x4.trans; O is
//   HD/8 n8 tiles of f32 accumulators.
// * Epilogue: O / l rounded to bf16 and stored through the same token map;
//   rows past n are not written.
//
// The f32 kernel is the bf16 kernel's skeleton (m16 rows per warp, K and V
// double-buffered by cp.async, token offsets without division, guard-free
// full tiles, the same rel gathering, rel adds and online softmax). It is
// bound by the ALU work around its products (splitting operands, adding
// partial sums), not by the tensor cores, so:
// * 4 warps (64 query rows) and key tiles of 32 per CTA, q in shared memory:
//   75 KB and at most 168 registers let three CTAs share an SM, so a CTA of
//   a small window (one or two busy warps) does not hold an SM alone. (8
//   warps and 64 keys, one CTA per SM at 255 registers: 873 against 655 us
//   at SAM-H's windowed real rows, B=32, on an H100 SXM at 700 W; PERF.md.)
// * Real rows: its CTAs cover a window's real rows only (four of 64 for
//   SAM-H's 196, one each for its windows of 28 and 4) and one whose tile
//   starts past them exits at once. Rows share an Rh table by qh = r / rw and
//   an Rw table by qw = r % rw of the local row r, so the rel items group by
//   rw.
// * f32 tiles of rows of HD + 4 floats (HD 80: 84 words, rows at words 0,
//   20, 8, 28, ...): each 8x8 b16 ldmatrix is an 8-row x 4-float matrix
//   whose lane (g, t) receives element (g, t), the tf32 A layout for q and
//   the B layout for K and the rel tables, unchanged.
// * Each operand is split where it is used: q * scale per key tile (its hi
//   and lo of HD 80 would hold 80 registers), K and V by each warp.
// * Each k8 step's three products are summed from zero and added to the
//   running f32 sums: the tensor core rounds the sums it accumulates toward
//   zero, and a running sum kept in its accumulators drifted past the f32
//   bar (3.6e-5 against 2e-5 + 1e-5 |x| at n = 4096).
// * P needs no shuffle: within a k8 step of PV, A's column t stands for key
//   2t and column t + 4 for key 2t + 1, so the QK^T accumulators (c0, c1,
//   c2, c3) are (a0, a2, a1, a3), and V's B fragment is V[2t][g] and
//   V[2t + 1][g], read by scalar loads (rows of HD + 4 floats: 2t (HD + 4) +
//   g covers the 32 banks; ldmatrix.trans does not move 32-bit elements).
// * p = expf(s - m), as the plain version's softmax; the output is O / l
//   rounded once.
// wgmma, TMA, clusters (which would let a window's query tiles share one
// copy of K and V) and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Round an f32 value to bf16 and back.
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Geometry {
  int HP, WP, dim, ah, aw, gw, nw;
};

// ---------------------------------------------------------------------------
// The bf16 kernel: tensor-core tiles.

constexpr int kWarps = 8;                 // warps per CTA, one m16 tile of query rows each
constexpr int kRows = 16 * kWarps;        // query rows per CTA
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kKeys = 64;                 // keys per staged tile; two stages (double buffer)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMmaThreads == 2 * kRows && kRows == 2 * kKeys,
              "two threads per query row, and per row of a stage's K rows and V rows");
// CTAs per SM that the registers must allow: 128 registers (at HD 64 and 80
// a few bytes spilled) let two share an SM whose shared memory holds them.
// At HD 128 the accumulators need more.
template <int HD>
constexpr int kMinCtas = HD >= 128 ? 1 : 2;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.x4.trans.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x, 2 ulp; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row stride of the rel values, in floats: at least ah + aw and 8 mod 32, so
// the 8-byte rel_w pairs that 4 rows read at once fall in distinct banks.
__host__ __device__ __forceinline__ int rel_stride(int ah, int aw) {
  return ah + aw + ((8 - (ah + aw)) & 31);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD, bool REL>
__global__ void __launch_bounds__(kMmaThreads, kMinCtas<HD>)
    window_attention_kernel_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                const bf16* __restrict__ rh, const bf16* __restrict__ rw,
                                Geometry g, int heads, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = HD + 8;      // shared-memory row, elements
  constexpr int kHalfChunks = HD / 16; // 16-byte chunks per row, per thread of its pair
  constexpr int kSteps = HD / 16;      // k16 steps of QK^T; pairs of n8 tiles of PV
  constexpr int kStage = 2 * kKeys * kStride;  // one stage: K rows, then V rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kv = reinterpret_cast<bf16*>(smem_raw);          // [2 stages][K, V][kKeys][kStride]
  float* rel = reinterpret_cast<float*>(kv + 2 * kStage);  // [kRows][rs]: rel_w, rel_h
  // Staged key j's rel offsets in bytes, (kw, aw + kh) * 4; (0, aw) * 4 past n.
  __shared__ int2 kpos[2][kKeys];

  const int n = g.ah * g.aw;
  const int rs = rel_stride(g.ah, g.aw);
  // CTA order: query tile fastest, then head, then (image, window), so the
  // query tiles of one (window, head) run together and share its K and V in
  // L2, and neighbouring heads read neighbouring bytes of each token.
  const int n_qt = (n + kRows - 1) / kRows;
  const int qt = blockIdx.x % n_qt;
  const int head = (blockIdx.x / n_qt) % heads;
  const int bw = blockIdx.x / n_qt / heads;
  const int b = bw / g.nw;
  const int w = bw - b * g.nw;
  const int wy = w / g.gw;
  const int wx = w - wy * g.gw;
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;     // accumulator rows gr and gr + 8
  const int tq = lane & 3;      // accumulator columns 2 tq and 2 tq + 1 of each n8 tile
  const int srow = tid >> 1;    // the query or key row this thread stages, with its pair
  const int spart = tid & 1;    // ... its 16-byte chunks 2 j + spart

  // i / aw without an integer division. (i + 0.5) / aw lies at least
  // 1 / (2 aw) from an integer and the product errs by less than
  // (i + 0.5) 2^-23 / aw, so the quotient is exact for i < 2^22 - 1; the
  // wrapper keeps n below 2^21.
  const float inv_aw = 1.0f / (float)g.aw;
  auto split = [&](int i) -> int2 {
    const int ih = __float2int_rz(((float)i + 0.5f) * inv_aw);
    return make_int2(ih, i - ih * g.aw);
  };
  auto token = [&](int i) -> size_t {
    const int2 hw = split(i);
    return ((size_t)b * g.HP + (size_t)(wy * g.ah + hw.x)) * g.WP + (size_t)(wx * g.aw + hw.y);
  };
  const size_t c3 = 3 * (size_t)g.dim;
  const bf16* base = qkv + (size_t)head * HD + 8 * spart;

  // Stage key tile [k0, k0 + 64) into stage s by cp.async: this thread's
  // half of stage row srow, a row of K (srow < 64) or of V (zero past the
  // ragged edge), and the key's rel offsets.
  auto stage_kv = [&](int k0, int s) {
    const int key = k0 + srow % kKeys;
    const bool live = key < n;
    const bf16* src = base + token(live ? key : 0) * c3 + (size_t)(1 + srow / kKeys) * g.dim;
    bf16* dst = kv + s * kStage + srow * kStride + 8 * spart;
#pragma unroll
    for (int j = 0; j < kHalfChunks; ++j) cp_async16(smem_addr(dst + 16 * j), src + 16 * j, live);
    if (REL && spart == 0 && srow < kKeys) {
      const int2 hw = split(live ? key : 0);
      kpos[s][srow] = make_int2(4 * hw.y, 4 * (g.aw + hw.x));
    }
    cp_async_commit();
  };

  // q, unscaled, into the second stage's rows (zero past n); key tile 0
  // meanwhile.
  bf16* qs = kv + kStage;
  {
    const int qi = q0 + srow;
    const bf16* src = base + token(qi < n ? qi : 0) * c3;
    bf16* dst = qs + srow * kStride + 8 * spart;
#pragma unroll
    for (int j = 0; j < kHalfChunks; ++j) cp_async16(smem_addr(dst + 16 * j), src + 16 * j, qi < n);
    cp_async_commit();
  }
  stage_kv(0, 0);
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  // ldmatrix of A tiles, matrices (rows 0-7 | 8-15) x (dims 0-7 | 8-15) of a
  // k16 step: lane l gives the address of row a_row, column a_col.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;

  if constexpr (REL) {
    // Rel-pos on the tensor cores: rel_w[r][t] = q[r] . Rw[qw(r)][t] and
    // rel_h[r][t] = q[r] . Rh[qh(r)][t], q unscaled, summed in f32, rounded to
    // bf16, stored as f32 (row r: rel_w at 0, rel_h at aw). Rows that share a
    // table form one A tile, gathered through ldmatrix's per-lane row
    // addresses: the CTA's rows of one qh (consecutive) for rel_h, of one qw
    // (at stride aw) for rel_w. B is the table (row-major, like K), its
    // fragments read from global memory. `rows` are the CTA rows of
    // accumulator rows gr and gr + 8, or -1.
    auto rel_tile = [&](const uint32_t (&a)[kSteps][4], const bf16* table, int count, int col0,
                        const int (&rows)[2]) {
      for (int c0 = 0; c0 < count; c0 += 16) {  // two n8 tiles of table rows
        float acc[2][4] = {};
        uint32_t bf[2][kSteps][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = c0 + 8 * h + gr;
          const bf16* tp = table + (size_t)(t < count ? t : 0) * HD + 2 * tq;
#pragma unroll
          for (int k = 0; k < kSteps; ++k) {
            bf[h][k][0] = t < count ? ldg32(tp + 16 * k) : 0u;
            bf[h][k][1] = t < count ? ldg32(tp + 16 * k + 8) : 0u;
          }
        }
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          mma_bf16(acc[0], a[k], bf[0][k][0], bf[0][k][1]);
          mma_bf16(acc[1], a[k], bf[1][k][0], bf[1][k][1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = rows[e >> 1];
            const int t = c0 + 8 * h + 2 * tq + (e & 1);
            if (row >= 0 && t < count) rel[row * rs + col0 + t] = rnd(acc[h][e], bf16());
          }
        }
      }
    };

    // One item: CTA rows first, first + stride, ... below end (16 at most)
    // against one table.
    auto rel_item = [&](int first, int stride, int end, const bf16* table, int count, int col0) {
      int ar = first + a_row * stride;
      ar = ar < end ? ar : first;
      uint32_t a[kSteps][4];
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        ldmatrix_x4(smem_addr(qs + ar * kStride + a_col + 16 * k), a[k]);
      const int r_lo = first + gr * stride, r_hi = first + (gr + 8) * stride;
      const int rows[2] = {r_lo < end ? r_lo : -1, r_hi < end ? r_hi : -1};
      rel_tile(a, table, count, col0, rows);
    };
    // rel_h items: the CTA's rows of one qh (a run of aw), 16 at a time.
    // rel_w items: residue c < min(aw, nrows) holds CTA rows c + j aw, 16 of
    // them at a time. The warps share both lists.
    const int nrows = min(kRows, n - q0);  // valid rows of this CTA
    const int qh_first = split(q0).x;
    const int per_qh = (g.aw + 15) / 16;
    const int n_h = (split(q0 + nrows - 1).x - qh_first + 1) * per_qh;
    const int n_res = min(g.aw, nrows);
    const int n_w = n_res * (((nrows + g.aw - 1) / g.aw + 15) / 16);
    for (int i = warp; i < n_h + n_w; i += kWarps) {  // uniform across the warp
      if (i < n_h) {
        const int qh = qh_first + i / per_qh;
        const int c = 16 * (i % per_qh);
        const int lo = max(0, qh * g.aw + c - q0);
        const int hi = min(nrows, qh * g.aw + min(c + 16, g.aw) - q0);
        if (lo < hi) rel_item(lo, 1, hi, rh + (size_t)qh * g.ah * HD, g.ah, g.aw);
      } else {
        const int c = (i - n_h) % n_res;
        const int first = c + 16 * ((i - n_h) / n_res) * g.aw;
        if (first < nrows) rel_item(first, g.aw, nrows, rw + (size_t)split(q0 + c).y * g.aw * HD, g.aw, 0);
      }
    }
    if (tid >= nrows && tid < kRows) {  // rows past n: zeros
      for (int t = 0; t < g.ah + g.aw; ++t) rel[tid * rs + t] = 0.0f;
    }
  }

  // This warp's 16 rows of q * scale, rounded to bf16: the A fragments of
  // QK^T, kept in registers.
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    ldmatrix_x4(smem_addr(qs + (16 * warp + a_row) * kStride + a_col + 16 * k), qa[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[k][i]));
      qa[k][i] = pack_bf16(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
    }
  }
  __syncthreads();  // q's rows are free for key tiles; rel is written

  // Per-lane ldmatrix offsets. K (.col operand, row-major keys): matrices
  // (keys 0-7, dims 0-7), (keys 0-7, dims 8-15), (keys 8-15, dims 0-7),
  // (keys 8-15, dims 8-15) -> b0, b1 of two n8 key tiles. V (.trans):
  // (keys 0-7, dims 0-7), (keys 8-15, dims 0-7), (keys 0-7, dims 8-15),
  // (keys 8-15, dims 8-15) -> b0, b1 of two n8 dim tiles.
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
  const bool active = q0 + 16 * warp < n;
  const char* rel0 = reinterpret_cast<const char*>(rel + (16 * warp + gr) * rs);  // row gr
  const char* rel1 = rel0 + 32 * rs;                                             // row gr + 8
  // With aw even, a thread's two columns of an n8 tile (keys 2 tq and 2 tq + 1
  // past a multiple of 8) share kh and have kw even and kw + 1.
  const bool pairs = (g.aw & 1) == 0;

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float l[2] = {0.0f, 0.0f};

  // One barrier per key tile: past it, tile it has landed for every thread and
  // every warp is done with tile it - 1, whose stage then takes tile it + 1.
  const int n_tiles = (n + kKeys - 1) / kKeys;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKeys;
    const int kn = min(kKeys, n - k0);
    const int cur = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) stage_kv(k0 + kKeys, cur ^ 1);

    if (!active) continue;  // uniform across the warp
    // A full tile runs with no per-column guards; the ragged last one with.
    auto tile = [&](auto full_tile) {
      constexpr bool kFullTile = decltype(full_tile)::value;
      const bf16* ks = kv + cur * kStage;
      const bf16* vs = ks + kKeys * kStride;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (kFullTile || 16 * jp < kn) {
            uint32_t kb[4];
            ldmatrix_x4(smem_addr(ks + k_off + 16 * jp * kStride + 16 * k), kb);
            mma_bf16(s[2 * jp], qa[k], kb[0], kb[1]);
            mma_bf16(s[2 * jp + 1], qa[k], kb[2], kb[3]);
          }
        }
      }

      // Rel-pos in the plain version's order: (S + rel_h) + rel_w. Keys past
      // n read valid offsets; the mask below overwrites their scores.
      if constexpr (REL) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tq;
          if (pairs) {
            const int2 kp = kpos[cur][col];
            const float2 w0 = *reinterpret_cast<const float2*>(rel0 + kp.x);
            const float2 w1 = *reinterpret_cast<const float2*>(rel1 + kp.x);
            const float h0 = *reinterpret_cast<const float*>(rel0 + kp.y);
            const float h1 = *reinterpret_cast<const float*>(rel1 + kp.y);
            s[j][0] = (s[j][0] + h0) + w0.x;
            s[j][1] = (s[j][1] + h0) + w0.y;
            s[j][2] = (s[j][2] + h1) + w1.x;
            s[j][3] = (s[j][3] + h1) + w1.y;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int2 kp = kpos[cur][col + e];
              s[j][e] = (s[j][e] + *reinterpret_cast<const float*>(rel0 + kp.y)) +
                        *reinterpret_cast<const float*>(rel0 + kp.x);
              s[j][e + 2] = (s[j][e + 2] + *reinterpret_cast<const float*>(rel1 + kp.y)) +
                            *reinterpret_cast<const float*>(rel1 + kp.x);
            }
          }
        }
      }
      // The mask past the ragged edge.
      if (!kFullTile) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * j + 2 * tq + e >= kn) s[j][e] = s[j][e + 2] = -INFINITY;
          }
        }
      }
      // Online softmax; p = 2^(s log2 e - m log2 e) is one FFMA and one ex2.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        const float alpha = exp2_approx((m[r] - m_new) * kLog2e);  // 0 on the first tile
        m[r] = m_new;
        ms[r] = m_new * kLog2e;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(fmaf(s[j][e], kLog2e, -ms[e >> 1]));
          l[e >> 1] += s[j][e];
        }
      }

#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kFullTile || 16 * kk < kn) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < kSteps; ++dp) {
            uint32_t vb[4];
            ldmatrix_x4_trans(smem_addr(vs + v_off + 16 * kk * kStride + 16 * dp), vb);
            mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
            mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
          }
        }
      }
    };
    if (kn == kKeys) {
      tile(std::true_type());
    } else {
      tile(std::false_type());
    }
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const float inv = 1.0f / l[r];
      const int qi = q0 + 16 * warp + gr + 8 * r;
      if (qi < n) {
        bf16* op = out + token(qi) * (size_t)g.dim + (size_t)head * HD + 2 * tq;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int HD, bool REL>
int launch_mma(const void* qkv, void* out, const void* rh, const void* rw, int B, int heads,
               Geometry g, int gh, float scale, cudaStream_t stream) {
  const int n = g.ah * g.aw;
  const size_t smem = (size_t)2 * 2 * kKeys * (HD + 8) * sizeof(bf16) +
                      (REL ? (size_t)kRows * rel_stride(g.ah, g.aw) * sizeof(float) : 0);
  auto kernel = window_attention_kernel_mma<HD, REL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)((n + kRows - 1) / kRows) * heads * B * gh * g.gw;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<const bf16*>(rh),
      static_cast<const bf16*>(rw), g, heads, scale);
  return (int)cudaGetLastError();
}

template <bool REL>
int dispatch_hd_mma(int hd, const void* qkv, void* out, const void* rh, const void* rw, int B,
                    int heads, Geometry g, int gh, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_mma<32, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    case 64: return launch_mma<64, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    case 80: return launch_mma<80, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    case 128: return launch_mma<128, REL>(qkv, out, rh, rw, B, heads, g, gh, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The f32 kernel: 3xTF32 tensor-core tiles, real rows only.

constexpr int kTfWarps = 4;                // warps per CTA, one m16 tile of query rows each
constexpr int kTfRows = 16 * kTfWarps;     // query rows per CTA
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfKeys = 32;                // keys per staged tile; two stages
constexpr int kTfMinCtas = 3;              // CTAs per SM the registers must allow
constexpr int kTfPer = kTfThreads / (2 * kTfKeys);  // threads per staged K or V row
constexpr int kN8 = kTfKeys / 8;           // n8 tiles of scores per key tile
static_assert(kTfPer >= 1 && kTfThreads == kTfPer * 2 * kTfKeys && kTfRows <= 2 * kTfKeys,
              "a stage's K and V rows take every thread, which also stage q's rows");

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) in two integer
// instructions: add half a TF32 ulp, clear the 13 bits TF32 drops. The
// conversion instruction adds an Inf/NaN test and a select (four in all).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 22 bits of mantissa.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// d += a (16x8, row) * b (8x8, col): tf32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b as three TF32 products, the small ones first, summed from zero
// and added to d in f32 (see the header: the tensor core's own accumulation
// rounds toward zero).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(t, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(t, a_hi, b_hi[0], b_hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// CTAs per (image x window, head): enough tiles of kTfRows rows for the most
// real rows a window has, that of window (0, 0).
__host__ __device__ __forceinline__ int tf32_query_tiles(const Geometry& g, int h, int w) {
  return ((g.ah < h ? g.ah : h) * (g.aw < w ? g.aw : w) + kTfRows - 1) / kTfRows;
}

template <int HD, bool REL>
__global__ void __launch_bounds__(kTfThreads, kTfMinCtas)
    window_attention_kernel_tf32(const float* __restrict__ qkv, float* __restrict__ out,
                                 const float* __restrict__ rh, const float* __restrict__ rw,
                                 Geometry g, int heads, int h, int w_valid, float scale) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr int kStride = HD + 4;             // shared-memory row, floats
  constexpr int kChunks = HD / 4 / kTfPer;    // 16-byte chunks per staged row, per thread
  constexpr int kK8 = HD / 8;                 // k8 steps of QK^T; n8 tiles of PV
  constexpr int kStage = 2 * kTfKeys * kStride;  // one stage: K rows, then V rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kv = reinterpret_cast<float*>(smem_raw);  // [2 stages][K, V][kTfKeys][kStride]
  float* qs = kv + 2 * kStage;                      // [kTfRows][kStride]: q, unscaled
  float* rel = qs + kTfRows * kStride;              // [kTfRows][rs]: rel_w, rel_h
  // Staged key j's rel offsets in bytes, (kw, aw + kh) * 4; (0, aw) * 4 past n.
  __shared__ int2 kpos[2][kTfKeys];

  const int n = g.ah * g.aw;
  const int rs = rel_stride(g.ah, g.aw);
  // CTA order as in the bf16 kernel: query tile fastest, then head, then
  // (image, window).
  const int n_qt = tf32_query_tiles(g, h, w_valid);
  const int qt = blockIdx.x % n_qt;
  const int head = (blockIdx.x / n_qt) % heads;
  const int bw = blockIdx.x / n_qt / heads;
  const int b = bw / g.nw;
  const int w = bw - b * g.nw;
  const int wy = w / g.gw;
  const int wx = w - wy * g.gw;
  // This window's real rows (see "Real rows"); a tile past them has no work.
  const int real_h = min(g.ah, h - wy * g.ah);
  const int real_w = min(g.aw, w_valid - wx * g.aw);
  const int nr = real_h > 0 && real_w > 0 ? real_h * real_w : 0;
  const int q0 = qt * kTfRows;
  if (q0 >= nr) return;  // uniform across the CTA
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // accumulator rows gr and gr + 8
  const int tq = lane & 3;   // accumulator columns 2 tq and 2 tq + 1 of each n8 tile
  const int srow = tid / kTfPer;   // the stage row this thread stages, with its partners
  const int spart = tid % kTfPer;  // ... its 16-byte chunks kTfPer j + spart

  // i / d without an integer division, exact as in the bf16 kernel: key i
  // of the window (d = aw) or local row r of the real rows (d = real_w).
  const float inv_aw = 1.0f / (float)g.aw;
  const float inv_rw = 1.0f / (float)real_w;
  auto split_key = [&](int i) -> int2 {
    const int ih = __float2int_rz(((float)i + 0.5f) * inv_aw);
    return make_int2(ih, i - ih * g.aw);
  };
  auto split_row = [&](int r) -> int2 {
    const int ih = __float2int_rz(((float)r + 0.5f) * inv_rw);
    return make_int2(ih, r - ih * real_w);
  };
  auto token = [&](int2 hw) -> size_t {
    return ((size_t)b * g.HP + (size_t)(wy * g.ah + hw.x)) * g.WP + (size_t)(wx * g.aw + hw.y);
  };
  const size_t c3 = 3 * (size_t)g.dim;
  const float* base = qkv + (size_t)head * HD + 4 * spart;

  // Stage key tile [k0, k0 + 64) into stage s by cp.async: this thread's
  // share of stage row srow, a row of K (srow < 64) or of V (zero past the
  // ragged edge), and the key's rel offsets.
  auto stage_kv = [&](int k0, int s) {
    const int key = k0 + srow % kTfKeys;
    const bool live = key < n;
    const int2 hw = split_key(live ? key : 0);
    const float* src = base + token(hw) * c3 + (size_t)(1 + srow / kTfKeys) * g.dim;
    float* dst = kv + s * kStage + srow * kStride + 4 * spart;
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      cp_async16(smem_addr(dst + 4 * kTfPer * j), src + 4 * kTfPer * j, live);
    if (REL && spart == 0 && srow < kTfKeys)
      kpos[s][srow] = make_int2(4 * hw.y, 4 * (g.aw + hw.x));
    cp_async_commit();
  };

  // q, unscaled (zero past the real rows); key tile 0 meanwhile.
  if (srow < kTfRows) {
    const int r = q0 + srow;
    const bool live = r < nr;
    const float* src = base + token(split_row(live ? r : 0)) * c3;
    float* dst = qs + srow * kStride + 4 * spart;
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      cp_async16(smem_addr(dst + 4 * kTfPer * j), src + 4 * kTfPer * j, live);
  }
  cp_async_commit();
  stage_kv(0, 0);
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  // ldmatrix of A tiles, 8x4-float matrices (rows 0-7 | 8-15) x (dims 0-3 |
  // 4-7) of a k8 step: lane l gives the address of row a_row, column a_col.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;

  if constexpr (REL) {
    // rel_w[r][t] = q[r] . Rw[qw(r)][t] and rel_h[r][t] = q[r] . Rh[qh(r)][t],
    // q unscaled, as in the bf16 kernel: rows sharing a table form one A
    // tile, gathered by ldmatrix; the table (row-major, like K) is B, read
    // from global memory. CTA rows first, first + stride, ... below end (16
    // at most) against one table of `count` rows, stored at column col0.
    auto rel_item = [&](int first, int stride, int end, const float* table, int count,
                        int col0) {
      int ar = first + a_row * stride;
      ar = ar < end ? ar : first;
      const int r_lo = first + gr * stride, r_hi = first + (gr + 8) * stride;
      const int rows[2] = {r_lo < end ? r_lo : -1, r_hi < end ? r_hi : -1};
      for (int c0 = 0; c0 < count; c0 += 16) {  // two n8 tiles of table rows
        float acc[2][4] = {};
#pragma unroll
        for (int k = 0; k < kK8; ++k) {
          uint32_t a[4], a_hi[4], a_lo[4];
          ldmatrix_x4(smem_addr(qs + ar * kStride + a_col + 8 * k), a);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), a_hi[i], a_lo[i]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int t = c0 + 8 * hh + gr;
            const float* tp = table + (size_t)(t < count ? t : 0) * HD + 8 * k + tq;
            const float x[2] = {t < count ? __ldg(tp) : 0.0f, t < count ? __ldg(tp + 4) : 0.0f};
            uint32_t b_hi[2], b_lo[2];
            split_tf32(x, b_hi, b_lo);
            mma_3xtf32(acc[hh], a_hi, a_lo, b_hi, b_lo);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = rows[e >> 1];
            const int t = c0 + 8 * hh + 2 * tq + (e & 1);
            if (row >= 0 && t < count) rel[row * rs + col0 + t] = acc[hh][e];
          }
        }
      }
    };
    // rel_h items: the CTA's rows of one qh (a run of real_w), 16 at a time.
    // rel_w items: residue c < min(real_w, nrows) holds CTA rows c + j real_w,
    // 16 of them at a time. The warps share both lists.
    const int nrows = min(kTfRows, nr - q0);  // real rows of this CTA
    const int qh_first = split_row(q0).x;
    const int per_qh = (real_w + 15) / 16;
    const int n_h = (split_row(q0 + nrows - 1).x - qh_first + 1) * per_qh;
    const int n_res = min(real_w, nrows);
    const int n_w = n_res * (((nrows + real_w - 1) / real_w + 15) / 16);
    for (int i = warp; i < n_h + n_w; i += kTfWarps) {  // uniform across the warp
      if (i < n_h) {
        const int qh = qh_first + i / per_qh;
        const int c = 16 * (i % per_qh);
        const int lo = max(0, qh * real_w + c - q0);
        const int hi = min(nrows, qh * real_w + min(c + 16, real_w) - q0);
        if (lo < hi) rel_item(lo, 1, hi, rh + (size_t)qh * g.ah * HD, g.ah, g.aw);
      } else {
        const int c = (i - n_h) % n_res;
        const int first = c + 16 * ((i - n_h) / n_res) * real_w;
        if (first < nrows)
          rel_item(first, real_w, nrows, rw + (size_t)split_row(q0 + c).y * g.aw * HD, g.aw, 0);
      }
    }
    if (tid >= nrows && tid < kTfRows) {  // rows past the real rows: zeros
      for (int t = 0; t < g.ah + g.aw; ++t) rel[tid * rs + t] = 0.0f;
    }
  }

  __syncthreads();  // rel is written

  // Per-lane offsets. K (.col operand, row-major keys), ldmatrix matrices
  // (keys 0-7, dims 0-3), (keys 0-7, dims 4-7), (keys 8-15, dims 0-3),
  // (keys 8-15, dims 4-7) -> b0, b1 of two n8 key tiles. V, scalar: keys
  // 2 tq and 2 tq + 1 of a k8 step, dim gr of an n8 tile.
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 4;
  const float* q_warp = qs + (16 * warp + a_row) * kStride + a_col;
  const int v_off = 2 * tq * kStride + gr;
  const bool active = q0 + 16 * warp < nr;
  const char* rel0 = reinterpret_cast<const char*>(rel + (16 * warp + gr) * rs);  // row gr
  const char* rel1 = rel0 + 32 * rs;                                             // row gr + 8
  const bool pairs = (g.aw & 1) == 0;

  float o[kK8][4];
#pragma unroll
  for (int j = 0; j < kK8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float l[2] = {0.0f, 0.0f};

  const int n_tiles = (n + kTfKeys - 1) / kTfKeys;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTfKeys;
    const int kn = min(kTfKeys, n - k0);
    const int cur = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) stage_kv(k0 + kTfKeys, cur ^ 1);

    if (!active) continue;  // uniform across the warp
    auto tile = [&](auto full_tile) {
      constexpr bool kFullTile = decltype(full_tile)::value;
      const float* ks = kv + cur * kStage;
      const float* vs = ks + kTfKeys * kStride;
      float s[kN8][4];
#pragma unroll
      for (int j = 0; j < kN8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int k = 0; k < kK8; ++k) {
        // This warp's 16 rows of q * scale, the A fragment of k8 step k,
        // read from shared memory for each key tile (in registers as hi and
        // lo they would hold HD registers).
        uint32_t a[4], a_hi[4], a_lo[4];
        ldmatrix_x4(smem_addr(q_warp + 8 * k), a);
        float qk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qk[i] = __fmul_rn(__uint_as_float(a[i]), scale);
        split_tf32(qk, a_hi, a_lo);
#pragma unroll
        for (int jp = 0; jp < kN8 / 2; ++jp) {
          if (kFullTile || 16 * jp < kn) {
            uint32_t kb[4];
            ldmatrix_x4(smem_addr(ks + k_off + 16 * jp * kStride + 8 * k), kb);
            float x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(kb[i]);
            uint32_t b_hi[4], b_lo[4];
            split_tf32(x, b_hi, b_lo);
            mma_3xtf32(s[2 * jp], a_hi, a_lo, {b_hi[0], b_hi[1]}, {b_lo[0], b_lo[1]});
            mma_3xtf32(s[2 * jp + 1], a_hi, a_lo, {b_hi[2], b_hi[3]}, {b_lo[2], b_lo[3]});
          }
        }
      }

      // Rel-pos in the plain version's order: (S + rel_h) + rel_w.
      if constexpr (REL) {
#pragma unroll
        for (int j = 0; j < kN8; ++j) {
          const int col = 8 * j + 2 * tq;
          if (pairs) {
            const int2 kp = kpos[cur][col];
            const float2 w0 = *reinterpret_cast<const float2*>(rel0 + kp.x);
            const float2 w1 = *reinterpret_cast<const float2*>(rel1 + kp.x);
            const float h0 = *reinterpret_cast<const float*>(rel0 + kp.y);
            const float h1 = *reinterpret_cast<const float*>(rel1 + kp.y);
            s[j][0] = (s[j][0] + h0) + w0.x;
            s[j][1] = (s[j][1] + h0) + w0.y;
            s[j][2] = (s[j][2] + h1) + w1.x;
            s[j][3] = (s[j][3] + h1) + w1.y;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int2 kp = kpos[cur][col + e];
              s[j][e] = (s[j][e] + *reinterpret_cast<const float*>(rel0 + kp.y)) +
                        *reinterpret_cast<const float*>(rel0 + kp.x);
              s[j][e + 2] = (s[j][e + 2] + *reinterpret_cast<const float*>(rel1 + kp.y)) +
                            *reinterpret_cast<const float*>(rel1 + kp.x);
            }
          }
        }
      }
      if (!kFullTile) {
#pragma unroll
        for (int j = 0; j < kN8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * j + 2 * tq + e >= kn) s[j][e] = s[j][e + 2] = -INFINITY;
          }
        }
      }
      // Online softmax, p = exp(s - m) as the plain version computes it.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        const float alpha = expf(m[r] - m_new);  // 0 on the first tile
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < kK8; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }

      // PV: the accumulators of key tile kk are the A fragment of one k8
      // step (column t: key 2 tq, column t + 4: key 2 tq + 1).
#pragma unroll
      for (int kk = 0; kk < kN8; ++kk) {
        if (kFullTile || 8 * kk < kn) {
          const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
          uint32_t p_hi[4], p_lo[4];
          split_tf32(pa, p_hi, p_lo);
          const float* vp = vs + v_off + 8 * kk * kStride;
#pragma unroll
          for (int d = 0; d < kK8; ++d) {
            const float x[2] = {vp[8 * d], vp[kStride + 8 * d]};
            uint32_t b_hi[2], b_lo[2];
            split_tf32(x, b_hi, b_lo);
            mma_3xtf32(o[d], p_hi, p_lo, b_hi, b_lo);
          }
        }
      }
    };
    if (kn == kTfKeys) {
      tile(std::true_type());
    } else {
      tile(std::false_type());
    }
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int qi = q0 + 16 * warp + gr + 8 * r;
      if (qi < nr) {
        float* op = out + token(split_row(qi)) * (size_t)g.dim + (size_t)head * HD + 2 * tq;
#pragma unroll
        for (int j = 0; j < kK8; ++j) {
          *reinterpret_cast<float2*>(op + 8 * j) =
              make_float2(__fdiv_rn(o[j][2 * r], l[r]), __fdiv_rn(o[j][2 * r + 1], l[r]));
        }
      }
    }
  }
}

template <int HD, bool REL>
int launch_tf32(const void* qkv, void* out, const void* rh, const void* rw, int B, int heads,
                Geometry g, int gh, int h, int w, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)2 * 2 * kTfKeys + kTfRows) * (HD + 4) * sizeof(float) +
                      (REL ? (size_t)kTfRows * rel_stride(g.ah, g.aw) * sizeof(float) : 0);
  auto kernel = window_attention_kernel_tf32<HD, REL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)tf32_query_tiles(g, h, w) * heads * B * gh * g.gw;
  if (ctas <= 0 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, kTfThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<const float*>(rh),
      static_cast<const float*>(rw), g, heads, h, w, scale);
  return (int)cudaGetLastError();
}

template <bool REL>
int dispatch_hd_tf32(int hd, const void* qkv, void* out, const void* rh, const void* rw, int B,
                     int heads, Geometry g, int gh, int h, int w, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_tf32<32, REL>(qkv, out, rh, rw, B, heads, g, gh, h, w, scale, s);
    case 64: return launch_tf32<64, REL>(qkv, out, rh, rw, B, heads, g, gh, h, w, scale, s);
    case 80: return launch_tf32<80, REL>(qkv, out, rh, rw, B, heads, g, gh, h, w, scale, s);
    case 128: return launch_tf32<128, REL>(qkv, out, rh, rw, B, heads, g, gh, h, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, called through ctypes. Pointers are device pointers
// (rh and rw null without rel-pos); `stream` is the caller's cudaStream_t;
// `scale` is already rounded to the input dtype; (h, w) is the real token
// extent of the grid (see "Real rows"; the bf16 kernel ignores it). Return
// the launch's cudaError_t (0 on success).
extern "C" int wsi_window_attention_rows(const void* qkv, void* out, const void* rh,
                                         const void* rw, int bf16, int hd, int B, int HP,
                                         int WP, int dim, int heads, int ah, int aw, int gh,
                                         int gw, int h, int w, float scale, void* stream) {
  const Geometry g{HP, WP, dim, ah, aw, gw, gh * gw};
  auto s = static_cast<cudaStream_t>(stream);
  const bool rel = rh != nullptr;
  if (bf16) {
    return rel ? dispatch_hd_mma<true>(hd, qkv, out, rh, rw, B, heads, g, gh, scale, s)
               : dispatch_hd_mma<false>(hd, qkv, out, rh, rw, B, heads, g, gh, scale, s);
  }
  return rel ? dispatch_hd_tf32<true>(hd, qkv, out, rh, rw, B, heads, g, gh, h, w, scale, s)
             : dispatch_hd_tf32<false>(hd, qkv, out, rh, rw, B, heads, g, gh, h, w, scale, s);
}

// Every row of the grid: the entry point of every build of this file, so that
// `ops/k2_variants.py` can time older builds beside this one.
extern "C" int wsi_window_attention(const void* qkv, void* out, const void* rh,
                                    const void* rw, int bf16, int hd, int B, int HP, int WP,
                                    int dim, int heads, int ah, int aw, int gh, int gw,
                                    float scale, void* stream) {
  return wsi_window_attention_rows(qkv, out, rh, rw, bf16, hd, B, HP, WP, dim, heads, ah, aw,
                                   gh, gw, HP, WP, scale, stream);
}

extern "C" const char* wsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
