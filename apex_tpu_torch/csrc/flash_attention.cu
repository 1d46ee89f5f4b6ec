// Flash attention forward and its FA2-style backward (dq; dk and dv) for
// Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/contrib/fmha.py `_flash_fwd_kernel` (:103),
// `_flash_dq_kernel` (:237) and `_flash_dkv_kernel` (:278), launched by
// `flash_attention` and its custom VJP. Layouts, the JAX package's:
// q, k, v, o, do, dq, dk, dv [bh, s, d] (bh = batch * heads, contiguous),
// lse and delta [bh, s] fp32, slopes [heads] fp32 or null. Key j is
// visible to query i iff j < s and, causal, j <= i and (with a window)
// i - j < window. Masked scores are -1e30 (not -inf, and not the -10000
// of the softmax kernels), as in the TPU kernels.
//
//   forward: s = (q * scale) . k^T (+ slope[h] * j); online softmax with
//            fp32 running max m and sum l; o = acc / max(l, 1e-30) in
//            q's dtype, lse = m + log(max(l, 1e-30)) in fp32.
//   dq:      p = exp(q . k^T * scale (+ alibi) - lse),
//            ds = p * (do . v^T - delta), dq = (ds . k) * scale.
//   dk, dv:  dv = p^T . do, dk = (ds^T . q) * scale.
// delta = rowsum(do * o) over the saved (rounded) o is the caller's.
// The scale multiplies q before the product in the forward and the
// product after it in the backward, as the TPU kernels do.
//
// Bound on the H100: operations. At the training step's shape (bh = 64,
// s = 2048, d = 64, causal: 1.34e8 live (i, j) pairs) the forward does
// 4d, dq 6d and dk/dv 8d operations per live pair (34.4, 51.6 and 68.7
// GFLOP) on ~135-200 MB. The model's path hands the kernels fp32 q/k/v
// (the QKV bias add promotes to fp32), and p, ds and the accumulators
// are fp32 everywhere. As fp32 FMAs on the CUDA cores (67 TFLOP/s) the
// three take at least 513, 770 and 1026 us. On the tensor cores at fp32
// accuracy each product is three TF32 products (below), at 495 TFLOP/s:
// at least 208.3, 312.5 and 416.7 us. With bf16 inputs q, k, v and do
// are exact in TF32 and only p and ds are split: dq does 1 + 1 + 2
// products (8d operations a pair, 138.9 us) and dk/dv 1 + 1 + 2 + 2
// (12d, 208.3 us). The bf16 forward takes the bf16 tensor cores (989
// TFLOP/s): q . k^T one product, p . v three (p split into three bf16
// terms), 8d operations a pair, at least 69.5 us.
//
// The first design (kept for d = 256 and unaligned operands, as path 0
// of apex_flash_fwd, apex_flash_dq and apex_flash_dkv): one block of 256
// threads (a 16 x 16 grid) per (head, tile of B query rows) for the
// forward and dq,
// per (head, tile of B key rows) for dk/dv; B = 64 for d <= 128 and 32
// for d = 256, so every tile fits shared memory. The TPU grid's
// sequential axis becomes a loop inside the block over the other
// operand's tiles, staged in shared memory as fp32 rows padded to d + 1
// (conflict-free column reads). Only tiles that hold a visible pair are
// visited: up to the diagonal for causal, and from the window's first key
// (forward, dq) or up to its last query (dk/dv). Each thread owns a B/16
// x B/16 patch of the score tile (its rows' softmax statistics reduced
// over the 16 lanes of a half-warp) and a B/16 x d/16 patch of the output
// accumulators; every product is an fp32 FMA. p and ds pass through
// shared memory to the second product. Tails where s is not a multiple
// of B are masked. The causal forward and dq visit the longest query
// tiles first.
//
// Backward on the tensor cores (path 1: d = 64 and 128, 16-byte aligned
// operands; `fmha.bwd_plan` picks the path from the shapes, and the
// launcher refuses a path the shapes do not fit):
//  * Products: mma.sync.m16n8k8 TF32 with fp32 accumulation, fp32 values
//    split three ways as CUTLASS's "fast fp32" does: hi = rna_tf32(a), lo
//    = rna_tf32(a - hi) (a - hi is exact in fp32), a . b = lo_a . hi_b +
//    hi_a . lo_b + hi_a . hi_b, smallest first; the dropped lo . lo term
//    and lo's rounding leave under 2^-21 of each product. A bf16 operand
//    is exact in TF32 and takes one term. Every product of both kernels
//    goes through this; no atomics: dq and dk/dv stay two kernels and
//    every output tile has one writer, so the result is deterministic.
//  * dk/dv: a block of kWarps warps owns 16 key rows a warp (one mma M
//    tile; 8 warps and 128 rows for fp32 at d 64, else 4 and 64) and
//    keeps K and V in shared memory as fp32 rows padded to d + 4 (the
//    fragment reads below are then conflict-free), split into terms as
//    each k step reads them. Query tiles of kTile rows (64 for fp32 at d
//    64, 32 for bf16, 16 at d 128) of Q and dO, with their lse and delta,
//    stream through a ring of kStages cp.async stages in the inputs'
//    dtype; when a tile lands, the block splits it once into hi and lo
//    planes (fp32 padded rows), which every warp then reads. A warp
//    computes S^T = K . Q^T and dP^T = V . dO^T for its 16 keys (the
//    queries are the mma's N, so Q and dO rows are B fragments as they
//    lie, read for fp32 by ldmatrix), then P^T and dS^T in the accumulator
//    fragment, then dV += P^T . dO and dK += dS^T . Q.
//  * dq: the mirror image: a block owns the query rows (Q and dO
//    resident, lse and delta of a warp's rows in registers) and streams K
//    and V.
//  * The accumulator layout of m16n8k8 (row g, columns 2t and 2t + 1 for
//    lane 4g + t) is not its A layout (row g, columns t and t + 4). The
//    second products sum over the tile's queries (dk/dv) or keys (dq),
//    in any order within a k step, so k columns t and t + 4 stand for
//    rows 2t and 2t + 1 of the step; the accumulator registers of P^T and
//    dS^T are then the A fragment as they are, with no shuffle, and the B
//    fragment reads dO, Q or K rows 2t and 2t + 1.
//  * Ranges as in the first design: causal dq visits key tiles up to its
//    block's last row, from the window's first key; dk/dv visits query
//    tiles from its block's first key up to the window's last query. The
//    longest tiles go first. A warp skips a tile that holds no visible
//    pair of its 16 rows (its contribution is exactly 0); a tile whose
//    every pair is visible skips the per-element mask, so only diagonal,
//    window-edge and ragged tiles mask.
//  * Paths 2 and 3 (fp32, d = 64 only) are faults planted for the card
//    check: the lo terms dropped, and the last tile of each causal range
//    skipped. No caller of the package passes them.
//
// Forward on the tensor cores (path 1 of apex_flash_fwd: d = 64 and 128,
// q, k, v and o 16-byte aligned; `fmha.fwd_plan` picks the path):
//  * A block of warps owns 16 query rows a warp (8 warps for fp32 at d
//    64, else 4) and streams K and V through a ring of cp.async stages of
//    32-key tiles, rows padded by 16 bytes. S stays
//    in the accumulator registers, the online softmax runs on them (a
//    row's max and sum over the 4 lanes of its quad), and P feeds P . V
//    from there: no shared-memory round trip for p, one writer a row, no
//    atomics. Causal blocks visit key tiles up to their last row, from the
//    window's first key, longest query tiles first; a warp skips a tile
//    none of its rows sees, and only diagonal, window-edge and ragged
//    tiles mask per element.
//  * fp32 inputs (mma_fwd_kernel): 3xTF32 on m16n8k8, as the backward.
//    The block's Q rows stay in shared memory and each k step splits Q *
//    scale (the TPU kernel's order) as it reads it: with Q's split
//    fragments held in registers two blocks no longer fit an SM, which
//    ran slower (PERF.md section 6). Each landed tile
//    is split once into K hi/lo planes and V^T hi/lo planes (V
//    transposed): with the k-column trick (keys 2t and 2t + 1 in k columns
//    t and t + 4) a B fragment of P . V is two neighbours of a V^T row,
//    one 8-byte read a term. Two barriers a tile (landed; planes written).
//  * bf16 inputs (bf16_fwd_kernel): m16n8k16 bf16 with fp32 accumulation,
//    fragments by ldmatrix (V's transposed) from the landed stage as it
//    lies; one barrier a tile, three stages. k and v are exact and take
//    one term; p is fp32 in the TPU kernel's P . V and is split into three
//    bf16 terms (split3: p to within 2^-27); q * scale is one term where
//    the scale is a power of two (exact in bf16), else three. S's
//    accumulator is P's A fragment as it lies.
//  * Paths 2 and 3 as the backward's (fp32, d 64): the lo terms dropped;
//    the last key tile of each causal range skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "kv_attention.cuh"  // apex_kv:: bf16 mma, ldmatrix and split3

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kGrid = 16;  // threads per side of the 16 x 16 thread grid
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// sums and maxima over the 16 lanes of a half-warp (one tile row)
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
struct Tile {
  static constexpr int kB = D <= 128 ? 64 : 32;  // rows of a tile
  static constexpr int kR = kB / kGrid;          // tile rows per thread
  static constexpr int kC = kB / kGrid;          // tile columns per thread
  static constexpr int kDc = D / kGrid;          // head columns per thread
  static constexpr int kLd = D + 1;              // padded row of q/k/v/do
  static constexpr int kLp = kB + 1;             // padded row of p/ds
};

__device__ __forceinline__ bool visible(int i, int j, int s, int causal,
                                        int window) {
  if (i >= s || j >= s) return false;
  if (!causal) return true;
  return j <= i && (window <= 0 || i - j < window);
}

// rows [r0, r0 + B) of a [s, D] matrix into shared memory as fp32 (rows
// past s as 0), times `mul`
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int r0, int s, float mul) {
  constexpr int B = Tile<D>::kB, LD = Tile<D>::kLd;
  for (int idx = threadIdx.x; idx < B * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] =
        row < s ? to_float(src[static_cast<long long>(row) * D + c]) * mul : 0.f;
  }
}

// rows [r0, r0 + B) of a [s] fp32 vector (0 past s)
template <int D>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src,
                                         int r0, int s) {
  for (int r = threadIdx.x; r < Tile<D>::kB; r += kThreads)
    dst[r] = r0 + r < s ? src[r0 + r] : 0.f;
}

// acc[i][j] = sum_c a[ty*R + i][c] * b[tx + 16 j][c]: the thread's patch
// of a (B x D) . (B x D)^T product, both operands in shared memory.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b, int ty,
                                         int tx,
                                         float (&acc)[Tile<D>::kR][Tile<D>::kC]) {
  constexpr int R = Tile<D>::kR, C = Tile<D>::kC, LD = Tile<D>::kLd;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty * R + i) * LD + c];
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b[(tx + kGrid * j) * LD + c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_t p[ty*R + i][t] * m[t][tx + 16 j]: the thread's patch
// of a (B x B) . (B x D) product, p padded to B + 1, m to D + 1.
template <int D>
__device__ __forceinline__ void mul_tile(const float* p, const float* m, int ty,
                                         int tx,
                                         float (&acc)[Tile<D>::kR][Tile<D>::kDc]) {
  constexpr int B = Tile<D>::kB, R = Tile<D>::kR, DC = Tile<D>::kDc;
  constexpr int LD = Tile<D>::kLd, LP = Tile<D>::kLp;
#pragma unroll 8
  for (int t = 0; t < B; ++t) {
    float pv[R], mv[DC];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = p[(ty * R + i) * LP + t];
#pragma unroll
    for (int j = 0; j < DC; ++j) mv[j] = m[t * LD + tx + kGrid * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

// the first key tile a causal (windowed) query tile at q0 reads, and the
// end of its key range
__device__ __forceinline__ void key_range(int q0, int B, int s, int causal,
                                          int window, int* begin, int* end) {
  *begin = 0;
  *end = s;
  if (causal) {
    *end = min(s, q0 + B);
    if (window > 0) *begin = max(q0 - window + 1, 0) / B * B;
  }
}

// ------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ slopes,
           T* __restrict__ o, float* __restrict__ lse, int heads, int s,
           float scale, int causal, int window) {
  using TL = Tile<D>;
  constexpr int B = TL::kB, R = TL::kR, C = TL::kC, DC = TL::kDc;
  constexpr int LD = TL::kLd, LP = TL::kLp;
  extern __shared__ float smem[];
  float* q_s = smem;            // B x LD, q * scale
  float* kv_s = q_s + B * LD;   // B x LD, the K tile, then the V tile
  float* p_s = kv_s + B * LD;   // B x LP

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * B;  // longest tiles first
  const long long base = static_cast<long long>(bh) * s * D;
  const float slope = slopes != nullptr ? slopes[bh % heads] : 0.f;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;

  load_rows<T, D>(q_s, q + base, q0, s, scale);
  int k_begin, k_end;
  key_range(q0, B, s, causal, window, &k_begin, &k_end);

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += B) {
    __syncthreads();  // q_s loaded; the previous V tile consumed
    load_rows<T, D>(kv_s, k + base, k0, s, 1.f);
    __syncthreads();
    float sc[R][C];
    dot_tile<D>(q_s, kv_s, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty * R + i;
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kj = k0 + tx + kGrid * j;
        float x = sc[i][j];
        if (slopes != nullptr) x += slope * static_cast<float>(kj);
        x = visible(qi, kj, s, causal, window) ? x : kNegInf;
        sc[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty * R + i) * LP + tx + kGrid * j] = p;
        psum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the K tile consumed, p_s written
    load_rows<T, D>(kv_s, v + base, k0, s, 1.f);
    __syncthreads();
    mul_tile<D>(p_s, kv_s, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi >= s) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + base + static_cast<long long>(qi) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + kGrid * j] = from_float<T>(acc[i][j] / lc);
    if (tx == 0) lse[static_cast<long long>(bh) * s + qi] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------- dq, first design

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ slopes, T* __restrict__ dq, int heads,
          int s, float scale, int causal, int window) {
  using TL = Tile<D>;
  constexpr int B = TL::kB, R = TL::kR, C = TL::kC, DC = TL::kDc;
  constexpr int LD = TL::kLd, LP = TL::kLp;
  extern __shared__ float smem[];
  float* q_s = smem;             // B x LD
  float* do_s = q_s + B * LD;    // B x LD
  float* k_s = do_s + B * LD;    // B x LD
  float* v_s = k_s + B * LD;     // B x LD
  float* ds_s = v_s + B * LD;    // B x LP
  float* lse_s = ds_s + B * LP;  // B
  float* delta_s = lse_s + B;    // B

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * B;
  const long long base = static_cast<long long>(bh) * s * D;
  const long long row_base = static_cast<long long>(bh) * s;
  const float slope = slopes != nullptr ? slopes[bh % heads] : 0.f;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;

  load_rows<T, D>(q_s, q + base, q0, s, 1.f);
  load_rows<T, D>(do_s, dout + base, q0, s, 1.f);
  load_vec<D>(lse_s, lse + row_base, q0, s);
  load_vec<D>(delta_s, delta + row_base, q0, s);
  int k_begin, k_end;
  key_range(q0, B, s, causal, window, &k_begin, &k_end);

  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += B) {
    __syncthreads();  // q/do/lse/delta loaded; the previous tiles consumed
    load_rows<T, D>(k_s, k + base, k0, s, 1.f);
    load_rows<T, D>(v_s, v + base, k0, s, 1.f);
    __syncthreads();
    float sc[R][C], dp[R][C];
    dot_tile<D>(q_s, k_s, ty, tx, sc);
    dot_tile<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kj = k0 + tx + kGrid * j;
        float x = sc[i][j] * scale;
        if (slopes != nullptr) x += slope * static_cast<float>(kj);
        x = visible(qi, kj, s, causal, window) ? x : kNegInf;
        const float p = expf(x - lse_s[r]);
        ds_s[r * LP + tx + kGrid * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    float part[R][DC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) part[i][j] = 0.f;
    mul_tile<D>(ds_s, k_s, ty, tx, part);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] += part[i][j] * scale;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi >= s) continue;
    T* row = dq + base + static_cast<long long>(qi) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) row[tx + kGrid * j] = from_float<T>(acc[i][j]);
  }
}

// --------------------------------------------------- dk, dv, first design

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ slopes, T* __restrict__ dk,
           T* __restrict__ dv, int heads, int s, float scale, int causal,
           int window) {
  using TL = Tile<D>;
  constexpr int B = TL::kB, R = TL::kR, C = TL::kC, DC = TL::kDc;
  constexpr int LD = TL::kLd, LP = TL::kLp;
  extern __shared__ float smem[];
  float* k_s = smem;             // B x LD
  float* v_s = k_s + B * LD;     // B x LD
  float* q_s = v_s + B * LD;     // B x LD
  float* do_s = q_s + B * LD;    // B x LD
  float* p_s = do_s + B * LD;    // B x LP: p^T, then ds^T
  float* lse_s = p_s + B * LP;   // B
  float* delta_s = lse_s + B;    // B

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * B;  // causal: the first key tiles are longest
  const long long base = static_cast<long long>(bh) * s * D;
  const long long row_base = static_cast<long long>(bh) * s;
  const float slope = slopes != nullptr ? slopes[bh % heads] : 0.f;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;

  load_rows<T, D>(k_s, k + base, k0, s, 1.f);
  load_rows<T, D>(v_s, v + base, k0, s, 1.f);
  // the query tiles that see a key of this tile
  int q_begin = 0, q_end = s;
  if (causal) {
    q_begin = k0;  // a multiple of B
    if (window > 0) q_end = min(s, k0 + B - 1 + window);
  }

  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += B) {
    __syncthreads();  // k/v loaded; the previous tiles consumed
    load_rows<T, D>(q_s, q + base, q0, s, 1.f);
    load_rows<T, D>(do_s, dout + base, q0, s, 1.f);
    load_vec<D>(lse_s, lse + row_base, q0, s);
    load_vec<D>(delta_s, delta + row_base, q0, s);
    __syncthreads();
    float sc[R][C], dp[R][C];
    dot_tile<D>(k_s, q_s, ty, tx, sc);   // [key][query] = k . q
    dot_tile<D>(v_s, do_s, ty, tx, dp);  // [key][query] = v . do
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
      const int kj = k0 + r;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = tx + kGrid * j;
        const int qi = q0 + c;
        float x = sc[i][j] * scale;
        if (slopes != nullptr) x += slope * static_cast<float>(kj);
        x = visible(qi, kj, s, causal, window) ? x : kNegInf;
        const float p = expf(x - lse_s[c]);
        p_s[r * LP + c] = p;
        dp[i][j] = p * (dp[i][j] - delta_s[c]);  // ds^T
      }
    }
    __syncthreads();
    mul_tile<D>(p_s, do_s, ty, tx, dv_acc);  // dv += p^T . do
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) p_s[(ty * R + i) * LP + tx + kGrid * j] = dp[i][j];
    __syncthreads();
    float part[R][DC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) part[i][j] = 0.f;
    mul_tile<D>(p_s, q_s, ty, tx, part);  // ds^T . q
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) dk_acc[i][j] += part[i][j] * scale;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty * R + i;
    if (kj >= s) continue;
    T* krow = dk + base + static_cast<long long>(kj) * D;
    T* vrow = dv + base + static_cast<long long>(kj) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      krow[tx + kGrid * j] = from_float<T>(dk_acc[i][j]);
      vrow[tx + kGrid * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

// ------------------------------------ backward on the tensor cores (3xTF32)

constexpr int kStages = 2;  // cp.async stages of the streamed tiles
// path codes of apex_flash_dq and apex_flash_dkv
constexpr int kPathSimt = 0;       // the first design (any d)
constexpr int kPathMma = 1;        // the tensor-core body (d 64, 128)
constexpr int kFaultNoLo = 2;      // planted: the lo terms dropped
constexpr int kFaultSkipLast = 3;  // planted: a causal range's last tile skipped
// what a warp's tile holds (band)
constexpr int kNoPair = 0, kSomePairs = 1, kAllPairs = 2;

// A block of both kernels: kWarps warps of 16 rows own kRows rows and
// stream the other operand kTile rows at a time. fp32 at d 64 (the
// training path) takes 8 warps and 64-row tiles, the largest that fit
// (fewer barriers and splits a product: faster there on an H100 than 4
// warps and 32-row tiles, which bf16 runs fastest at); d 128 takes
// 16-row tiles. Shared memory: the block's own rows of two operands (fp32, rows
// padded to kLd), the ring (kStages x two [kTile][D] tiles in the inputs'
// dtype, then kStages x two [kTile] fp32 vectors), the planes (two
// operands x kPlanes x [kTile][kLd] fp32) and the current tile's two
// vectors. contrib/fmha.py `bwd_plan` mirrors it.
template <typename T, int D>
struct MmaLayout {
  static constexpr bool kSplit = sizeof(T) == 4;  // fp32 inputs: hi + lo
  static constexpr bool kWide = kSplit && D == 64;
  static constexpr int kWarps = kWide ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = 16 * kWarps;  // one m16 tile a warp
  static constexpr int kTile = kWide ? 64 : D <= 64 ? 32 : 16;
  static constexpr int kPlanes = kSplit ? 2 : 1;
  static constexpr int kLd = D + 4;
  static constexpr int kRing = kStages * 2 * kTile * D;       // T elements
  static constexpr int kRingVec = kStages * 2 * kTile;        // floats
  static constexpr int kPlane = kTile * kLd;                  // floats
  static constexpr int kBytes =
      4 * 2 * kRows * kLd + kRing * static_cast<int>(sizeof(T)) +
      4 * (kRingVec + 2 * kPlanes * kPlane + 2 * kTile);
  static_assert(kBytes <= 227 * 1024, "more shared memory than a block takes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared; src_bytes 0 fills them with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a (16 x 8, row) . b (8 x 8, col) in TF32, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b from the terms, smallest first: lo_a . hi_b, hi_a . lo_b,
// hi_a . hi_b. kALo / kBLo false: that operand has no lo term. b holds
// (hi0, hi1, lo0, lo1).
template <bool kALo, bool kBLo>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&b)[4]) {
  if constexpr (kALo) mma_tf32(c, alo, b[0], b[1]);
  if constexpr (kBLo) mma_tf32(c, ahi, b[2], b[3]);
  mma_tf32(c, ahi, b[0], b[1]);
}

// the A fragment (a0..a3) as TF32 terms: kSplit, hi = rna(a) and (kLo)
// lo = rna(a - hi); else a is exact in TF32 (a bf16 input) and is hi
template <bool kSplit, bool kLo>
__device__ __forceinline__ void a_frag(float a0, float a1, float a2, float a3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kSplit) {
      hi[i] = to_tf32(a[i]);
      lo[i] = kLo ? to_tf32(a[i] - __uint_as_float(hi[i])) : 0u;
    } else {
      hi[i] = __float_as_uint(a[i]);
      lo[i] = 0u;
    }
  }
}

// a B fragment from the planes: b0 at hi[o0], b1 at hi[o1], and (kLo)
// their lo terms one plane further (the second products, whose b0 and b1
// lie in two rows: ldmatrix cannot transpose 4-byte elements)
template <bool kLo>
__device__ __forceinline__ void b_frag(const float* hi, int plane, int o0,
                                       int o1, uint32_t (&b)[4]) {
  b[0] = __float_as_uint(hi[o0]);
  b[1] = __float_as_uint(hi[o1]);
  if constexpr (kLo) {
    b[2] = __float_as_uint(hi[plane + o0]);
    b[3] = __float_as_uint(hi[plane + o1]);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragment of rows [r0, r0 + 16) and columns [c, c + 8) of fp32 rows
// of LD floats; kLdsm: by one ldmatrix.x4, whose lane 4g + t receives row
// g, word t of each 8 x 4 block (faster for fp32 on an H100 than four
// 4-byte loads; bf16 inputs keep the 4-byte loads, which ran faster there)
template <int LD, bool kLdsm>
__device__ __forceinline__ void a_rows(const float* m, int r0, int c, int lane,
                                       float (&a)[4]) {
  if constexpr (kLdsm) {
    uint32_t r[4];
    ldsm_x4(r, m + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + c +
                   4 * (lane >> 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __uint_as_float(r[i]);
  } else {
    const float* p = m + (r0 + (lane >> 2)) * LD + c + (lane & 3);
    a[0] = p[0];
    a[1] = p[8 * LD];
    a[2] = p[4];
    a[3] = p[8 * LD + 4];
  }
}

// The B fragment of rows [r0, r0 + 8) (the mma's n) and columns [c, c +
// 8) (its k) of the planes: (hi0, hi1) and, kLo, (lo0, lo1) one plane
// further, by one ldmatrix.x4
template <int LD, bool kLo>
__device__ __forceinline__ void b_rows(const float* hi, int plane, int r0, int c,
                                       int lane, uint32_t (&b)[4]) {
  if constexpr (kLo) {
    ldsm_x4(b, hi + (lane >> 4) * plane + (r0 + (lane & 7)) * LD + c +
                   4 * ((lane >> 3) & 1));
  } else {
    const float* p = hi + (r0 + (lane >> 2)) * LD + c + (lane & 3);
    b[0] = __float_as_uint(p[0]);
    b[1] = __float_as_uint(p[4]);
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows [r0, r0 + ROWS) of a [s, D] matrix as fp32 rows of D + 4 (0 past
// s), read 16 bytes (fp32) or 8 (bf16) a thread, NT threads
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_block_rows(float* dst, const T* __restrict__ src,
                                                int r0, int s) {
  constexpr int LD = D + 4;
  for (int c = threadIdx.x; c < ROWS * D / 4; c += NT) {
    const int r = c / (D / 4), col = c % (D / 4) * 4;
    const int row = r0 + r;
    const float4 x = row < s ? load4(src + static_cast<long long>(row) * D + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LD + col) = x;
  }
}

// one ring stage: rows [r0, r0 + R) of two [s, D] matrices a and b ([R][D]
// each, in T, rows LDT apart) and, with vectors, of two [s] fp32 vectors x
// and y, copied asynchronously by NT threads; rows past s are zero-filled
template <typename T, int D, int R, int NT, int LDT = D>
__device__ __forceinline__ void load_stage(T* tiles, float* vecs, const T* a,
                                           const T* b, const float* x,
                                           const float* y, int r0, int s) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T)), kPerRow = D / kVec;
  for (int c = threadIdx.x; c < R * kPerRow; c += NT) {
    const int r = c / kPerRow, col = c % kPerRow * kVec;
    const bool ok = r0 + r < s;
    const long long off = static_cast<long long>(ok ? r0 + r : 0) * D + col;
    cp_async16(tiles + r * LDT + col, a + off, ok ? 16 : 0);
    cp_async16(tiles + (R + r) * LDT + col, b + off, ok ? 16 : 0);
  }
  if (x == nullptr) return;
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool ok = r0 + r < s;
    cp_async4(vecs + r, x + (ok ? r0 + r : 0), ok ? 4 : 0);
    cp_async4(vecs + R + r, y + (ok ? r0 + r : 0), ok ? 4 : 0);
  }
}

// a landed stage's two [R][D] tiles into the planes: for fp32 input hi =
// rna_tf32(x) and lo = rna_tf32(x - hi), each once for every warp that
// reads it; bf16 input is exact in TF32 and fills the hi plane only.
// Plane order: a hi, (a lo), b hi, (b lo), each [R][D + 4]; NT threads.
template <typename T, int D, int R, int NT>
__device__ __forceinline__ void split_stage(float* planes, const T* tiles) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kPlanes = kSplit ? 2 : 1, LD = D + 4, kQuads = R * D / 4;
  for (int c = threadIdx.x; c < 2 * kQuads; c += NT) {
    const int m = c / kQuads, idx = c % kQuads;
    const int r = idx / (D / 4), col = idx % (D / 4) * 4;
    const float4 x = load4(tiles + (m * R + r) * D + col);
    float* hi = planes + (m * kPlanes * R + r) * LD + col;
    if constexpr (kSplit) {
      const uint32_t h0 = to_tf32(x.x), h1 = to_tf32(x.y), h2 = to_tf32(x.z),
                     h3 = to_tf32(x.w);
      *reinterpret_cast<uint4*>(hi) = make_uint4(h0, h1, h2, h3);
      *reinterpret_cast<uint4*>(hi + R * LD) = make_uint4(
          to_tf32(x.x - __uint_as_float(h0)), to_tf32(x.y - __uint_as_float(h1)),
          to_tf32(x.z - __uint_as_float(h2)), to_tf32(x.w - __uint_as_float(h3)));
    } else {
      *reinterpret_cast<float4*>(hi) = x;
    }
  }
}

// which pairs of queries [qa, qb] x keys [ka, kb] are visible: none, some
// or all (conservative: "some" may hold none or all)
__device__ __forceinline__ int band(int qa, int qb, int ka, int kb, int s,
                                    int causal, int window) {
  if (qa >= s || ka >= s) return kNoPair;
  if (causal && (ka > qb || (window > 0 && qa - kb >= window))) return kNoPair;
  const bool all = qb < s && kb < s &&
                   (!causal || (kb <= qa && (window <= 0 || qb - ka < window)));
  return all ? kAllPairs : kSomePairs;
}

// the number of tiles of R rows from `begin` to `end`, less the last one
// when the SkipLast fault is planted in a causal launch
template <int kFault>
__device__ __forceinline__ int tile_count(int begin, int end, int R, int causal) {
  const int n = end > begin ? (end - begin + R - 1) / R : 0;
  return kFault == kFaultSkipLast && causal && n > 0 ? n - 1 : n;
}

// ----------------------------------------------------------- dq, mma body

template <typename T, int D, int kFault>
__global__ void __launch_bounds__(MmaLayout<T, D>::kThreads)
mma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ slopes, T* __restrict__ dq, int heads,
              int s, float scale, int causal, int window) {
  using L = MmaLayout<T, D>;
  constexpr int R = L::kTile, LD = L::kLd, PL = L::kPlane;
  constexpr int ROWS = L::kRows, NT = L::kThreads;
  constexpr bool kLo = kFault != kFaultNoLo;       // p, ds take lo terms
  constexpr bool kInLo = L::kSplit && kLo;         // so do q, k, v, do
  extern __shared__ __align__(16) float mma_smem[];
  float* q_s = mma_smem;                            // [ROWS][LD]
  float* do_s = q_s + ROWS * LD;                    // [ROWS][LD]
  T* ring = reinterpret_cast<T*>(do_s + ROWS * LD);
  float* planes = reinterpret_cast<float*>(ring + L::kRing) + L::kRingVec;
  const float* k_hi = planes;                       // K hi, (lo), V hi, (lo)
  const float* v_hi = planes + L::kPlanes * PL;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest first
  const long long base = static_cast<long long>(bh) * s * D;
  const long long row_base = static_cast<long long>(bh) * s;
  const float slope = slopes != nullptr ? slopes[bh % heads] : 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = 16 * warp;      // the warp's first row in the block
  const int row_lo = q0 + qr;

  int k_begin = 0, k_end = s;
  if (causal) {
    k_end = min(s, q0 + ROWS);
    if (window > 0) k_begin = max(q0 - window + 1, 0) / R * R;
  }
  const int tiles = tile_count<kFault>(k_begin, k_end, R, causal);
  for (int st = 0; st < kStages; ++st) {
    if (st < tiles)
      load_stage<T, D, R, NT>(ring + st * 2 * R * D, nullptr, k + base, v + base,
                          nullptr, nullptr, k_begin + st * R, s);
    cp_async_commit();
  }
  load_block_rows<T, D, ROWS, NT>(q_s, q + base, q0, s);
  load_block_rows<T, D, ROWS, NT>(do_s, dout + base, q0, s);
  float lse_r[2], delta_r[2];  // rows g and g + 8 of the warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + g + 8 * h;
    lse_r[h] = row < s ? lse[row_base + row] : 0.f;
    delta_r[h] = row < s ? delta[row_base + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = k_begin + it * R, st = it % kStages;
    cp_async_wait<kStages - 1>();
    __syncthreads();  // the tile landed; the planes of the last one consumed
    split_stage<T, D, R, NT>(planes, ring + st * 2 * R * D);
    __syncthreads();  // the planes written; the stage free
    if (it + kStages < tiles)
      load_stage<T, D, R, NT>(ring + st * 2 * R * D, nullptr, k + base, v + base,
                          nullptr, nullptr, k0 + kStages * R, s);
    cp_async_commit();

    const int vis = band(row_lo, row_lo + 15, k0, k0 + R - 1, s, causal, window);
    if (vis == kNoPair) continue;
    // S = Q . K^T and dP = dO . V^T: the warp's 16 rows x R keys
    float sc[R / 8][4], dp[R / 8][4];
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float qa[4], oa[4];
      a_rows<LD, kInLo>(q_s, qr, 8 * kk, lane, qa);
      a_rows<LD, kInLo>(do_s, qr, 8 * kk, lane, oa);
      uint32_t qh[4], ql[4], oh[4], ol[4];
      a_frag<L::kSplit, kLo>(qa[0], qa[1], qa[2], qa[3], qh, ql);
      a_frag<L::kSplit, kLo>(oa[0], oa[1], oa[2], oa[3], oh, ol);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        uint32_t b[4];
        b_rows<LD, kInLo>(k_hi, PL, 8 * j, 8 * kk, lane, b);
        mma3<kInLo, kInLo>(sc[j], qh, ql, b);
        b_rows<LD, kInLo>(v_hi, PL, 8 * j, 8 * kk, lane, b);
        mma3<kInLo, kInLo>(dp[j], oh, ol, b);
      }
    }
    // P and dS in the accumulator fragment: row g + 8 (e >> 1), key 8j +
    // 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = sc[j][e] * scale;
        if (slopes != nullptr) x += slope * static_cast<float>(key);
        if (vis != kAllPairs && !visible(row, key, s, causal, window)) x = kNegInf;
        const float p = expf(x - lse_r[e >> 1]);
        dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
      }
    // dQ += dS . K: k step j sums keys 8j..8j+7, keys 8j + 2t and 8j + 2t +
    // 1 in k columns t and t + 4, so dS's accumulator is its A fragment
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      uint32_t sh[4], sl[4];
      a_frag<true, kLo>(dp[j][0], dp[j][2], dp[j][1], dp[j][3], sh, sl);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int o = (8 * j + 2 * t) * LD + 8 * n + g;
        uint32_t b[4];
        b_frag<kInLo>(k_hi, PL, o, o + LD, b);
        mma3<kLo, kInLo>(acc[n], sh, sl, b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + g + 8 * h;
    if (row >= s) continue;
    T* out = dq + base + static_cast<long long>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + 8 * n, acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// ------------------------------------------------------- dk, dv, mma body

template <typename T, int D, int kFault>
__global__ void __launch_bounds__(MmaLayout<T, D>::kThreads)
mma_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ slopes, T* __restrict__ dk,
               T* __restrict__ dv, int heads, int s, float scale, int causal,
               int window) {
  using L = MmaLayout<T, D>;
  constexpr int R = L::kTile, LD = L::kLd, PL = L::kPlane;
  constexpr int ROWS = L::kRows, NT = L::kThreads;
  constexpr bool kLo = kFault != kFaultNoLo;
  constexpr bool kInLo = L::kSplit && kLo;
  extern __shared__ __align__(16) float mma_smem[];
  float* k_s = mma_smem;                            // [ROWS][LD]
  float* v_s = k_s + ROWS * LD;                     // [ROWS][LD]
  T* ring = reinterpret_cast<T*>(v_s + ROWS * LD);
  float* ring_vec = reinterpret_cast<float*>(ring + L::kRing);
  float* planes = ring_vec + L::kRingVec;
  const float* q_hi = planes;                       // Q hi, (lo), dO hi, (lo)
  const float* o_hi = planes + L::kPlanes * PL;
  float* lse_s = planes + 2 * L::kPlanes * PL;      // [R]
  float* delta_s = lse_s + R;                       // [R]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * ROWS;  // causal: the first key tiles are longest
  const long long base = static_cast<long long>(bh) * s * D;
  const long long row_base = static_cast<long long>(bh) * s;
  const float slope = slopes != nullptr ? slopes[bh % heads] : 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp;      // the warp's first key in the block
  const int key_lo = k0 + kr;

  // the query tiles that see a key of this block
  int q_begin = 0, q_end = s;
  if (causal) {
    q_begin = k0;  // a multiple of R
    if (window > 0) q_end = min(s, k0 + ROWS - 1 + window);
  }
  const int tiles = tile_count<kFault>(q_begin, q_end, R, causal);
  for (int st = 0; st < kStages; ++st) {
    if (st < tiles)
      load_stage<T, D, R, NT>(ring + st * 2 * R * D, ring_vec + st * 2 * R,
                          q + base, dout + base, lse + row_base,
                          delta + row_base, q_begin + st * R, s);
    cp_async_commit();
  }
  load_block_rows<T, D, ROWS, NT>(k_s, k + base, k0, s);
  load_block_rows<T, D, ROWS, NT>(v_s, v + base, k0, s);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int q0 = q_begin + it * R, st = it % kStages;
    cp_async_wait<kStages - 1>();
    __syncthreads();  // the tile landed; the planes of the last one consumed
    split_stage<T, D, R, NT>(planes, ring + st * 2 * R * D);
    for (int r = threadIdx.x; r < R; r += NT) {
      lse_s[r] = ring_vec[st * 2 * R + r];
      delta_s[r] = ring_vec[st * 2 * R + R + r];
    }
    __syncthreads();  // the planes written; the stage free
    if (it + kStages < tiles)
      load_stage<T, D, R, NT>(ring + st * 2 * R * D, ring_vec + st * 2 * R,
                          q + base, dout + base, lse + row_base,
                          delta + row_base, q0 + kStages * R, s);
    cp_async_commit();

    const int vis = band(q0, q0 + R - 1, key_lo, key_lo + 15, s, causal, window);
    if (vis == kNoPair) continue;
    // S^T = K . Q^T and dP^T = V . dO^T: the warp's 16 keys x R queries
    float sc[R / 8][4], dp[R / 8][4];
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float ka[4], va[4];
      a_rows<LD, kInLo>(k_s, kr, 8 * kk, lane, ka);
      a_rows<LD, kInLo>(v_s, kr, 8 * kk, lane, va);
      uint32_t kh[4], kl[4], vh[4], vl[4];
      a_frag<L::kSplit, kLo>(ka[0], ka[1], ka[2], ka[3], kh, kl);
      a_frag<L::kSplit, kLo>(va[0], va[1], va[2], va[3], vh, vl);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        uint32_t b[4];
        b_rows<LD, kInLo>(q_hi, PL, 8 * j, 8 * kk, lane, b);
        mma3<kInLo, kInLo>(sc[j], kh, kl, b);
        b_rows<LD, kInLo>(o_hi, PL, 8 * j, 8 * kk, lane, b);
        mma3<kInLo, kInLo>(dp[j], vh, vl, b);
      }
    }
    // P^T and dS^T in the accumulator fragment: key g + 8 (e >> 1), query
    // 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + g + 8 * (e >> 1);
        const int col = 8 * j + 2 * t + (e & 1);
        float x = sc[j][e] * scale;
        if (slopes != nullptr) x += slope * static_cast<float>(key);
        if (vis != kAllPairs && !visible(q0 + col, key, s, causal, window)) x = kNegInf;
        const float p = expf(x - lse_s[col]);
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[col]);
      }
    // dV += P^T . dO and dK += dS^T . Q: k step j sums queries 8j..8j+7,
    // queries 8j + 2t and 8j + 2t + 1 in k columns t and t + 4
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      a_frag<true, kLo>(sc[j][0], sc[j][2], sc[j][1], sc[j][3], ph, pl);
      a_frag<true, kLo>(dp[j][0], dp[j][2], dp[j][1], dp[j][3], sh, sl);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int o = (8 * j + 2 * t) * LD + 8 * n + g;
        uint32_t b[4];
        b_frag<kInLo>(o_hi, PL, o, o + LD, b);
        mma3<kLo, kInLo>(dv_acc[n], ph, pl, b);
        b_frag<kInLo>(q_hi, PL, o, o + LD, b);
        mma3<kLo, kInLo>(dk_acc[n], sh, sl, b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + g + 8 * h;
    if (key >= s) continue;
    T* krow = dk + base + static_cast<long long>(key) * D + 2 * t;
    T* vrow = dv + base + static_cast<long long>(key) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(krow + 8 * n, dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      store2(vrow + 8 * n, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ------------------------------------------ forward on the tensor cores

// The forward's block: kWarps warps of 16 query rows own kRows rows and
// stream K and V kTile keys at a time through kStages cp.async stages in
// the inputs' dtype, rows padded by 16 bytes (kLdT), so that the fragment
// reads and the split pass below read shared memory without bank
// conflicts. fp32 inputs (3xTF32 on m16n8k8): each landed tile is split
// once into K hi/lo planes ([kTile][D + 4]) and V^T hi/lo planes ([D][kTile
// + 8]); the block's Q rows stay in shared memory as fp32 ([kRows][D + 4])
// and each k step splits what it reads. bf16 inputs (m16n8k16): the warps
// read the landed tiles as they lie, and Q * scale is held in registers
// as bf16 terms. The numbers are the fastest of a sweep on an H100 (PERF.md
// section 6): fp32 Q's split fragments held in registers took so many
// registers that one 8-warp block held an SM, and ran slower than Q in
// shared memory, where two blocks share an SM. contrib/fmha.py `fwd_plan`
// mirrors it.
template <typename T, int D>
struct FwdLayout {
  static constexpr bool kSplit = sizeof(T) == 4;
  static constexpr int kWarps = kSplit && D == 64 ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kTile = 32;
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kLdT = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kLd = D + 4;
  static constexpr int kLdV = kTile + 8;
  static constexpr int kStage = 2 * kTile * kLdT;  // T elements: K, V
  static constexpr int kPlanes = kSplit ? 2 * kTile * kLd + 2 * D * kLdV : 0;
  static constexpr int kQ = kSplit ? kRows * kLd : 0;
  static constexpr int kBytes =
      kStages * kStage * static_cast<int>(sizeof(T)) + 4 * (kPlanes + kQ);
  static_assert(kBytes <= 227 * 1024, "more shared memory than a block takes");
};

// the online softmax of one key tile on the accumulator fragment (row g +
// 8h in elements 2h and 2h + 1, key k0 + 8j + 2t + (e & 1)), in the TPU
// kernel's order: ALiBi after the product, masked scores -1e30, m_new =
// max(m, row max), p = exp(s - m_new), alpha = exp(m - m_new), l = alpha
// l + row sum(p), acc *= alpha; sc becomes p. A row's max and sum are
// over the 4 lanes of its quad. A row whose visited tiles so far hold no
// visible key keeps m = -1e30 and sums p = 1 over them; its first visible
// key's alpha = exp(-1e30 - m_new) = 0 wipes that, as in the TPU kernel.
template <int R, int D>
__device__ __forceinline__ void online_softmax(
    float (&sc)[R / 8][4], float (&m)[2], float (&l)[2],
    float (&acc)[D / 8][4], int row_lo, int k0, int g, int t, int vis, int s,
    int causal, int window, const float* slopes, float slope) {
  if (slopes != nullptr || vis != kAllPairs) {
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = sc[j][e];
        if (slopes != nullptr) x += slope * static_cast<float>(key);
        if (vis != kAllPairs && !visible(row, key, s, causal, window)) x = kNegInf;
        sc[j][e] = x;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < R / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = expf(sc[j][e] - m_new);
        sc[j][e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m[h] - m_new);
    l[h] = alpha * l[h] + sum;
    m[h] = m_new;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][2 * h] *= alpha;
      acc[n][2 * h + 1] *= alpha;
    }
  }
}

// o = acc / max(l, 1e-30) in T and lse = m + log(max(l, 1e-30)) for the
// lane's rows g and g + 8 (columns 8n + 2t, 2t + 1); rows past s write
// nothing
template <typename T, int D>
__device__ __forceinline__ void store_fwd(T* __restrict__ o, float* __restrict__ lse,
                                          const float (&acc)[D / 8][4],
                                          const float (&m)[2], const float (&l)[2],
                                          long long base, long long row_base,
                                          int row_lo, int g, int t, int s) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + g + 8 * h;
    if (row >= s) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    T* out = o + base + static_cast<long long>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + 8 * n, acc[n][2 * h] / lc, acc[n][2 * h + 1] / lc);
    if (t == 0) lse[row_base + row] = m[h] + logf(lc);
  }
}

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  hi = make_uint4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
  lo = make_uint4(to_tf32(x.x - __uint_as_float(hi.x)),
                  to_tf32(x.y - __uint_as_float(hi.y)),
                  to_tf32(x.z - __uint_as_float(hi.z)),
                  to_tf32(x.w - __uint_as_float(hi.w)));
}

// a landed fp32 stage (K, V: [kTile][kLdT] each) into the planes: K hi
// and lo as rows, V hi and lo transposed, so that a B fragment of P . V
// (keys 2t and 2t + 1 of a k step at one head column) is one 8-byte read.
// Consecutive threads take consecutive rows: conflict-free stage reads and
// V^T writes.
template <int D>
__device__ __forceinline__ void split_kv(float* planes, const float* stage) {
  using L = FwdLayout<float, D>;
  constexpr int R = L::kTile, LD = L::kLd, LT = L::kLdT, LV = L::kLdV;
  float* k_hi = planes;
  float* vt_hi = planes + 2 * R * LD;
  for (int c = threadIdx.x; c < R * D / 4; c += L::kThreads) {
    const int r = c % R, col = c / R * 4;
    uint4 hi, lo;
    split4(load4(stage + r * LT + col), hi, lo);
    *reinterpret_cast<uint4*>(k_hi + r * LD + col) = hi;
    *reinterpret_cast<uint4*>(k_hi + (R + r) * LD + col) = lo;
    split4(load4(stage + (R + r) * LT + col), hi, lo);
    const uint32_t h4[4] = {hi.x, hi.y, hi.z, hi.w}, l4[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vt_hi[(col + i) * LV + r] = __uint_as_float(h4[i]);
      vt_hi[(D + col + i) * LV + r] = __uint_as_float(l4[i]);
    }
  }
}

// The forward for fp32 inputs: products as three TF32 terms (kFault as
// the backward's: the lo terms dropped, or a causal range's last key tile
// skipped)
template <int D, int kFault>
__global__ void __launch_bounds__(FwdLayout<float, D>::kThreads)
mma_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ slopes,
               float* __restrict__ o, float* __restrict__ lse, int heads, int s,
               float scale, int causal, int window) {
  using L = FwdLayout<float, D>;
  constexpr int R = L::kTile, LD = L::kLd, LV = L::kLdV;
  constexpr int ROWS = L::kRows, NT = L::kThreads, NS = L::kStages;
  constexpr bool kLo = kFault != kFaultNoLo;
  extern __shared__ __align__(16) float mma_smem[];
  float* ring = mma_smem;                        // NS x (K, V) [R][kLdT]
  float* planes = ring + NS * L::kStage;         // K hi, lo; V^T hi, lo
  float* q_s = planes + L::kPlanes;              // Q [ROWS][LD]
  const float* k_hi = planes;
  const float* vt_hi = planes + 2 * R * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest first
  const long long base = static_cast<long long>(bh) * s * D;
  const float slope = slopes != nullptr ? slopes[bh % heads] : 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = 16 * warp;  // the warp's first row in the block
  const int row_lo = q0 + qr;

  int k_begin = 0, k_end = s;
  if (causal) {
    k_end = min(s, q0 + ROWS);
    if (window > 0) k_begin = max(q0 - window + 1, 0) / R * R;
  }
  const int tiles = tile_count<kFault>(k_begin, k_end, R, causal);
  for (int st = 0; st < NS; ++st) {
    if (st < tiles)
      load_stage<float, D, R, NT, L::kLdT>(ring + st * L::kStage, nullptr, k + base,
                                           v + base, nullptr, nullptr,
                                           k_begin + st * R, s);
    cp_async_commit();
  }
  load_block_rows<float, D, ROWS, NT>(q_s, q + base, q0, s);

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = k_begin + it * R, st = it % NS;
    cp_async_wait<NS - 1>();
    __syncthreads();  // the tile landed (and Q's rows); the planes consumed
    split_kv<D>(planes, ring + st * L::kStage);
    __syncthreads();  // the planes written; the stage free
    if (it + NS < tiles)
      load_stage<float, D, R, NT, L::kLdT>(ring + st * L::kStage, nullptr, k + base,
                                           v + base, nullptr, nullptr,
                                           k0 + NS * R, s);
    cp_async_commit();

    const int vis = band(row_lo, row_lo + 15, k0, k0 + R - 1, s, causal, window);
    if (vis == kNoPair) continue;
    // S = (Q * scale) . K^T: the warp's 16 rows x R keys
    float sc[R / 8][4];
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      // Q * scale (JAX's order: the scale before the product), split
      float a[4];
      uint32_t ah[4], al[4];
      a_rows<LD, kLo>(q_s, qr, 8 * kk, lane, a);
      a_frag<true, kLo>(a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale,
                        ah, al);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        uint32_t b[4];
        b_rows<LD, kLo>(k_hi, R * LD, 8 * j, 8 * kk, lane, b);
        mma3<kLo, kLo>(sc[j], ah, al, b);
      }
    }
    online_softmax<R, D>(sc, m_r, l_r, acc, row_lo, k0, g, t, vis, s, causal,
                         window, slopes, slope);
    // O += P . V: k step j sums keys 8j..8j+7, keys 8j + 2t and 8j + 2t + 1
    // in k columns t and t + 4, so P's accumulator is its A fragment and
    // the B fragment is V^T's two neighbours
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      uint32_t ph[4], pl[4];
      a_frag<true, kLo>(sc[j][0], sc[j][2], sc[j][1], sc[j][3], ph, pl);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float* p = vt_hi + (8 * n + g) * LV + 8 * j + 2 * t;
        const float2 hi = *reinterpret_cast<const float2*>(p);
        uint32_t b[4] = {__float_as_uint(hi.x), __float_as_uint(hi.y), 0u, 0u};
        if constexpr (kLo) {
          const float2 lo = *reinterpret_cast<const float2*>(p + D * LV);
          b[2] = __float_as_uint(lo.x);
          b[3] = __float_as_uint(lo.y);
        }
        mma3<kLo, kLo>(acc[n], ph, pl, b);
      }
    }
  }
  cp_async_wait<0>();
  store_fwd<float, D>(o, lse, acc, m_r, l_r, base, static_cast<long long>(bh) * s,
                      row_lo, g, t, s);
}

// The forward for bf16 inputs: m16n8k16 bf16 products with fp32
// accumulation. k and v are bf16 and exact; Q * scale is kQTerms bf16
// terms (1 where the scale is a power of two and the product is exact in
// bf16, else 3: hi, mid, lo as split3); p is fp32 and always three terms.
// Terms are summed smallest first. One barrier a tile: the warps read the
// landed stage as it lies, and the copy into the stage of the tile before
// starts after that barrier.
template <int D, int kQTerms>
__global__ void __launch_bounds__(FwdLayout<__nv_bfloat16, D>::kThreads)
bf16_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ slopes, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int heads, int s, float scale,
                int causal, int window) {
  using bf16 = __nv_bfloat16;
  using L = FwdLayout<bf16, D>;
  constexpr int R = L::kTile, LT = L::kLdT;
  constexpr int ROWS = L::kRows, NT = L::kThreads, NS = L::kStages;
  extern __shared__ __align__(16) float mma_smem[];
  bf16* ring = reinterpret_cast<bf16*>(mma_smem);  // NS x (K, V) [R][LT]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest first
  const long long base = static_cast<long long>(bh) * s * D;
  const float slope = slopes != nullptr ? slopes[bh % heads] : 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + 16 * warp;

  int k_begin = 0, k_end = s;
  if (causal) {
    k_end = min(s, q0 + ROWS);
    if (window > 0) k_begin = max(q0 - window + 1, 0) / R * R;
  }
  const int tiles = tile_count<0>(k_begin, k_end, R, causal);
  for (int st = 0; st < NS - 1; ++st) {
    if (st < tiles)
      load_stage<bf16, D, R, NT, LT>(ring + st * L::kStage, nullptr, k + base,
                                     v + base, nullptr, nullptr,
                                     k_begin + st * R, s);
    cp_async_commit();
  }
  // Q * scale as bf16 terms: A fragments of m16n8k16, register f holding
  // row g + 8 (f & 1), columns 2t + 8 (f >> 1) and the next of each 16
  uint32_t qf[kQTerms][D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = row_lo + g + 8 * (f & 1);
      float x0 = 0.f, x1 = 0.f;
      if (row < s) {
        const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(
            q + base + static_cast<long long>(row) * D + 16 * kk + 2 * t + 8 * (f >> 1));
        x0 = __low2float(pair) * scale;
        x1 = __high2float(pair) * scale;
      }
      uint32_t hi, mid, lo;
      apex_kv::split_bf16(x0, x1, hi, mid, lo);
      qf[0][kk][f] = hi;
      if constexpr (kQTerms == 3) {
        qf[1][kk][f] = mid;
        qf[2][kk][f] = lo;
      }
    }

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // ldmatrix rows: K's matrices keys 0-7 / 8-15 of a 16-key step (m >> 1)
  // at dims +0 / +8 (m & 1); V's, transposed, the other way round
  const int mtx = lane >> 3;
  const int k_off = (((mtx >> 1) << 3) + (lane & 7)) * LT + ((mtx & 1) << 3);
  const int v_off = (((mtx & 1) << 3) + (lane & 7)) * LT + ((mtx >> 1) << 3);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = k_begin + it * R;
    cp_async_wait<NS - 2>();
    __syncthreads();  // the tile landed; the tile before it consumed
    if (it + NS - 1 < tiles)
      load_stage<bf16, D, R, NT, LT>(ring + (it + NS - 1) % NS * L::kStage, nullptr,
                                     k + base, v + base, nullptr, nullptr,
                                     k0 + (NS - 1) * R, s);
    cp_async_commit();
    const bf16* ks = ring + it % NS * L::kStage;
    const bf16* vs = ks + R * LT;

    const int vis = band(row_lo, row_lo + 15, k0, k0 + R - 1, s, causal, window);
    if (vis == kNoPair) continue;
    float sc[R / 8][4];
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < R / 16; ++jj) {
        uint32_t b[4];
        apex_kv::ldmatrix_x4(b, ks + k_off + jj * 16 * LT + kk * 16);
#pragma unroll
        for (int u = kQTerms - 1; u >= 0; --u) {
          apex_kv::mma_bf16(sc[2 * jj], qf[u][kk], b[0], b[1]);
          apex_kv::mma_bf16(sc[2 * jj + 1], qf[u][kk], b[2], b[3]);
        }
      }
    online_softmax<R, D>(sc, m_r, l_r, acc, row_lo, k0, g, t, vis, s, causal,
                         window, slopes, slope);
    // O += P . V, P as three bf16 terms (its accumulator is the A fragment)
#pragma unroll
    for (int jj = 0; jj < R / 16; ++jj) {
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        apex_kv::split_bf16(sc[2 * jj + (f >> 1)][2 * (f & 1)],
                            sc[2 * jj + (f >> 1)][2 * (f & 1) + 1], hi[f], mid[f],
                            lo[f]);
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t b[4];
        apex_kv::ldmatrix_x4_trans(b, vs + v_off + jj * 16 * LT + dc * 16);
        apex_kv::mma_bf16(acc[2 * dc], lo, b[0], b[1]);
        apex_kv::mma_bf16(acc[2 * dc + 1], lo, b[2], b[3]);
        apex_kv::mma_bf16(acc[2 * dc], mid, b[0], b[1]);
        apex_kv::mma_bf16(acc[2 * dc + 1], mid, b[2], b[3]);
        apex_kv::mma_bf16(acc[2 * dc], hi, b[0], b[1]);
        apex_kv::mma_bf16(acc[2 * dc + 1], hi, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  store_fwd<bf16, D>(o, lse, acc, m_r, l_r, base, static_cast<long long>(bh) * s,
                     row_lo, g, t, s);
}

// ------------------------------------------------------------- launches

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int D>
dim3 grid_of(int bh, int s) {
  return dim3(bh, (s + Tile<D>::kB - 1) / Tile<D>::kB);
}

template <int D>
size_t bwd_smem() {
  using TL = Tile<D>;
  return sizeof(float) * (4 * TL::kB * TL::kLd + TL::kB * TL::kLp + 2 * TL::kB);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int D, int kFault>
int launch_mma_fwd(const T* q, const T* k, const T* v, const float* slopes, T* o,
                   float* lse, int bh, int heads, int s, float scale, int causal,
                   int window, cudaStream_t stream) {
  using L = FwdLayout<T, D>;
  const dim3 grid(bh, (s + L::kRows - 1) / L::kRows);
  if constexpr (L::kSplit) {
    const int err = prepare(mma_fwd_kernel<D, kFault>, L::kBytes);
    if (err) return err;
    mma_fwd_kernel<D, kFault><<<grid, L::kThreads, L::kBytes, stream>>>(
        q, k, v, slopes, o, lse, heads, s, scale, causal, window);
  } else {
    static_assert(kFault == 0, "the planted faults are fp32's");
    int e2;
    const bool exact = std::frexp(scale, &e2) == 0.5f;  // a power of two
    auto kernel = exact ? bf16_fwd_kernel<D, 1> : bf16_fwd_kernel<D, 3>;
    const int err = prepare(kernel, L::kBytes);
    if (err) return err;
    kernel<<<grid, L::kThreads, L::kBytes, stream>>>(q, k, v, slopes, o, lse, heads,
                                                     s, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int kFault>
int launch_mma_dq(const T* q, const T* k, const T* v, const T* dout,
                  const float* lse, const float* delta, const float* slopes,
                  T* dq, int bh, int heads, int s, float scale, int causal,
                  int window, cudaStream_t stream) {
  using L = MmaLayout<T, D>;
  constexpr int smem = L::kBytes;
  const int err = prepare(mma_dq_kernel<T, D, kFault>, smem);
  if (err) return err;
  mma_dq_kernel<T, D, kFault>
      <<<dim3(bh, (s + L::kRows - 1) / L::kRows), L::kThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, slopes, dq, heads, s, scale, causal,
          window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int kFault>
int launch_mma_dkv(const T* q, const T* k, const T* v, const T* dout,
                   const float* lse, const float* delta, const float* slopes,
                   T* dk, T* dv, int bh, int heads, int s, float scale,
                   int causal, int window, cudaStream_t stream) {
  using L = MmaLayout<T, D>;
  constexpr int smem = L::kBytes;
  const int err = prepare(mma_dkv_kernel<T, D, kFault>, smem);
  if (err) return err;
  mma_dkv_kernel<T, D, kFault>
      <<<dim3(bh, (s + L::kRows - 1) / L::kRows), L::kThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, slopes, dk, dv, heads, s, scale, causal,
          window);
  return static_cast<int>(cudaGetLastError());
}

// path: kPathSimt (any d), kPathMma (d 64 and 128, every operand 16-byte
// aligned) or a planted fault (fp32, d 64); -1 where the path does not fit
#define APEX_FLASH_MMA_PATHS(LAUNCH, ...)                                     \
  do {                                                                        \
    if constexpr (D <= 128) {                                                 \
      if (path == kPathMma) return LAUNCH<T, D, 0>(__VA_ARGS__);              \
      if constexpr (std::is_same<T, float>::value && D == 64) {               \
        if (path == kFaultNoLo) return LAUNCH<T, D, kFaultNoLo>(__VA_ARGS__); \
        if (path == kFaultSkipLast)                                           \
          return LAUNCH<T, D, kFaultSkipLast>(__VA_ARGS__);                   \
      }                                                                       \
    }                                                                         \
    return -1;                                                                \
  } while (0)

template <typename T, int D>
int launch_fwd(int path, const void* q, const void* k, const void* v,
               const float* slopes, void* o, float* lse, int bh, int heads,
               int s, float scale, int causal, int window, cudaStream_t stream) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* out = static_cast<T*>(o);
  if (path == kPathSimt) {
    using TL = Tile<D>;
    const size_t smem = sizeof(float) * (2 * TL::kB * TL::kLd + TL::kB * TL::kLp);
    const int err = prepare(fwd_kernel<T, D>, smem);
    if (err) return err;
    fwd_kernel<T, D><<<grid_of<D>(bh, s), kThreads, smem, stream>>>(
        tq, tk, tv, slopes, out, lse, heads, s, scale, causal, window);
    return static_cast<int>(cudaGetLastError());
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) return -1;
  APEX_FLASH_MMA_PATHS(launch_mma_fwd, tq, tk, tv, slopes, out, lse, bh, heads, s,
                       scale, causal, window, stream);
}

template <typename T, int D>
int launch_dq(int path, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              const float* slopes, void* dq, int bh, int heads, int s,
              float scale, int causal, int window, cudaStream_t stream) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k);
  const T *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
  T* out = static_cast<T*>(dq);
  if (path == kPathSimt) {
    const size_t smem = bwd_smem<D>();
    const int err = prepare(dq_kernel<T, D>, smem);
    if (err) return err;
    dq_kernel<T, D><<<grid_of<D>(bh, s), kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, slopes, out, heads, s, scale, causal,
        window);
    return static_cast<int>(cudaGetLastError());
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return -1;
  APEX_FLASH_MMA_PATHS(launch_mma_dq, tq, tk, tv, tdo, lse, delta, slopes, out,
                       bh, heads, s, scale, causal, window, stream);
}

template <typename T, int D>
int launch_dkv(int path, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const float* slopes, void* dk, void* dv, int bh, int heads,
               int s, float scale, int causal, int window, cudaStream_t stream) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k);
  const T *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
  T *tdk = static_cast<T*>(dk), *tdv = static_cast<T*>(dv);
  if (path == kPathSimt) {
    const size_t smem = bwd_smem<D>();
    const int err = prepare(dkv_kernel<T, D>, smem);
    if (err) return err;
    dkv_kernel<T, D><<<grid_of<D>(bh, s), kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, slopes, tdk, tdv, heads, s, scale, causal,
        window);
    return static_cast<int>(cudaGetLastError());
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dk) || !aligned16(dv))
    return -1;
  APEX_FLASH_MMA_PATHS(launch_mma_dkv, tq, tk, tv, tdo, lse, delta, slopes, tdk,
                       tdv, bh, heads, s, scale, causal, window, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; head dims 64, 128 and 256.
// Each returns the CUDA error of the launch (0 on success), -1 for a
// dtype, head dim or (backward) path the kernels do not take. window <=
// 0: no window; slopes null: no ALiBi.

#define APEX_FLASH_DISPATCH(LAUNCH, ...)                                     \
  do {                                                                       \
    if (bh <= 0 || s <= 0) return 0;                                         \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    if (dtype == 0 && d == 64) return LAUNCH<float, 64>(__VA_ARGS__, st);    \
    if (dtype == 0 && d == 128) return LAUNCH<float, 128>(__VA_ARGS__, st);  \
    if (dtype == 0 && d == 256) return LAUNCH<float, 256>(__VA_ARGS__, st);  \
    if (dtype == 1 && d == 64)                                               \
      return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__, st);                     \
    if (dtype == 1 && d == 128)                                              \
      return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__, st);                    \
    if (dtype == 1 && d == 256)                                              \
      return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__, st);                    \
    return -1;                                                               \
  } while (0)

// o [bh, s, d] in q's dtype and lse [bh, s] fp32. path: 0 the first
// design, 1 the tensor-core body (d 64 and 128, q, k, v and o 16-byte
// aligned), 2 and 3 planted faults (fp32, d 64); `fmha.fwd_plan` picks 0
// or 1.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const float* slopes, void* o, float* lse, int bh,
                              int heads, int s, int d, float scale, int causal,
                              int window, int dtype, int path, void* stream) {
  APEX_FLASH_DISPATCH(launch_fwd, path, q, k, v, slopes, o, lse, bh, heads, s,
                      scale, causal, window);
}

// dq [bh, s, d] in q's dtype. path: 0 the first design, 1 the tensor-core
// body (d 64 and 128, operands 16-byte aligned), 2 and 3 planted faults
// (fp32, d 64); `fmha.bwd_plan` picks 0 or 1.
extern "C" int apex_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* slopes, void* dq,
                             int bh, int heads, int s, int d, float scale,
                             int causal, int window, int dtype, int path,
                             void* stream) {
  APEX_FLASH_DISPATCH(launch_dq, path, q, k, v, dout, lse, delta, slopes, dq,
                      bh, heads, s, scale, causal, window);
}

// dk, dv [bh, s, d] in q's dtype; path as apex_flash_dq's.
extern "C" int apex_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const float* slopes, void* dk,
                              void* dv, int bh, int heads, int s, int d,
                              float scale, int causal, int window, int dtype,
                              int path, void* stream) {
  APEX_FLASH_DISPATCH(launch_dkv, path, q, k, v, dout, lse, delta, slopes, dk,
                      dv, bh, heads, s, scale, causal, window);
}
