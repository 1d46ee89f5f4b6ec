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
//            ds = p * (do . v^T - delta), dq += (ds . k) * scale.
//   dk, dv:  dv += p^T . do, dk += (ds^T . q) * scale.
// delta = rowsum(do * o) over the saved (rounded) o is the caller's.
// The scale multiplies q before the product in the forward and the
// product after it in the backward, as the TPU kernels do.
//
// Bound on the H100: operations. At the training step's shape (bh = 64,
// s = 2048, d = 64, causal: 1.34e8 live (i, j) pairs) the forward does
// 4d, dq 6d and dk/dv 8d operations per live pair (34.4, 51.6 and 68.7
// GFLOP) on ~135-200 MB. Both operands of q.k^T and do.v^T are exact in
// fp32, but p, ds and the accumulators are fp32, and the model's path
// hands the kernels fp32 q/k/v (the QKV bias add promotes to fp32), so
// every product here is fp32 FMA: 67 TFLOP/s at best (0.51 ms for the
// forward), not the 989 TFLOP/s of the bf16 tensor cores.
//
// Design (simple and exact first): one block of 256 threads (a 16 x 16
// grid) per (head, tile of B query rows) for the forward and dq, per
// (head, tile of B key rows) for dk/dv; B = 64 for d <= 128 and 32 for
// d = 256, so every tile fits shared memory. The TPU grid's sequential
// axis becomes a loop inside the block over the other operand's tiles,
// staged in shared memory as fp32 rows padded to d + 1 (conflict-free
// column reads). Only tiles that hold a visible pair are visited: up to
// the diagonal for causal, and from the window's first key (forward,
// dq) or up to its last query (dk/dv). Each thread owns a B/16 x B/16
// patch of the score tile (its rows' softmax statistics reduced over the
// 16 lanes of a half-warp) and a B/16 x d/16 patch of the output
// accumulators. p and ds pass through shared memory to the second
// product. dq and dk/dv stay two kernels, as in JAX: every output tile
// has one writer, so no atomics and a deterministic result. Tails where
// s is not a multiple of B are masked. The causal forward and dq visit
// the longest query tiles first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// ------------------------------------------------------------------ dq

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

// -------------------------------------------------------------- dk, dv

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

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* slopes,
               void* o, float* lse, int bh, int heads, int s, float scale,
               int causal, int window, cudaStream_t stream) {
  using TL = Tile<D>;
  const size_t smem = sizeof(float) * (2 * TL::kB * TL::kLd + TL::kB * TL::kLp);
  const int err = prepare(fwd_kernel<T, D>, smem);
  if (err) return err;
  fwd_kernel<T, D><<<grid_of<D>(bh, s), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), slopes, static_cast<T*>(o), lse, heads, s,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
size_t bwd_smem() {
  using TL = Tile<D>;
  return sizeof(float) * (4 * TL::kB * TL::kLd + TL::kB * TL::kLp + 2 * TL::kB);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* slopes,
              void* dq, int bh, int heads, int s, float scale, int causal,
              int window, cudaStream_t stream) {
  const size_t smem = bwd_smem<D>();
  const int err = prepare(dq_kernel<T, D>, smem);
  if (err) return err;
  dq_kernel<T, D><<<grid_of<D>(bh, s), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      slopes, static_cast<T*>(dq), heads, s, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* slopes,
               void* dk, void* dv, int bh, int heads, int s, float scale,
               int causal, int window, cudaStream_t stream) {
  const size_t smem = bwd_smem<D>();
  const int err = prepare(dkv_kernel<T, D>, smem);
  if (err) return err;
  dkv_kernel<T, D><<<grid_of<D>(bh, s), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      slopes, static_cast<T*>(dk), static_cast<T*>(dv), heads, s, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; head dims 64, 128 and 256.
// Each returns the CUDA error of the launch (0 on success), -1 for a
// dtype or head dim the kernels do not take. window <= 0: no window;
// slopes null: no ALiBi.

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

// o [bh, s, d] in q's dtype and lse [bh, s] fp32.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const float* slopes, void* o, float* lse, int bh,
                              int heads, int s, int d, float scale, int causal,
                              int window, int dtype, void* stream) {
  APEX_FLASH_DISPATCH(launch_fwd, q, k, v, slopes, o, lse, bh, heads, s, scale,
                      causal, window);
}

// dq [bh, s, d] in q's dtype.
extern "C" int apex_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* slopes, void* dq,
                             int bh, int heads, int s, int d, float scale,
                             int causal, int window, int dtype, void* stream) {
  APEX_FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, slopes, dq, bh,
                      heads, s, scale, causal, window);
}

// dk, dv [bh, s, d] in q's dtype.
extern "C" int apex_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const float* slopes, void* dk,
                              void* dv, int bh, int heads, int s, int d,
                              float scale, int causal, int window, int dtype,
                              void* stream) {
  APEX_FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, slopes, dk, dv, bh,
                      heads, s, scale, causal, window);
}
