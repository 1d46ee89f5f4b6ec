// The GEMM of the fused row-parallel projection + all-reduce, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/kernels/fused_cc.py `_mm_kernel` (#20), launched by
// `_matmul` under `matmul_reduce_from`, `matmul_reduce_scatter` and
// `all_gather_matmul`:
//   out[m, n] = sum_k x[m, k] * w[k, n]
// accumulated in fp32 and written in the result type of x and w (fp32
// unless both are bf16). x is [M, K] with rows lda elements apart; w is
// [K, N] with rows ldw elements apart, so a column slice w[:, a:b] (each
// column tile of matmul_reduce_from) is read in place, without a copy.
// The TPU kernel pads M to a multiple of 8; here every load and store is
// guarded, which gives the same values.
//
// Exactness: each output is one fp32 sum over k in increasing order,
// __fmaf_rn a step; bf16 inputs are widened exactly. No TF32 and no tensor
// cores: the products stay fp32-exact, as on the CPU reference.
//
// Bound on the H100: operations. On mesh2d's fused step at GPT-2 345M
// width (batch 8 x 1024 rows) the attention tile [8192, 1024] x [1024,
// 256] is 4.29 GFLOP, 64 us at the 67 TFLOP/s of fp32 outside the tensor
// cores, and the MLP tile [8192, 4096] x [4096, 256] 17.2 GFLOP, 256 us;
// either moves under 150 MB, 45 us at 3.35 TB/s.
//
// Design: a classic shared-memory tiled SGEMM, simple before fast. A block
// of 128 threads computes a 128 x 64 output tile; each thread keeps an 8 x
// 8 register tile (rows ty*8.., columns tx*4.. and 32 + tx*4.., so that a
// quarter warp's 16-byte reads of a w row fall on distinct banks). The K
// dimension goes in steps of 16 through two shared-memory buffers: the
// next step's tiles are loaded into registers while the current one
// computes, then stored, one __syncthreads a step. x's tile is stored
// transposed ([k][m]) so that a thread reads its 8 rows as two float4.
// Loads are 16 bytes where the leading dimension and the address allow
// (lda, ldw multiples of 4 fp32 or 8 bf16 elements, 16-byte aligned) and
// element by element at ragged edges. Shared memory: 24 KB a block.
// wgmma/TMA with fp32-exact products is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output rows of a block
constexpr int kBN = 64;       // output columns of a block
constexpr int kBK = 16;       // K step
constexpr int kThreads = 128;  // 16 row groups x 8 column groups

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// N contiguous values at p (16-byte aligned) widened to fp32
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[i] = f.x;
    v[i + 1] = f.y;
    v[i + 2] = f.z;
    v[i + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[i + 2 * j] = f.x;
      v[i + 2 * j + 1] = f.y;
    }
  }
}

// thread t loads row m0 + t of x, columns k0 .. k0 + 15
template <typename TX>
__device__ __forceinline__ void load_x(const TX* __restrict__ x,
                                       long long lda, int M, int K, int m0,
                                       int k0, bool vec, float (&v)[kBK]) {
  const int row = m0 + static_cast<int>(threadIdx.x);
  if (row < M) {
    const TX* p = x + static_cast<long long>(row) * lda + k0;
    if (vec && k0 + kBK <= K) {
      load_vec<kBK>(p, v);
    } else {
#pragma unroll
      for (int i = 0; i < kBK; ++i) v[i] = k0 + i < K ? widen(p[i]) : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBK; ++i) v[i] = 0.f;
  }
}

// thread t loads row k0 + t / 8 of w, columns n0 + (t % 8) * 8 .. + 7
template <typename TW>
__device__ __forceinline__ void load_w(const TW* __restrict__ w,
                                       long long ldw, int N, int K, int n0,
                                       int k0, bool vec, float (&v)[8]) {
  const int k = k0 + static_cast<int>(threadIdx.x) / 8;
  const int n = n0 + (static_cast<int>(threadIdx.x) % 8) * 8;
  if (k < K) {
    const TW* p = w + static_cast<long long>(k) * ldw + n;
    if (vec && n + 8 <= N) {
      load_vec<8>(p, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = n + j < N ? widen(p[j]) : 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
  }
}

// the registers of one K step into a shared-memory buffer: x transposed
__device__ __forceinline__ void stash(float (&xs)[kBK][kBM],
                                      float (&ws)[kBK][kBN],
                                      const float (&vx)[kBK],
                                      const float (&vw)[8]) {
  const int t = static_cast<int>(threadIdx.x);
#pragma unroll
  for (int i = 0; i < kBK; ++i) xs[i][t] = vx[i];
  float4* dst = reinterpret_cast<float4*>(&ws[t / 8][(t % 8) * 8]);
  dst[0] = make_float4(vw[0], vw[1], vw[2], vw[3]);
  dst[1] = make_float4(vw[4], vw[5], vw[6], vw[7]);
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  TO* __restrict__ out, int M, int N, int K, long long lda,
                  long long ldw, bool vec_x, bool vec_w, bool vec_out) {
  __shared__ __align__(16) float xs[2][kBK][kBM];
  __shared__ __align__(16) float ws[2][kBK][kBN];
  const int t = static_cast<int>(threadIdx.x);
  const int tx = t % 8;   // column group: columns tx*4.. and 32 + tx*4..
  const int ty = t / 8;   // row group: rows ty*8 .. ty*8 + 7
  const int m0 = static_cast<int>(blockIdx.y) * kBM;
  const int n0 = static_cast<int>(blockIdx.x) * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float vx[kBK], vw[8];
  load_x(x, lda, M, K, m0, 0, vec_x, vx);
  load_w(w, ldw, N, K, n0, 0, vec_w, vw);
  stash(xs[0], ws[0], vx, vw);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) {  // the next step's tiles, in flight while this one computes
      load_x(x, lda, M, K, m0, k0 + kBK, vec_x, vx);
      load_w(w, ldw, N, K, n0, k0 + kBK, vec_w, vw);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][kk][32 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (more) stash(xs[buf ^ 1], ws[buf ^ 1], vx, vw);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= M) break;
    TO* orow = out + static_cast<long long>(row) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 32 + tx * 4;
      if constexpr (sizeof(TO) == 4) {
        if (vec_out && col + 4 <= N) {
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                          acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < N) put(orow + col + j, acc[i][h * 4 + j]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, void* out, int m, int n, int k,
           long long lda, long long ldw, cudaStream_t s) {
  // elements in 16 bytes: the vector loads need rows that many apart
  const int vx = 16 / static_cast<int>(sizeof(TX));
  const int vw = 16 / static_cast<int>(sizeof(TW));
  const bool vec_x = lda % vx == 0 && aligned16(x);
  const bool vec_w = ldw % vw == 0 && aligned16(w);
  const bool vec_out = sizeof(TO) == 4 && n % 4 == 0 && aligned16(out);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<TX, TW, TO><<<grid, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), m, n, k, lda, ldw, vec_x, vec_w, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 fp32, 1 bf16; out is fp32 unless both x and w are bf16
extern "C" int apex_tp_matmul(const void* x, const void* w, void* out, int m,
                              int n, int k, long long lda, long long ldw,
                              int x_dtype, int w_dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return -1;
  if ((m + kBM - 1) / kBM > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float, float>(x, w, out, m, n, k, lda, ldw, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<bf16, float, float>(x, w, out, m, n, k, lda, ldw, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, bf16, float>(x, w, out, m, n, k, lda, ldw, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<bf16, bf16, bf16>(x, w, out, m, n, k, lda, ldw, s);
  return -1;
}
