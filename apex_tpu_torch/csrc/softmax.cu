// Scaled, scaled-masked and causal softmax forward and softmax backward
// for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/kernels/softmax.py `_fwd_kernel` (launched by
// `scaled_softmax`), `_masked_fwd_kernel` (`scaled_masked_softmax`),
// `_causal_fwd_kernel` (`scaled_upper_triang_masked_softmax`) and
// `_bwd_kernel` (the backward of all three, through `_bwd_rows`):
//   scaled:   y = softmax(x * scale) over each row of x [rows, sk].
//   masked:   x [b, n, sq, sk] with a 1-byte mask read through a
//             [b, n, sq, sk] view with strides (0 where it broadcasts:
//             a [b, 1, sq, sk] mask serves every head and is never
//             materialised at the scores' shape); mask != 0 means
//             masked out. The same kernel with no mask is `scaled`.
//   causal:   x [B, sq, sk] -> y in x's dtype; for row r, i = r % sq and
//             key j is masked when j > i + (sk - sq).
//   In fp32, for every forward: x*scale, masked keys set to -10000 (not
//   -inf), subtract the row max, exp, masked keys set to 0, divide by the
//   row sum. A row with every key masked is 0 / 0 = NaN, as in the TPU
//   kernel and its oracle.
//   backward: dx = scale * y * (dy - sum(dy * y)) over each row, y, dy
//             and dx in one dtype, arithmetic in fp32.
//
// Bound on the H100: memory. Each element takes a handful of flops, far
// below the ~295 flops per byte where the tensor cores would become the
// limit. At the TinyLlama training step's causal shape (B = 2*32, sq = sk
// = 1024, fp32) the forward moves 384 MB (it reads only the unmasked
// lower triangle and writes the whole row: >= 115 us at 3.35 TB/s) and
// the backward 768 MB (reads y and dy, writes dx: >= 229 us). At BERT-
// large's masked shape ([64, 16, 128, 128] fp32 scores, a [64, 1, 128,
// 128] bool mask) the forward moves 134 MB of scores and 1 MB of mask
// (>= 40.4 us).
//
// Design: one block of 256 threads per row; the 65,536 (causal) and
// 131,072 (BERT) rows of the paths keep all 132 SMs busy. The forward
// stages the row's live scores, already scaled, in shared memory (sk*4
// bytes, up to 64 KB for sk = 16384), so x and the mask are read from
// device memory once (the causal kernel does not read the masked tail
// at all); a block-wide max and sum follow. The masked kernel stages a
// masked key as -inf, so its exp is exactly 0, and takes -10000 into the
// row max in its place, which is the oracle's max. Masked keys are
// written as exactly 0 (0 / sum, which is NaN only where the oracle's
// 0 / 0 is, in a row with every key masked). The backward sums dy*y over
// the row, then writes each dx; its second read of the row is served
// from L1/L2. The fp32 operation order is the TPU kernel's (IEEE division
// e / sum, expf, no fast math), and the elementwise expressions are
// written with round-to-nearest intrinsics so nvcc does not contract
// them into FMAs the oracle lacks; only the order of the row sums
// differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMaskValue = -10000.f;
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

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
  __syncthreads();  // `partial` may be reused by a following call
  return total;
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float total = partial[0];
  for (int i = 1; i < kThreads / 32; ++i) total = fmaxf(total, partial[i]);
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
causal_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int sq, int sk,
                  float scale) {
  extern __shared__ float row[];
  const size_t r = blockIdx.x;
  const int i = static_cast<int>(r % sq);
  // keys j <= i + (sk - sq) are live
  const int live = min(sk, max(0, i + (sk - sq) + 1));
  const T* xr = x + r * sk;
  T* yr = y + r * sk;
  float mx = -__int_as_float(0x7f800000);  // -inf
  for (int j = threadIdx.x; j < live; j += kThreads) {
    const float v = __fmul_rn(to_float(xr[j]), scale);
    row[j] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_max(mx);
  if (live < sk) mx = fmaxf(mx, kMaskValue);
  float sum = 0.f;
  for (int j = threadIdx.x; j < live; j += kThreads) {
    const float e = expf(__fsub_rn(row[j], mx));
    row[j] = e;
    sum += e;
  }
  sum = block_sum(sum);
  for (int j = threadIdx.x; j < sk; j += kThreads)
    yr[j] = from_float<T>(__fdiv_rn(j < live ? row[j] : 0.f, sum));
}

// mask: null (no mask) or 1-byte flags read at
// mask[bi*msb + ni*msn + i*msq + j] for row r = (bi*n + ni)*sq + i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_fwd_kernel(const T* __restrict__ x, const unsigned char* __restrict__ mask,
                  T* __restrict__ y, int n, int sq, int sk, long long msb,
                  long long msn, long long msq, float scale) {
  extern __shared__ float row[];
  const size_t r = blockIdx.x;
  const T* xr = x + r * sk;
  T* yr = y + r * sk;
  const unsigned char* mr = nullptr;
  if (mask != nullptr) {
    const long long i = static_cast<long long>(r % sq);
    const long long bn = static_cast<long long>(r / sq);
    mr = mask + (bn / n) * msb + (bn % n) * msn + i * msq;
  }
  const float neg_inf = -__int_as_float(0x7f800000);
  float mx = neg_inf;
  for (int j = threadIdx.x; j < sk; j += kThreads) {
    const float v = __fmul_rn(to_float(xr[j]), scale);
    const bool out = mr != nullptr && mr[j] != 0;
    row[j] = out ? neg_inf : v;
    mx = fmaxf(mx, out ? kMaskValue : v);
  }
  mx = block_max(mx);
  float sum = 0.f;
  for (int j = threadIdx.x; j < sk; j += kThreads) {
    const float e = expf(__fsub_rn(row[j], mx));
    row[j] = e;
    sum += e;
  }
  sum = block_sum(sum);
  for (int j = threadIdx.x; j < sk; j += kThreads)
    yr[j] = from_float<T>(__fdiv_rn(row[j], sum));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
           T* __restrict__ dx, int sk, float scale) {
  const size_t r = blockIdx.x;
  const T* yr = y + r * sk;
  const T* dyr = dy + r * sk;
  T* dxr = dx + r * sk;
  float t = 0.f;
  for (int j = threadIdx.x; j < sk; j += kThreads)
    t += to_float(dyr[j]) * to_float(yr[j]);
  t = block_sum(t);
  for (int j = threadIdx.x; j < sk; j += kThreads) {
    const float yv = to_float(yr[j]);
    dxr[j] = from_float<T>(
        __fmul_rn(__fmul_rn(scale, yv), __fsub_rn(to_float(dyr[j]), t)));
  }
}

template <typename T>
int launch_fwd(const void* x, void* y, long long rows, int sq, int sk,
               float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(sk) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        causal_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  causal_fwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_masked(const void* x, const void* mask, void* y, long long rows,
                  int n, int sq, int sk, long long msb, long long msn,
                  long long msq, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(sk) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_fwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(mask),
      static_cast<T*>(y), n, sq, sk, msb, msn, msq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* y, const void* dy, void* dx, long long rows,
               int sk, float scale, cudaStream_t stream) {
  bwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy),
      static_cast<T*>(dx), sk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each returns the CUDA error of
// the launch (0 on success); -1 for a dtype the kernel does not take.

// y [rows, sk] = causal softmax of x [rows, sk], rows = B * sq.
extern "C" int apex_causal_softmax_fwd(const void* x, void* y, long long rows,
                                       int sq, int sk, float scale,
                                       int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, y, rows, sq, sk, scale, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, y, rows, sq, sk, scale, s);
  return -1;
}

// y [rows, sk] = softmax of x [rows, sk] * scale with the keys the mask
// flags set to -10000, rows = b * n * sq; mask null: no key is masked
// (n, sq and the strides are not read).
extern "C" int apex_masked_softmax_fwd(const void* x, const void* mask,
                                       void* y, long long rows, int n, int sq,
                                       int sk, long long msb, long long msn,
                                       long long msq, float scale, int dtype,
                                       void* stream) {
  if (rows <= 0) return 0;
  if (mask != nullptr && (n < 1 || sq < 1)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_masked<float>(x, mask, y, rows, n, sq, sk, msb, msn, msq, scale, s);
  if (dtype == 1)
    return launch_masked<__nv_bfloat16>(x, mask, y, rows, n, sq, sk, msb, msn, msq, scale, s);
  return -1;
}

// dx [rows, sk] = scale * y * (dy - rowsum(dy * y)).
extern "C" int apex_softmax_bwd(const void* y, const void* dy, void* dx,
                                long long rows, int sk, float scale,
                                int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(y, dy, dx, rows, sk, scale, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, s);
  return -1;
}
