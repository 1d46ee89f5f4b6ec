// RMSNorm forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/kernels/norm.py `_rms_fwd_kernel` (launched by
// `rms_fwd` through `pallas_rowwise`): y = x * rsqrt(mean(x*x) + eps) * w
// over the last dimension of a [rows, h] array, statistics in fp32.
//
// Bound on the H100: memory. Each element is read once and written once
// and takes four flops, far below the ~295 flops per byte where the
// tensor cores would become the limit; the least time is
// (rows*h*(in_bytes + out_bytes) + h*4) / 3.35 TB/s.
//
// Design: one block of 256 threads per row. Each thread sums x*x over a
// strided slice of the row in fp32, a warp-shuffle reduction and a pass
// through shared memory give the row's sum, then each thread rescales
// its slice (the second read of the row is served from L1/L2). The fp32
// operation order is the TPU kernel's: ms = sum(x*x) / h, then
// (x * rsqrt(ms + eps)) * w, rounded to the input type and then to the
// output type as apex_tpu/ops/layer_norm.py does. The input may be fp32
// or bf16 and the output fp32 or bf16: reading the bf16 residual stream
// directly gives the same values as casting it to fp32 first, and
// writing bf16 directly the same as rounding the fp32 result afterwards,
// so the model saves the two cast passes around the norm.
// A row per block suits both of the path's shapes (1024 rows of 2048 in
// the prefill, 8 rows in a decode step, where the launch dominates).
//
// Backward-dx (replaces apex_tpu/kernels/norm.py `_rms_bwd_kernel`,
// launched by `rms_bwd_dx`): dx = (w*dy - xhat * mean(w*dy*xhat)) * rstd
// with xhat = x * rstd. Like the TPU kernel it stashes nothing from the
// forward: ms and rstd are recomputed from x in the forward's fp32 order.
// Bound on the H100: memory, (rows*h*(dy_bytes + 2*x_bytes) + h*4) / 3.35
// TB/s (25.2 MB, 7.5 us for the training step's [2048, 2048] bf16). One
// block of 256 threads per row makes three passes over the row (sum of
// squares, sum of w*dy*xhat, output); the second and third reads are
// served from L1/L2, so device memory sees each byte once. x and dy may
// each be fp32 or bf16; dx is written once, in x's dtype, from fp32: the
// training path reads the bf16 residual stream directly, which gives the
// JAX layer's cast-to-fp32 / fp32 VJP / round-to-bf16 in one pass. The
// final expression is written with round-to-nearest intrinsics so that
// nvcc does not contract it into an FMA the TPU kernel's oracle lacks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
               Tout* __restrict__ y, int h, float eps) {
  const size_t row = blockIdx.x;
  const Tin* xr = x + row * h;
  Tout* yr = y + row * h;
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  const float ms = block_sum(ss) / static_cast<float>(h);
  const float inv = rsqrtf(ms + eps);
  for (int i = threadIdx.x; i < h; i += kThreads) {
    // rounded to the input type first, as the JAX op (an exact
    // conversion when Tin is float or Tout is bf16)
    const Tin v = from_float<Tin>(to_float(xr[i]) * inv * w[i]);
    yr[i] = from_float<Tout>(to_float(v));
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const float* w, void* y, long long rows, int h,
           float eps, cudaStream_t stream) {
  rms_fwd_kernel<Tin, Tout><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), w, static_cast<Tout*>(y), h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tdy, typename Tx>
__global__ void __launch_bounds__(kThreads)
rms_bwd_dx_kernel(const Tdy* __restrict__ dy, const Tx* __restrict__ x,
                  const float* __restrict__ w, Tx* __restrict__ dx, int h,
                  float eps) {
  const size_t row = blockIdx.x;
  const Tx* xr = x + row * h;
  const Tdy* dyr = dy + row * h;
  Tx* dxr = dx + row * h;
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  const float ms = block_sum(ss) / static_cast<float>(h);
  const float rstd = rsqrtf(ms + eps);
  float sc = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float xhat = to_float(xr[i]) * rstd;
    sc += (to_float(dyr[i]) * w[i]) * xhat;
  }
  const float c = block_sum(sc) / static_cast<float>(h);
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float xhat = __fmul_rn(to_float(xr[i]), rstd);
    const float wdy = __fmul_rn(to_float(dyr[i]), w[i]);
    dxr[i] = from_float<Tx>(__fmul_rn(__fsub_rn(wdy, __fmul_rn(xhat, c)), rstd));
  }
}

template <typename Tdy, typename Tx>
int launch_bwd(const void* dy, const void* x, const float* w, void* dx,
               long long rows, int h, float eps, cudaStream_t stream) {
  rms_bwd_dx_kernel<Tdy, Tx><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const Tdy*>(dy), static_cast<const Tx*>(x), w,
      static_cast<Tx*>(dx), h, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns the CUDA error of the
// launch (0 on success); -1 for a dtype the kernel does not take.
extern "C" int apex_rms_norm_fwd(const void* x, const float* w, void* y,
                                 long long rows, int h, float eps,
                                 int in_dtype, int out_dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return launch<float, float>(x, w, y, rows, h, eps, s);
  if (in_dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(x, w, y, rows, h, eps, s);
  if (in_dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(x, w, y, rows, h, eps, s);
  if (in_dtype == 1 && out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, h, eps, s);
  return -1;
}

// dx [rows, h] in x's dtype from dy and x [rows, h] and the fp32 weight
// [h]; dtype codes as above. Returns the CUDA error of the launch (0 on
// success); -1 for a dtype the kernel does not take.
extern "C" int apex_rms_norm_bwd_dx(const void* dy, const void* x,
                                    const float* w, void* dx, long long rows,
                                    int h, float eps, int dy_dtype,
                                    int x_dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dy_dtype == 0 && x_dtype == 0) return launch_bwd<float, float>(dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 0 && x_dtype == 1) return launch_bwd<float, __nv_bfloat16>(dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 0) return launch_bwd<__nv_bfloat16, float>(dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 1) return launch_bwd<__nv_bfloat16, __nv_bfloat16>(dy, x, w, dx, rows, h, eps, s);
  return -1;
}
