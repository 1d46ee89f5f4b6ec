// LayerNorm forward and backward-dx for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces apex_tpu/kernels/norm.py `_ln_fwd_kernel` (launched by `ln_fwd`
// through `pallas_rowwise`) and `_ln_bwd_kernel` (launched by
// `ln_bwd_dx`), over the last dimension of a [rows, h] array, statistics
// in fp32 and in the TPU kernel's order (two passes, not Welford):
//   forward:  mean = sum(x) / h;  xc = x - mean;  var = sum(xc*xc) / h;
//             rstd = rsqrt(var + eps);  y = (xc * rstd) * w + b,
//             rounded to the input type and then to the output type, as
//             apex_tpu/ops/layer_norm.py does.
//   backward: the statistics recomputed from x (nothing is stashed by the
//             forward); xhat = xc * rstd;  wdy = w * dy;
//             c1 = sum(wdy) / h;  c2 = sum(wdy * xhat) / h;
//             dx = ((wdy - c1) - xhat * c2) * rstd, in x's type.
// A null w (or b) is the TPU kernel's `affine=False`: no scale (no shift).
//
// Bound on the H100: memory. Each element takes ~8 flops forward and ~12
// backward, far below the ~295 flops per byte where the tensor cores
// would become the limit. For the GPT-2 training step's [8192, 1024] bf16
// rows the forward moves 33.6 MB (>= 10.0 us at 3.35 TB/s) and the
// backward 50.3 MB (dy, x in, dx out: >= 15.0 us).
//
// Design: as rms_norm.cu, one block of 256 threads per row. Each thread
// sums over a strided slice of the row, a warp-shuffle reduction and a
// pass through shared memory give the row's sum; the row is read once
// from device memory and again from L1/L2 for each further pass (three
// in the forward, four in the backward). The rows of the path (8192)
// keep all 132 SMs busy. The input may be fp32 or bf16 and the output
// fp32 or bf16: the model's layers read the bf16 residual stream and
// write bf16, which gives the JAX layer's cast to fp32 / fp32 norm /
// rounding to bf16 in one pass; BERT's heads read and write fp32. The
// elementwise expressions are written with round-to-nearest intrinsics so
// that nvcc does not contract them into FMAs the TPU kernel's oracle
// lacks; only the order of the row sums differs.

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

// (mean, rstd) of a row, in the TPU kernel's two-pass order.
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* __restrict__ xr, int h,
                                            float eps) {
  float s = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) s += to_float(xr[i]);
  const float mean = block_sum(s) / static_cast<float>(h);
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float c = __fsub_rn(to_float(xr[i]), mean);
    ss = __fadd_rn(ss, __fmul_rn(c, c));
  }
  const float var = block_sum(ss) / static_cast<float>(h);
  return make_float2(mean, rsqrtf(var + eps));
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, Tout* __restrict__ y, int h,
              float eps) {
  const size_t row = blockIdx.x;
  const Tin* xr = x + row * h;
  Tout* yr = y + row * h;
  const float2 st = row_stats(xr, h, eps);
  for (int i = threadIdx.x; i < h; i += kThreads) {
    float v = __fmul_rn(__fsub_rn(to_float(xr[i]), st.x), st.y);
    if (w != nullptr) v = __fmul_rn(v, w[i]);
    if (b != nullptr) v = __fadd_rn(v, b[i]);
    // rounded to the input type first, as the JAX op (an exact
    // conversion when Tin is float or Tout is bf16)
    yr[i] = from_float<Tout>(to_float(from_float<Tin>(v)));
  }
}

template <typename Tin, typename Tout>
int launch_fwd(const void* x, const float* w, const float* b, void* y,
               long long rows, int h, float eps, cudaStream_t stream) {
  ln_fwd_kernel<Tin, Tout><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), w, b, static_cast<Tout*>(y), h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tdy, typename Tx>
__global__ void __launch_bounds__(kThreads)
ln_bwd_dx_kernel(const Tdy* __restrict__ dy, const Tx* __restrict__ x,
                 const float* __restrict__ w, Tx* __restrict__ dx, int h,
                 float eps) {
  const size_t row = blockIdx.x;
  const Tx* xr = x + row * h;
  const Tdy* dyr = dy + row * h;
  Tx* dxr = dx + row * h;
  const float2 st = row_stats(xr, h, eps);
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float xhat = __fmul_rn(__fsub_rn(to_float(xr[i]), st.x), st.y);
    const float wdy = w != nullptr ? __fmul_rn(to_float(dyr[i]), w[i])
                                   : to_float(dyr[i]);
    s1 += wdy;
    s2 = __fadd_rn(s2, __fmul_rn(wdy, xhat));
  }
  const float c1 = block_sum(s1) / static_cast<float>(h);
  const float c2 = block_sum(s2) / static_cast<float>(h);
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float xhat = __fmul_rn(__fsub_rn(to_float(xr[i]), st.x), st.y);
    const float wdy = w != nullptr ? __fmul_rn(to_float(dyr[i]), w[i])
                                   : to_float(dyr[i]);
    dxr[i] = from_float<Tx>(
        __fmul_rn(__fsub_rn(__fsub_rn(wdy, c1), __fmul_rn(xhat, c2)), st.y));
  }
}

template <typename Tdy, typename Tx>
int launch_bwd(const void* dy, const void* x, const float* w, void* dx,
               long long rows, int h, float eps, cudaStream_t stream) {
  ln_bwd_dx_kernel<Tdy, Tx><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const Tdy*>(dy), static_cast<const Tx*>(x), w,
      static_cast<Tx*>(dx), h, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. w and b are fp32 [h] or null.
// Returns the CUDA error of the launch (0 on success); -1 for a dtype the
// kernel does not take.
extern "C" int apex_layer_norm_fwd(const void* x, const float* w,
                                   const float* b, void* y, long long rows,
                                   int h, float eps, int in_dtype,
                                   int out_dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return launch_fwd<float, float>(x, w, b, y, rows, h, eps, s);
  if (in_dtype == 0 && out_dtype == 1) return launch_fwd<float, __nv_bfloat16>(x, w, b, y, rows, h, eps, s);
  if (in_dtype == 1 && out_dtype == 0) return launch_fwd<__nv_bfloat16, float>(x, w, b, y, rows, h, eps, s);
  if (in_dtype == 1 && out_dtype == 1) return launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, rows, h, eps, s);
  return -1;
}

// dx [rows, h] in x's dtype from dy and x [rows, h] and the fp32 weight
// [h] (or null); dtype codes as above. Returns the CUDA error of the
// launch (0 on success); -1 for a dtype the kernel does not take.
extern "C" int apex_layer_norm_bwd_dx(const void* dy, const void* x,
                                      const float* w, void* dx,
                                      long long rows, int h, float eps,
                                      int dy_dtype, int x_dtype,
                                      void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dy_dtype == 0 && x_dtype == 0) return launch_bwd<float, float>(dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 0 && x_dtype == 1) return launch_bwd<float, __nv_bfloat16>(dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 0) return launch_bwd<__nv_bfloat16, float>(dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 1) return launch_bwd<__nv_bfloat16, __nv_bfloat16>(dy, x, w, dx, rows, h, eps, s);
  return -1;
}
