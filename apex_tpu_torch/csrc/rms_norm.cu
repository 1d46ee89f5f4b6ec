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
// TB/s (25.2 MB, 7.5 us for the training step's [2048, 2048] bf16). x and
// dy may each be fp32 or bf16; dx is written once, in x's dtype, from
// fp32: the training path reads the bf16 residual stream directly, which
// gives the JAX layer's cast-to-fp32 / fp32 VJP / round-to-bf16 in one
// pass. The elementwise expressions are written with round-to-nearest
// intrinsics so that nvcc does not contract them into FMAs the TPU
// kernel's oracle lacks.
//
// The register path (warp_rms_bwd_dx, #5's body in layer_norm.cu with
// one row sum fewer): a row of up to kRegMaxH = 2048 elements lives in
// registers, spread over row_warps = 1, 2, 4 or 8 warps of a block. Lane
// L of the row's 32 * row_warps lanes holds chunks L, L + 32 * row_warps,
// ... of VEC elements (16 bytes of the narrower of dy and x, or 1 on the
// scalar path), kIters chunks (a power of two), at most kLaneMax = 32
// elements of each operand, bf16 held packed and widened on use. x and
// dy are read from device memory once (ld.global.cs) and dx written once
// (st.global.cs); w through the read-only cache, 16 bytes at a time where
// it starts on a 16-byte boundary. The two row sums are taken in one
// pass: sum(x*x) and t = sum(w*dy*x), each a lane's partial over its
// elements in the order it holds them, an xor butterfly of
// __shfl_xor_sync over the warp, then, with more than one warp a row, one
// exchange of both through shared memory (a block barrier), the warps'
// sums added in order; c = mean(w*dy*xhat) is then rstd * t / h, with
// rstd taken out of the sum (the sums' order is not the TPU kernel's; the
// output's elementwise order is). One pass and one exchange ran 1.3x
// faster on an H100 than a pass and an exchange a sum (PERF.md section
// 6). The wrapper's plan (kernels/norm.py `rms_bwd_plan`) picks the path,
// 16-byte or one-element accesses and the warps a row (the fewest that
// hold a row at 32 elements a lane) from the shapes and data_ptr() % 16;
// rows longer than kRegMaxH keep the first design.
//
// The first design (path 0, rms_bwd_dx_kernel): one block of 256 threads
// per row makes three passes over the row (sum of squares, sum of
// w*dy*xhat, output); the second and third reads are served from L1/L2,
// so device memory sees each byte once; four block barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_rows.cuh"

namespace {

using apex_rows::Chunk;
using apex_rows::load_weight;
using apex_rows::store_row;
using apex_rows::warp_sum;

constexpr int kThreads = 256;
constexpr int kRegMaxH = 2048;   // the register path: rows of at most 2048
constexpr int kLaneMax = 32;     // elements of dy and of x a lane holds, at most
constexpr int kMaxRowWarps = 8;  // warps a row on the register path, at most
constexpr int kBlockWarps = 4;   // warps of a register-path block (or a row's)

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

// The register path (see the header note): a row of h <= kIters * 32 *
// row_warps * kVec elements over row_warps warps. kVec: elements an access
// (16 bytes of the narrower type, or 1); w_whole: w 16-byte aligned.
template <typename Tdy, typename Tx, int kVec, int kIters>
__global__ void __launch_bounds__(kMaxRowWarps * 32)
warp_rms_bwd_dx(const Tdy* __restrict__ dy, const Tx* __restrict__ x,
                const float* __restrict__ w, Tx* __restrict__ dx,
                long long rows, int h, float eps, int row_warps, bool w_whole) {
  __shared__ float2 partial[kMaxRowWarps];
  const int warp = threadIdx.x >> 5;
  const int per_block = (blockDim.x >> 5) / row_warps;  // rows a block
  const long long row =
      static_cast<long long>(blockIdx.x) * per_block + warp / row_warps;
  const int lane = (warp % row_warps) * 32 + (threadIdx.x & 31);
  const int stride = 32 * row_warps;  // chunks between a lane's chunks
  const bool live = row < rows;
  if (row_warps == 1 && !live) return;  // no block barrier with one warp a row
  const long long at = (live ? row : 0) * h;
  Chunk<Tx, kVec> xv[kIters];
  Chunk<Tdy, kVec> gv[kIters];
  // both row sums in one pass: sum(x*x) and t = sum(w*dy*x)
  float ss = 0.f, t = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * stride + lane) * kVec;  // the chunk's first element
    if (live && j < h) {
      xv[it].load(x + at + j);
      gv[it].load(dy + at + j);
      float wv[kVec];
      load_weight<kVec>(w, j, w_whole, wv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ss = __fadd_rn(ss, __fmul_rn(xv[it][e], xv[it][e]));
        t = __fadd_rn(t, __fmul_rn(__fmul_rn(gv[it][e], wv[e]), xv[it][e]));
      }
    }
  }
  ss = warp_sum(ss);
  t = warp_sum(t);
  if (row_warps > 1) {  // the row's warps' sums, added in order
    if ((threadIdx.x & 31) == 0) partial[warp] = make_float2(ss, t);
    __syncthreads();
    const int first = warp / row_warps * row_warps;
    ss = t = 0.f;
    for (int i = 0; i < row_warps; ++i) {
      ss += partial[first + i].x;
      t += partial[first + i].y;
    }
  }
  const float rstd = rsqrtf(ss / static_cast<float>(h) + eps);
  // mean(w*dy*xhat) with xhat = x*rstd: rstd taken out of the sum
  const float c = __fmul_rn(t, rstd) / static_cast<float>(h);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * stride + lane) * kVec;
    if (live && j < h) {
      float wv[kVec], d[kVec];
      load_weight<kVec>(w, j, w_whole, wv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xhat = __fmul_rn(xv[it][e], rstd);
        const float wdy = __fmul_rn(gv[it][e], wv[e]);
        d[e] = __fmul_rn(__fsub_rn(wdy, __fmul_rn(xhat, c)), rstd);
      }
      store_row<kVec>(dx + at + j, d);
    }
  }
}

template <typename Tdy, typename Tx, int kVec, int kIters>
int launch_warp_rows(const void* dy, const void* x, const float* w, void* dx,
                     long long rows, int h, float eps, int row_warps,
                     cudaStream_t stream) {
  const int warps = row_warps > kBlockWarps ? row_warps : kBlockWarps;
  const int per_block = warps / row_warps;
  const long long blocks = (rows + per_block - 1) / per_block;
  const bool w_whole = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  warp_rms_bwd_dx<Tdy, Tx, kVec, kIters>
      <<<static_cast<unsigned>(blocks), warps * 32, 0, stream>>>(
          static_cast<const Tdy*>(dy), static_cast<const Tx*>(x), w,
          static_cast<Tx*>(dx), rows, h, eps, row_warps, w_whole);
  return static_cast<int>(cudaGetLastError());
}

// The register path's instance for `iters` chunks a lane (a power of two).
template <typename Tdy, typename Tx, int kVec, int kIters = 1>
int dispatch_warp_rows(int iters, const void* dy, const void* x,
                       const float* w, void* dx, long long rows, int h,
                       float eps, int row_warps, cudaStream_t stream) {
  if constexpr (kIters * kVec > kLaneMax) {
    return -1;
  } else {
    if (iters == kIters)
      return launch_warp_rows<Tdy, Tx, kVec, kIters>(dy, x, w, dx, rows, h, eps,
                                                     row_warps, stream);
    return dispatch_warp_rows<Tdy, Tx, kVec, kIters * 2>(
        iters, dy, x, w, dx, rows, h, eps, row_warps, stream);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// path: 0 = one block a row (the first design, any h), 1 = the register
// path with one element an access, 2 = the register path with 16-byte
// accesses; row_warps (register paths) 1, 2, 4 or 8 warps a row. -1 where
// the arguments do not fit the path.
template <typename Tdy, typename Tx>
int launch_bwd_path(int path, int row_warps, const void* dy, const void* x,
                    const float* w, void* dx, long long rows, int h, float eps,
                    cudaStream_t stream) {
  if (path == 0) return launch_bwd<Tdy, Tx>(dy, x, w, dx, rows, h, eps, stream);
  if ((path != 1 && path != 2) || h > kRegMaxH || w == nullptr) return -1;
  if (row_warps != 1 && row_warps != 2 && row_warps != 4 && row_warps != 8)
    return -1;
  constexpr int kVec =
      16 / static_cast<int>(sizeof(Tdy) < sizeof(Tx) ? sizeof(Tdy) : sizeof(Tx));
  const int vec = path == 2 ? kVec : 1;
  if (path == 2 && (h % kVec != 0 || !aligned16(dy) || !aligned16(x) ||
                    !aligned16(dx)))
    return -1;
  const int chunks = (h + vec - 1) / vec;
  const int per_lane = (chunks + 32 * row_warps - 1) / (32 * row_warps);
  int iters = 1;
  while (iters < per_lane) iters *= 2;
  if (path == 2)
    return dispatch_warp_rows<Tdy, Tx, kVec>(iters, dy, x, w, dx, rows, h, eps,
                                             row_warps, stream);
  return dispatch_warp_rows<Tdy, Tx, 1>(iters, dy, x, w, dx, rows, h, eps,
                                        row_warps, stream);
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
// [h]; dtype codes as above; path and row_warps as launch_bwd_path
// (kernels/norm.py `rms_bwd_plan` picks them). Returns the CUDA error of
// the launch (0 on success); -1 for a dtype, or a path, the kernel does
// not take for these arguments.
extern "C" int apex_rms_norm_bwd_dx(const void* dy, const void* x,
                                    const float* w, void* dx, long long rows,
                                    int h, float eps, int dy_dtype,
                                    int x_dtype, int path, int row_warps,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (h < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dy_dtype == 0 && x_dtype == 0) return launch_bwd_path<float, float>(path, row_warps, dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 0 && x_dtype == 1) return launch_bwd_path<float, bf16>(path, row_warps, dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 0) return launch_bwd_path<bf16, float>(path, row_warps, dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 1) return launch_bwd_path<bf16, bf16>(path, row_warps, dy, x, w, dx, rows, h, eps, s);
  return -1;
}
