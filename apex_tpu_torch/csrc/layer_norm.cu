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
// Design of the forward (#4): a row of up to kRegMaxH = 1024 elements
// lives in the registers of one warp (warp_ln_fwd), laid out as the
// backward-dx's below: lane l holds chunks l, l + 32, ... of VEC elements
// (16 bytes of the narrower of x and y: 8 when either is bf16, 4 when
// both are fp32; 1 on the scalar path), bf16 as packed pairs widened on
// use. x is read from device memory once (ld.global.cs) and y written
// once (st.global.cs); w and b (fp32 [h]) through the read-only cache, 16
// bytes at a time where each starts on a 16-byte boundary (two
// launch-wide flags). The mean and the centred sum of squares are each a
// lane's partial in the order it holds its elements, then the xor
// butterfly; no shared memory, no block barrier, 4 warps a block, a row
// a warp. The first design (ln_fwd_kernel, one block of 256 threads a
// row: each thread sums a strided slice, a shuffle and a pass through
// shared memory give the row's sum, x read three times with 2-byte
// accesses and four block barriers a row) ran at 0.43 of its bound at
// GPT-2's [8192, 1024] bf16 rows and stays for rows longer than 1024.
// The plan (kernels/norm.py `ln_plan`, one rule for both kernels, here
// on x's and y's itemsizes) passes the path, as for the backward. The
// input may be fp32 or bf16 and the output fp32 or bf16: the model's
// layers read the bf16 residual stream and write bf16, which gives the
// JAX layer's cast to fp32 / fp32 norm / rounding to bf16 in one pass;
// BERT's heads read and write fp32.
//
// Design of the backward-dx (#5): a row of up to kRegMaxH = 1024
// elements lives in the registers of one warp, with no shared memory and
// no block barrier (warp_ln_bwd_dx). The first design (ln_bwd_dx_kernel,
// one block of 256 threads a row: four block sums of two barriers each,
// four passes over the row, 2-byte accesses) ran at 0.40 of its bound at
// GPT-2's [8192, 1024] bf16 rows. Lane l holds chunks l, l + 32, ... of
// VEC elements (16 bytes of the narrower of dy and x: 8 when either is
// bf16, 4 when both are fp32; 1 on the scalar path): kIters chunks a
// lane, a template bucket (the chunks a row needs, rounded up to a power
// of two), at most 32 elements of each a lane. They are held as loaded,
// bf16 as packed pairs (16 registers for 32 values), and widened to fp32
// on each use: fewer registers and more warps resident than with the
// values widened into registers, which ran slower on an H100 80GB HBM3. x and dy are
// read from device memory once, with streaming hints (ld.global.cs), and
// dx written once (st.global.cs); w (fp32 [h], 4 KB) is read through the
// read-only cache in the sums' pass and again in the output pass, 16
// bytes at a time where it starts on a 16-byte boundary (a launch-wide
// flag: w does not choose the path). The four row sums (mean, the centred
// sum of squares, c1, c2; c1 and c2 in one pass) are each a lane's
// partial over its elements in the order it holds them, then an xor
// butterfly of __shfl_xor_sync (five steps; every
// lane ends with the same bits). Blocks are kRowWarps = 4 warps, a row a
// warp. The 16-byte path needs h a multiple of VEC and dy, x, dx on
// 16-byte boundaries; the wrapper's plan (kernels/norm.py `ln_plan`)
// picks it from the shapes and data_ptr() % 16 and passes it as `path`,
// which the launcher checks. Otherwise the scalar path runs with the same
// lanes (h = 1001, views off 16 bytes); rows longer than kRegMaxH keep
// the first design. Only the order of the four row sums differs from the
// TPU kernel's two-pass arithmetic (mean first, then the centred squares;
// not Welford). The elementwise expressions are written with
// round-to-nearest intrinsics so that nvcc does not contract them into
// FMAs the TPU kernel's oracle lacks; rsqrtf(var + eps) as before.

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
constexpr int kRegMaxH = 1024;  // the register path: rows of at most 1024
constexpr int kRowWarps = 4;    // warps (rows) of a register-path block

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

// The forward's register path: a row of h <= kIters * 32 * kVec elements
// a warp (see the header note), the first design's arithmetic with the
// row sums in the lanes' order. w or b null: no scale or no shift;
// w_whole, b_whole: 16-byte aligned.
template <typename Tin, typename Tout, int kVec, int kIters>
__global__ void __launch_bounds__(kRowWarps * 32)
warp_ln_fwd(const Tin* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, Tout* __restrict__ y,
            long long rows, int h, float eps, bool w_whole, bool b_whole) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: no shuffle is left waiting
  const Tin* xr = x + row * h;
  Tout* yr = y + row * h;
  Chunk<Tin, kVec> xv[kIters];
  float s = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * 32 + lane) * kVec;  // the chunk's first element
    if (j < h) {
      xv[it].load(xr + j);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += xv[it][e];
    }
  }
  const float mean = warp_sum(s) / static_cast<float>(h);
  float ss = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    if ((it * 32 + lane) * kVec < h) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float c = __fsub_rn(xv[it][e], mean);
        ss = __fadd_rn(ss, __fmul_rn(c, c));
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / static_cast<float>(h) + eps);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * 32 + lane) * kVec;
    if (j < h) {
      float wv[kVec], bv[kVec], o[kVec];
      if (w != nullptr) load_weight<kVec>(w, j, w_whole, wv);
      if (b != nullptr) load_weight<kVec>(b, j, b_whole, bv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float v = __fmul_rn(__fsub_rn(xv[it][e], mean), rstd);
        if (w != nullptr) v = __fmul_rn(v, wv[e]);
        if (b != nullptr) v = __fadd_rn(v, bv[e]);
        // rounded to the input type first, as the first design
        o[e] = to_float(from_float<Tin>(v));
      }
      store_row<kVec>(yr + j, o);
    }
  }
}

template <typename Tin, typename Tout, int kVec, int kIters>
int launch_warp_fwd(const void* x, const float* w, const float* b, void* y,
                    long long rows, int h, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
  warp_ln_fwd<Tin, Tout, kVec, kIters>
      <<<static_cast<unsigned>(blocks), kRowWarps * 32, 0, stream>>>(
          static_cast<const Tin*>(x), w, b, static_cast<Tout*>(y), rows, h,
          eps, (reinterpret_cast<uintptr_t>(w) & 15) == 0,
          (reinterpret_cast<uintptr_t>(b) & 15) == 0);
  return static_cast<int>(cudaGetLastError());
}

// The forward's register path instance for `iters` chunks a lane (a
// power of two).
template <typename Tin, typename Tout, int kVec, int kIters = 1>
int dispatch_warp_fwd(int iters, const void* x, const float* w,
                      const float* b, void* y, long long rows, int h,
                      float eps, cudaStream_t stream) {
  if constexpr (kIters * 32 * kVec > kRegMaxH) {
    return -1;
  } else {
    if (iters == kIters)
      return launch_warp_fwd<Tin, Tout, kVec, kIters>(x, w, b, y, rows, h,
                                                      eps, stream);
    return dispatch_warp_fwd<Tin, Tout, kVec, kIters * 2>(iters, x, w, b, y,
                                                          rows, h, eps, stream);
  }
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


// The register path: a row of h <= kIters * 32 * kVec elements a warp
// (see the header note). kVec: elements an access (16 bytes of the
// narrower type, or 1). w null: no scale; w_whole: w 16-byte aligned.
template <typename Tdy, typename Tx, int kVec, int kIters>
__global__ void __launch_bounds__(kRowWarps * 32)
warp_ln_bwd_dx(const Tdy* __restrict__ dy, const Tx* __restrict__ x,
               const float* __restrict__ w, Tx* __restrict__ dx,
               long long rows, int h, float eps, bool w_whole) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: no shuffle is left waiting
  const Tx* xr = x + row * h;
  const Tdy* dyr = dy + row * h;
  Tx* dxr = dx + row * h;
  Chunk<Tx, kVec> xv[kIters];
  Chunk<Tdy, kVec> gv[kIters];
  float s = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * 32 + lane) * kVec;  // the chunk's first element
    if (j < h) {
      xv[it].load(xr + j);
      gv[it].load(dyr + j);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += xv[it][e];
    }
  }
  const float mean = warp_sum(s) / static_cast<float>(h);
  float ss = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    if ((it * 32 + lane) * kVec < h) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float c = __fsub_rn(xv[it][e], mean);
        ss = __fadd_rn(ss, __fmul_rn(c, c));
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / static_cast<float>(h) + eps);
  // xhat and w*dy, recomputed from the loaded values (w from cache) in
  // the sums' pass and in the output pass
  auto terms = [&](int it, int j, float* xhat, float* wdy) {
    float wv[kVec];
    if (w != nullptr) load_weight<kVec>(w, j, w_whole, wv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      xhat[e] = __fmul_rn(__fsub_rn(xv[it][e], mean), rstd);
      wdy[e] = w != nullptr ? __fmul_rn(gv[it][e], wv[e]) : gv[it][e];
    }
  };
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * 32 + lane) * kVec;
    if (j < h) {
      float xhat[kVec], wdy[kVec];
      terms(it, j, xhat, wdy);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s1 += wdy[e];
        s2 = __fadd_rn(s2, __fmul_rn(wdy[e], xhat[e]));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float c1 = s1 / static_cast<float>(h);
  const float c2 = s2 / static_cast<float>(h);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * 32 + lane) * kVec;
    if (j < h) {
      float xhat[kVec], wdy[kVec], d[kVec];
      terms(it, j, xhat, wdy);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = __fmul_rn(__fsub_rn(__fsub_rn(wdy[e], c1), __fmul_rn(xhat[e], c2)),
                         rstd);
      store_row<kVec>(dxr + j, d);
    }
  }
}

template <typename Tdy, typename Tx, int kVec, int kIters>
int launch_warp_rows(const void* dy, const void* x, const float* w, void* dx,
                     long long rows, int h, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
  const bool w_whole = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  warp_ln_bwd_dx<Tdy, Tx, kVec, kIters>
      <<<static_cast<unsigned>(blocks), kRowWarps * 32, 0, stream>>>(
          static_cast<const Tdy*>(dy), static_cast<const Tx*>(x), w,
          static_cast<Tx*>(dx), rows, h, eps, w_whole);
  return static_cast<int>(cudaGetLastError());
}

// The register path's instance for `iters` chunks a lane (a power of two).
template <typename Tdy, typename Tx, int kVec, int kIters = 1>
int dispatch_warp_rows(int iters, const void* dy, const void* x,
                       const float* w, void* dx, long long rows, int h,
                       float eps, cudaStream_t stream) {
  if constexpr (kIters * 32 * kVec > kRegMaxH) {
    return -1;
  } else {
    if (iters == kIters)
      return launch_warp_rows<Tdy, Tx, kVec, kIters>(dy, x, w, dx, rows, h,
                                                     eps, stream);
    return dispatch_warp_rows<Tdy, Tx, kVec, kIters * 2>(iters, dy, x, w, dx,
                                                         rows, h, eps, stream);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// path: 0 = one block a row (the first design, any h), 1 = the register
// path with one element an access, 2 = the register path with 16-byte
// accesses. -1 where the arguments do not fit the path.
template <typename Tdy, typename Tx>
int launch_bwd_path(int path, const void* dy, const void* x, const float* w,
                    void* dx, long long rows, int h, float eps,
                    cudaStream_t stream) {
  if (path == 0) return launch_bwd<Tdy, Tx>(dy, x, w, dx, rows, h, eps, stream);
  if ((path != 1 && path != 2) || h > kRegMaxH) return -1;
  constexpr int kVec =
      16 / static_cast<int>(sizeof(Tdy) < sizeof(Tx) ? sizeof(Tdy) : sizeof(Tx));
  const int vec = path == 2 ? kVec : 1;
  if (path == 2 && (h % kVec != 0 || !aligned16(dy) || !aligned16(x) ||
                    !aligned16(dx)))
    return -1;
  const int chunks = (h + 32 * vec - 1) / (32 * vec);
  int iters = 1;
  while (iters < chunks) iters *= 2;
  if (path == 2)
    return dispatch_warp_rows<Tdy, Tx, kVec>(iters, dy, x, w, dx, rows, h, eps,
                                             stream);
  return dispatch_warp_rows<Tdy, Tx, 1>(iters, dy, x, w, dx, rows, h, eps,
                                        stream);
}

// The forward's paths, as launch_bwd_path's on x's and y's types.
template <typename Tin, typename Tout>
int launch_fwd_path(int path, const void* x, const float* w, const float* b,
                    void* y, long long rows, int h, float eps,
                    cudaStream_t stream) {
  if (path == 0) return launch_fwd<Tin, Tout>(x, w, b, y, rows, h, eps, stream);
  if ((path != 1 && path != 2) || h > kRegMaxH) return -1;
  constexpr int kVec = 16 / static_cast<int>(
      sizeof(Tin) < sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  const int vec = path == 2 ? kVec : 1;
  if (path == 2 && (h % kVec != 0 || !aligned16(x) || !aligned16(y)))
    return -1;
  const int chunks = (h + 32 * vec - 1) / (32 * vec);
  int iters = 1;
  while (iters < chunks) iters *= 2;
  if (path == 2)
    return dispatch_warp_fwd<Tin, Tout, kVec>(iters, x, w, b, y, rows, h, eps,
                                              stream);
  return dispatch_warp_fwd<Tin, Tout, 1>(iters, x, w, b, y, rows, h, eps,
                                         stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. w and b are fp32 [h] or null.
// path as launch_bwd_path's, on x's and y's types (kernels/norm.py
// `ln_plan` picks it). Returns the CUDA error of the launch (0 on
// success); -1 for a dtype, or a path, the kernel does not take for these
// arguments.
extern "C" int apex_layer_norm_fwd(const void* x, const float* w,
                                   const float* b, void* y, long long rows,
                                   int h, float eps, int in_dtype,
                                   int out_dtype, int path, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_dtype == 0 && out_dtype == 0) return launch_fwd_path<float, float>(path, x, w, b, y, rows, h, eps, s);
  if (in_dtype == 0 && out_dtype == 1) return launch_fwd_path<float, bf16>(path, x, w, b, y, rows, h, eps, s);
  if (in_dtype == 1 && out_dtype == 0) return launch_fwd_path<bf16, float>(path, x, w, b, y, rows, h, eps, s);
  if (in_dtype == 1 && out_dtype == 1) return launch_fwd_path<bf16, bf16>(path, x, w, b, y, rows, h, eps, s);
  return -1;
}

// dx [rows, h] in x's dtype from dy and x [rows, h] and the fp32 weight
// [h] (or null); dtype codes as above; path as launch_bwd_path
// (kernels/norm.py `ln_plan` picks it). Returns the CUDA error of the
// launch (0 on success); -1 for a dtype, or a path, the kernel does not
// take for these arguments.
extern "C" int apex_layer_norm_bwd_dx(const void* dy, const void* x,
                                      const float* w, void* dx,
                                      long long rows, int h, float eps,
                                      int dy_dtype, int x_dtype, int path,
                                      void* stream) {
  if (rows <= 0) return 0;
  if (h < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dy_dtype == 0 && x_dtype == 0) return launch_bwd_path<float, float>(path, dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 0 && x_dtype == 1) return launch_bwd_path<float, bf16>(path, dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 0) return launch_bwd_path<bf16, float>(path, dy, x, w, dx, rows, h, eps, s);
  if (dy_dtype == 1 && x_dtype == 1) return launch_bwd_path<bf16, bf16>(path, dy, x, w, dx, rows, h, eps, s);
  return -1;
}
