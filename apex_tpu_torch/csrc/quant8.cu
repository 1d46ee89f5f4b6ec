// Blockwise symmetric int8 quantize and dequantize for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces apex_tpu/parallel/compression.py `_quant_kernel` and
// `_dequant_kernel` (launched by `_quantize_pallas` / `_dequantize_pallas`
// under `quantize_blockwise`, `quantize_rows_blockwise` and their
// inverses). Each row of x [rows, n] (fp32 or bf16) is cut into nb
// blocks of B lanes, the last one zero-padded past n; a block's scale is
// max(absmax, 1e-12) / 127 and its codes clip(rint(x / scale), -127,
// 127) as int8 [rows, nb, B] with fp32 scales [rows, nb]. Dequantize is
// q * scale, written as [rows, n] fp32 or bf16 (the ragged tail's
// padding lanes are not written).
//
// Exactness: the results are bit-identical to the plain version and to
// the JAX package's jnp oracle. The division is IEEE (__fdiv_rn; the
// library is never built with --use_fast_math), rintf rounds half to
// even as jnp.round and torch.round do, the absmax is a max (exact in
// any order), and the bf16 output of dequantize is the fp32 product
// rounded to nearest even, as a cast after it would give. The TPU kernel
// takes the scales from outside; this one computes them too (the absmax
// fused in, one read of x) unless it is given them: the data-parallel
// collectives quantize against shared (pmax-combined) scales, so every
// replica lands on one grid. Dequantize takes int8 codes or the int32
// partial sums of those collectives (at most 127 * world in magnitude,
// so __int2float_rn is exact there), one kernel templated on the code
// type. Non-finite inputs give a NaN scale and unspecified codes (the
// serving engine zeroes such rows).
//
// Bound on the H100: memory. Quantize reads 4 (fp32) or 2 (bf16) bytes
// a lane and writes 1 plus 4 a block; dequantize reads 1 (int8) or 4
// (int32) plus 4 a block and writes 4 or 2. At the serving path's
// [16384, 256] bf16 rows that is 12.6 MB each way, under 4 us at 3.35
// TB/s; one position per slot ([8, 256]) is a launch. A 51.5 M-lane
// GPT-2 gradient bucket moves 258 MB through quantize and 412 MB through
// the int32 dequantize.
//
// Design: quantize runs one warp per (row, block): the warp reads the
// block's lanes with consecutive threads on consecutive elements, takes
// the absmax with shuffles (or reads the given scale), and writes the
// codes; eight warps a CUDA block. Dequantize runs a 2-D grid of (lane
// tiles of 256, rows), one element a thread. Both are simple first
// versions: 16-byte vector loads and stores are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kQmax = 127.f;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t code(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -kQmax), kQmax);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ float widen(int8_t q) { return static_cast<float>(q); }
__device__ __forceinline__ float widen(int32_t q) { return __int2float_rn(q); }

// kGiven: the block's scale is read from scales (shared scales), not
// computed and written there
template <typename T, bool kGiven>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scales,
             long long rows, int n, int nb, int block) {
  const long long cell = static_cast<long long>(blockIdx.x) * kWarpsPerBlock
                         + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (cell >= rows * nb) return;
  const long long row = cell / nb;
  const int lo = static_cast<int>(cell % nb) * block;
  const T* xr = x + row * n;
  int8_t* qr = q + cell * block;
  if (kGiven) {
    const float scale = scales[cell];
    for (int j = lane; j < block; j += 32) {
      const int c = lo + j;
      qr[j] = code(c < n ? load(xr, c) : 0.f, scale);
    }
    return;
  }
  float amax = 0.f;
  bool nan = false;
  for (int j = lane; j < block; j += 32) {
    const int c = lo + j;
    if (c < n) {
      const float a = fabsf(load(xr, c));
      nan |= a != a;
      amax = fmaxf(amax, a);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  nan = __any_sync(0xffffffffu, nan);
  const float scale =
      nan ? __int_as_float(0x7fc00000) : __fdiv_rn(fmaxf(amax, 1e-12f), kQmax);
  if (lane == 0) scales[cell] = scale;
  for (int j = lane; j < block; j += 32) {
    const int c = lo + j;
    qr[j] = code(c < n ? load(xr, c) : 0.f, scale);
  }
}

template <typename C, typename O>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const C* __restrict__ q, const float* __restrict__ scales,
               O* __restrict__ out, long long rows, int n, int nb, int block) {
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < n;
         c += gridDim.x * kThreads) {
      const int blk = c / block;
      const float v = __fmul_rn(widen(q[(row * nb + blk) * block + c % block]),
                                scales[row * nb + blk]);
      store(out, row * n + c, v);
    }
  }
}

template <typename T>
int launch_quant(const T* x, int8_t* q, float* scales, bool given,
                 long long rows, int n, int nb, int block, cudaStream_t s) {
  const long long cells = rows * nb;
  const unsigned grid = static_cast<unsigned>((cells + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (given)
    quant_kernel<T, true><<<grid, kThreads, 0, s>>>(x, q, scales, rows, n, nb, block);
  else
    quant_kernel<T, false><<<grid, kThreads, 0, s>>>(x, q, scales, rows, n, nb, block);
  return static_cast<int>(cudaGetLastError());
}

template <typename C>
int launch_dequant(const C* q, const float* scales, void* out, long long rows,
                   int n, int nb, int block, int out_dtype, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  if (out_dtype == 0)
    dequant_kernel<C, float><<<grid, kThreads, 0, s>>>(
        q, scales, static_cast<float*>(out), rows, n, nb, block);
  else if (out_dtype == 1)
    dequant_kernel<C, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        q, scales, static_cast<__nv_bfloat16*>(out), rows, n, nb, block);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; code dtypes: 0 = int8, 1 =
// int32. With given != 0 the block scales are read from scales (shared
// scales); else they are computed and written there. Returns a CUDA
// error code (0: launched), or -1 for a dtype the kernel has no instance
// for.
extern "C" int apex_quant8(const void* x, int8_t* q, float* scales,
                           long long rows, int n, int nb, int block,
                           int dtype, int given, void* stream) {
  if (rows <= 0 || nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quant(static_cast<const float*>(x), q, scales, given != 0,
                        rows, n, nb, block, s);
  if (dtype == 1)
    return launch_quant(static_cast<const __nv_bfloat16*>(x), q, scales,
                        given != 0, rows, n, nb, block, s);
  return -1;
}

extern "C" int apex_dequant8(const void* q, const float* scales, void* out,
                             long long rows, int n, int nb, int block,
                             int code_dtype, int out_dtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_dtype == 0)
    return launch_dequant(static_cast<const int8_t*>(q), scales, out, rows, n,
                          nb, block, out_dtype, s);
  if (code_dtype == 1)
    return launch_dequant(static_cast<const int32_t*>(q), scales, out, rows,
                          n, nb, block, out_dtype, s);
  return -1;
}
