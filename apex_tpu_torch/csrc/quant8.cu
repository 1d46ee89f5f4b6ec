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
// codes; eight warps a CUDA block (a simple first version: 16-byte
// accesses are left for a later change).
//
// Dequantize has two bodies; apex_dequant8's path (kernels/quant.py
// `dequant_plan` picks it) chooses:
//  * path 1, dequant_vec_kernel, streaming: where the output rows are
//    contiguous in the codes' order (n == nb * block, or one row with a
//    ragged tail), the codes are one flat array and element e has the
//    scale of block e >> log2(block). A thread reads 16 bytes of codes
//    with one ld.global.cs (16 int8 or 4 int32 codes: block, a power of
//    two, is a multiple of that, so a vector lies in one block and reads
//    its scale once, through the read-only cache) and writes them with
//    16-byte stores (int8 -> bf16: two; -> fp32: four; int32 -> fp32:
//    one; -> bf16 one of 8 bytes); a vector that runs past n (the ragged
//    tail) is written one element at a time. A thread loads kVecUnroll
//    vectors before any arithmetic, and the grid is what the card holds
//    resident (occupancy times SMs), striding over the vectors. The
//    product is still one __fmul_rn(widen(q), scale) and bf16 pairs
//    round with __floats2bfloat162_rn (round to nearest even on each
//    element, as __float2bfloat16_rn), so it is bit-identical to path 0.
//    Paths 2 and 3 are planted faults of this body for the card checks
//    (the neighbouring block's scale; each vector read one ahead).
//  * path 0, dequant_kernel, the first design: a 2-D grid of (lane tiles
//    of 256, rows), one element a thread, a division for its block. It
//    takes ragged rows (n < nb * block with rows > 1), blocks that are
//    not a power of two or not a multiple of the vector, and pointers off
//    a 16-byte boundary.

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

// ------------------------------------------- dequantize path 1: streaming

constexpr int kVecUnroll = 4;  // vectors a thread loads before its arithmetic
constexpr int kMaxDevices = 64;
// planted faults of the streaming body (paths 2 and 3)
constexpr int kNoFault = 0;
constexpr int kNeighbourScale = 1;  // the scale of block index ^ 1
constexpr int kReadAhead = 2;       // vector i's codes from vector i + 1

// 16 bytes of codes -> float v[16 / sizeof(C)]
__device__ __forceinline__ void widen_vec(int4 raw, float (&v)[16]) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    v[k] = static_cast<float>(static_cast<int8_t>(w[k >> 2] >> (8 * (k & 3))));
}
__device__ __forceinline__ void widen_vec(int4 raw, float (&v)[4]) {
  v[0] = __int2float_rn(raw.x);
  v[1] = __int2float_rn(raw.y);
  v[2] = __int2float_rn(raw.z);
  v[3] = __int2float_rn(raw.w);
}

// N values to out[0, N) with 16-byte stores (8-byte for 4 bf16)
template <int N>
__device__ __forceinline__ void store_vec(float* out, const float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4)
    *reinterpret_cast<float4*>(out + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* out, const float (&v)[N]) {
  uint32_t w[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; k += 4)
      *reinterpret_cast<uint4*>(out + 2 * k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  }
}

// out[e] = q[e] * scales[e >> log2_block] for e < total, the codes read as
// vectors of 16 bytes (q holds nvec_q = stored / V of them, total <=
// stored)
template <typename C, typename O, int kFault>
__global__ void __launch_bounds__(kThreads)
dequant_vec_kernel(const C* __restrict__ q, const float* __restrict__ scales,
                   O* __restrict__ out, long long total, long long nvec_q,
                   int log2_block) {
  constexpr int V = 16 / sizeof(C);
  const int4* q4 = reinterpret_cast<const int4*>(q);
  const long long nvec = (total + V - 1) / V;
  const long long nblocks = (nvec_q * V) >> log2_block;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kVecUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kVecUnroll + threadIdx.x;
       base < nvec; base += stride) {
    int4 raw[kVecUnroll];
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < nvec)
        raw[u] = __ldcs(q4 + (kFault == kReadAhead ? min(i + 1, nvec_q - 1) : i));
    }
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i >= nvec) continue;
      const long long e = i * V;
      long long blk = e >> log2_block;
      if (kFault == kNeighbourScale) blk = min(blk ^ 1, nblocks - 1);
      const float scale = __ldg(scales + blk);
      float v[V];
      widen_vec(raw[u], v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = __fmul_rn(v[k], scale);
      if (e + V <= total) {
        store_vec<V>(out + e, v);
      } else {  // the ragged tail of a one-row call
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (e + k < total) store(out, e + k, v[k]);
      }
    }
  }
}

// Blocks of the kernel the current device holds resident (occupancy
// times SMs; read once a device); -1 on an error.
template <typename C, typename O, int kFault>
int resident_blocks() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dequant_vec_kernel<C, O, kFault>, kThreads, 0) !=
            cudaSuccess ||
        sms * per_sm < 1)
      return -1;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <typename C, typename O, int kFault>
int launch_vec(const C* q, const float* scales, O* out, long long total,
               long long stored, int log2_block, cudaStream_t s) {
  constexpr int V = 16 / sizeof(C);
  const int resident = resident_blocks<C, O, kFault>();
  if (resident < 1) return -1;
  const long long per_block = static_cast<long long>(kThreads) * kVecUnroll;
  const long long want = ((total + V - 1) / V + per_block - 1) / per_block;
  const int grid = static_cast<int>(want < resident ? want : resident);
  dequant_vec_kernel<C, O, kFault><<<grid, kThreads, 0, s>>>(
      q, scales, out, total, stored / V, log2_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename C, typename O>
int launch_vec_path(const C* q, const float* scales, O* out, long long total,
                    long long stored, int log2_block, int path,
                    cudaStream_t s) {
  if (path == 1)
    return launch_vec<C, O, kNoFault>(q, scales, out, total, stored, log2_block, s);
  if (path == 2)
    return launch_vec<C, O, kNeighbourScale>(q, scales, out, total, stored, log2_block, s);
  if (path == 3)
    return launch_vec<C, O, kReadAhead>(q, scales, out, total, stored, log2_block, s);
  return -1;
}

// the streaming body over rows x n elements: -1 unless the rows are
// contiguous in the codes (n == nb * block, or one row), block is a power
// of two and a multiple of the vector, and q and out lie on 16-byte
// boundaries
template <typename C>
int dequant_stream(const C* q, const float* scales, void* out, long long rows,
                   int n, int nb, int block, int out_dtype, int path,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(C);
  if ((n != static_cast<long long>(nb) * block && rows != 1) ||
      block < V || (block & (block - 1)) ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return -1;
  int log2_block = 0;
  while ((1 << log2_block) < block) ++log2_block;
  const long long total = rows * n;
  const long long stored = rows * nb * static_cast<long long>(block);
  if (out_dtype == 0)
    return launch_vec_path(q, scales, static_cast<float*>(out), total, stored,
                           log2_block, path, s);
  if (out_dtype == 1)
    return launch_vec_path(q, scales, static_cast<__nv_bfloat16*>(out), total,
                           stored, log2_block, path, s);
  return -1;
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

// path 0: the first design (any rows, n, nb, block); path 1: the
// streaming body, 2 and 3 its planted faults (-1 where the rows are not
// contiguous in the codes, block is not a power of two at least the
// vector, or q or out lies off a 16-byte boundary).
extern "C" int apex_dequant8(const void* q, const float* scales, void* out,
                             long long rows, int n, int nb, int block,
                             int code_dtype, int out_dtype, int path,
                             void* stream) {
  if (path < 0 || path > 3) return -1;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path != 0) {
    if (code_dtype == 0)
      return dequant_stream(static_cast<const int8_t*>(q), scales, out, rows,
                            n, nb, block, out_dtype, path, s);
    if (code_dtype == 1)
      return dequant_stream(static_cast<const int32_t*>(q), scales, out, rows,
                            n, nb, block, out_dtype, path, s);
    return -1;
  }
  if (code_dtype == 0)
    return launch_dequant(static_cast<const int8_t*>(q), scales, out, rows, n,
                          nb, block, out_dtype, s);
  if (code_dtype == 1)
    return launch_dequant(static_cast<const int32_t*>(q), scales, out, rows,
                          n, nb, block, out_dtype, s);
  return -1;
}
