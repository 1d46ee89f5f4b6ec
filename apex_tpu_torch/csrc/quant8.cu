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
// Quantize has two bodies; apex_quant8's path (kernels/quant.py
// `quant_plan` picks it) chooses:
//  * path 1, quant_vec_kernel, streaming: where the rows are contiguous
//    in the codes' order (n == nb * block, or one row with a ragged
//    tail), x is one flat array whose element e lies in cell (row, block)
//    e >> log2(block). Each cell is read once, as 16-byte vectors (8 bf16
//    or 4 fp32 values) by one ld.global.cs each, by a group of lanes: a
//    warp's 32 lanes hold one cell of 32 * kVPL vectors (kVPL = 1, 2 or
//    4: a 256-lane block is one vector a lane in bf16, two in fp32), or
//    32 / G cells of G vectors (smaller blocks). The absmax is taken over
//    the values in registers, as an integer max of their |x| bits (whose
//    order is |x|'s, a NaN above all: the NaN flag comes with it) within
//    the lane, then across the group (__reduce_max_sync for a whole warp,
//    __shfl_xor_sync below that); the codes come from the same registers,
//    stored 8 bytes (bf16) or 4 bytes (fp32) a vector. A code is
//    rint(x * RN(1 / scale)), clipped, rounded by adding 1.5 * 2^23,
//    except in a vector where a product lies within 2^-14 of a
//    half-integer: there the IEEE division of path 0 decides
//    (vector_codes below shows that the two cannot differ elsewhere;
//    path 0's division, rintf and float-to-int conversion execute at a
//    quarter of the FMA rate, and the same body dividing every code was
//    the slower at each shape timed: PERF.md section 6). Given scales are
//    read once a cell through the read-only cache, with no absmax. A
//    vector that runs past n (the ragged tail of a one-row call) reads one
//    element at a time and its missing lanes as 0, coded like the padding
//    lanes of path 0. A warp loads kVecsAhead vectors (over kVecsAhead /
//    kVPL cells' groups) before any arithmetic, and the grid is what the
//    card holds resident (occupancy times SMs), striding over the cells.
//    A max is exact in any order, the scale's division is path 0's and
//    each code equals path 0's, so codes and scales are bit-identical to
//    path 0 and the plain version (a non-finite block keeps its NaN scale
//    and path 0's codes). Paths 2 and 3 are planted faults of this body
//    for the card checks (computed scales: the absmax without the cell's
//    last vector; given scales: the neighbouring cell's scale).
//  * path 0, quant_kernel, the first design: one warp per (row, block)
//    reading the block's lanes one 2- or 4-byte element a thread (x read
//    twice: once for the absmax, once for the codes), one code byte a
//    thread; eight warps a CUDA block. It takes ragged rows, blocks that
//    are not a power of two, hold less than a vector or more than 4 a
//    lane, and pointers off a 16-byte boundary.
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
#include <float.h>
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

// Blocks of `kernel` the current device holds resident (occupancy times
// SMs), read once a device into `cached`; -1 on an error.
template <typename Kernel>
int resident_blocks(Kernel kernel, int (&cached)[kMaxDevices]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
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
  static int cached[kMaxDevices] = {};
  const int resident =
      resident_blocks(dequant_vec_kernel<C, O, kFault>, cached);
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

// --------------------------------------------- quantize path 1: streaming

constexpr int kVecsAhead = 4;  // x vectors a lane loads before its arithmetic
constexpr int kMaxVPL = 4;     // most vectors of one cell a lane holds
// planted faults of the streaming quantize (paths 2 and 3)
constexpr int kShortAbsmax = 1;     // computed: absmax without the last vector
constexpr int kNeighbourGiven = 2;  // given: the scale of cell index ^ 1

// 16 bytes of x -> float v[16 / sizeof(T)] (a bf16 is the upper half of
// its fp32 value)
__device__ __forceinline__ void widen_x(int4 raw, float (&v)[8]) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen_x(int4 raw, float (&v)[4]) {
  v[0] = __int_as_float(raw.x);
  v[1] = __int_as_float(raw.y);
  v[2] = __int_as_float(raw.z);
  v[3] = __int_as_float(raw.w);
}

// The vector of x at element e where it runs past total: the elements
// before total, zeros after (the padding lanes)
__device__ __forceinline__ int4 load_tail(const float* x, long long e,
                                          long long total) {
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k < total) w[k] = __float_as_int(x[e + k]);
  return make_int4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ int4 load_tail(const __nv_bfloat16* x, long long e,
                                          long long total) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (e + k < total)
      w[k >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(x[e + k]))
                   << (16 * (k & 1));
  return make_int4(w[0], w[1], w[2], w[3]);
}

constexpr float kRound = 12582912.f;  // 1.5 * 2^23: y + kRound is rint(y)

// The V codes of one vector, little-endian in V / 4 words, each
// code(v[k], scale), without the IEEE division where that cannot change
// it. inv = RN(1 / scale), a normal float (`fast`; else code()
// throughout): y = RN(v * inv) is t = v / scale times (1 + d), |d| <=
// 2^-23 + 2^-48. Where |y| < 128 (so |t| < 128.0001), |y - t| < 2^-15.98
// and RN(t) lies within 2^-17 of t: RN(t) and y are less than 2^-15
// apart, so where y is more than 2^-15 from every half-integer both
// round to the same integer. Where |y| >= 128, |t| > 127.99 and both
// clip to the same +-127 (kClip: given scales; a computed scale keeps
// |y| <= 127 (1 + 2^-22)). rint(y) is the integer part of y + 1.5 * 2^23
// (ulp 1 there, ties to even, as 1.5 * 2^23 is even), whose low byte is
// the code; its distance from y shows a y within 2^-14 of a
// half-integer, and a lane holding one takes code() for its vector. NaN
// x clips to -127 on both routes. No rintf or float-to-int conversion
// is left in the common case: they execute at a quarter of the rate.
template <bool kClip, int N>
__device__ __forceinline__ void vector_codes(const float (&v)[N], float scale,
                                             float inv, bool fast,
                                             uint32_t (&w)[N / 4]) {
  if (fast) {
    uint32_t b[N];
    float near = 0.f;  // largest |y - rint(y)|
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float y = __fmul_rn(v[k], inv);
      if (kClip) y = fminf(fmaxf(y, -kQmax), kQmax);
      const float t = __fadd_rn(y, kRound);
      near = fmaxf(near, fabsf(__fsub_rn(y, __fsub_rn(t, kRound))));
      b[k] = __float_as_uint(t);
    }
    if (near < 0.5f - 0x1p-14f) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k)
        w[k] = __byte_perm(__byte_perm(b[4 * k], b[4 * k + 1], 0x0040),
                           __byte_perm(b[4 * k + 2], b[4 * k + 3], 0x0040),
                           0x5410);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    w[k] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[k] |= static_cast<uint32_t>(static_cast<uint8_t>(
                  code(v[4 * k + j], scale)))
              << (8 * j);
  }
}

// the words of one vector's codes to q: 8 bytes (V = 8) or 4 (V = 4)
__device__ __forceinline__ void store_words(int8_t* q, const uint32_t (&w)[2]) {
  *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void store_words(int8_t* q, const uint32_t (&w)[1]) {
  *reinterpret_cast<uint32_t*>(q) = w[0];
}

// x's first `total` elements (a multiple of the vector but for a one-row
// call's ragged tail) quantized into `stored` codes (the cells' lanes,
// nb * block a row) and stored / block scales; `lanes` (a power of two,
// at most 32) hold one cell: block / V vectors over min(32, block / V)
// lanes, kVPL = max(1, block / (32 V)) vectors a lane. A slab is 32 * kVPL
// vectors, one warp's load of whole cells.
template <typename T, bool kGiven, int kVPL, int kFault>
__global__ void __launch_bounds__(kThreads)
quant_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scales, long long total,
                 long long stored, int log2_block, int lanes) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kSlabs = kVecsAhead / kVPL;  // slabs a warp loads ahead
  constexpr int kSlabVecs = 32 * kVPL;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  const long long nvec = stored / V;  // vectors of codes (x's, padded)
  const long long nslabs = (nvec + kSlabVecs - 1) / kSlabVecs;
  const long long ncells = stored >> log2_block;
  const long long cell_vecs_mask = (1ll << log2_block) / V - 1;
  const long long per_block = static_cast<long long>(kWarpsPerBlock) * kSlabs;
  for (long long s0 = static_cast<long long>(blockIdx.x) * per_block;
       s0 < nslabs; s0 += static_cast<long long>(gridDim.x) * per_block) {
    int4 raw[kSlabs][kVPL];
#pragma unroll
    for (int k = 0; k < kSlabs; ++k) {
      const long long slab = s0 + k * kWarpsPerBlock + warp;
#pragma unroll
      for (int u = 0; u < kVPL; ++u) {
        const long long i = slab * kSlabVecs + u * 32 + lane;
        const long long e = i * V;
        raw[k][u] = make_int4(0, 0, 0, 0);
        if (slab < nslabs && i < nvec) {
          if (e + V <= total)
            raw[k][u] = __ldcs(x4 + i);
          else if (e < total)  // the ragged tail of a one-row call
            raw[k][u] = load_tail(x, e, total);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kSlabs; ++k) {
      const long long slab = s0 + k * kWarpsPerBlock + warp;
      if (slab >= nslabs) continue;  // warp-uniform
      float v[kVPL][V];
#pragma unroll
      for (int u = 0; u < kVPL; ++u) widen_x(raw[k][u], v[u]);
      const long long i0 = slab * kSlabVecs + lane;
      const bool live = i0 < nvec;  // whole groups past the codes idle
      const long long cell = (i0 * V) >> log2_block;
      float scale;
      if (kGiven) {
        long long c = cell;
        if (kFault == kNeighbourGiven) c = min(c ^ 1, ncells - 1);
        scale = live ? __ldg(scales + c) : 0.f;
      } else {
        // |x|'s bits: their integer max is the absmax's, and a NaN's
        // bits exceed every other's
        uint32_t amax = 0;
#pragma unroll
        for (int u = 0; u < kVPL; ++u) {
          const long long i = i0 + u * 32;
          if (kFault == kShortAbsmax && ((i + 1) & cell_vecs_mask) == 0)
            continue;
#pragma unroll
          for (int j = 0; j < V; ++j)
            amax = max(amax, __float_as_uint(v[u][j]) & 0x7fffffffu);
        }
        if (lanes == 32) {
          amax = __reduce_max_sync(0xffffffffu, amax);
        } else {
          for (int off = lanes >> 1; off > 0; off >>= 1)
            amax = max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        }
        scale = amax > 0x7f800000u
                    ? __int_as_float(0x7fc00000)
                    : __fdiv_rn(fmaxf(__uint_as_float(amax), 1e-12f), kQmax);
        if (live && (lane & (lanes - 1)) == 0) scales[cell] = scale;
      }
      if (!live) continue;
      const float inv = __frcp_rn(scale);
      const bool fast = inv >= FLT_MIN && inv <= FLT_MAX;  // normal, not NaN
#pragma unroll
      for (int u = 0; u < kVPL; ++u) {
        uint32_t w[V / 4];
        vector_codes<kGiven>(v[u], scale, inv, fast, w);
        store_words(q + (i0 + u * 32) * V, w);
      }
    }
  }
}

template <typename T, bool kGiven, int kVPL, int kFault>
int launch_quant_vec(const T* x, int8_t* q, float* scales, long long total,
                     long long stored, int log2_block, int lanes,
                     cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  static int cached[kMaxDevices] = {};
  const int resident =
      resident_blocks(quant_vec_kernel<T, kGiven, kVPL, kFault>, cached);
  if (resident < 1) return -1;
  const long long slabs = (stored / V + 32 * kVPL - 1) / (32 * kVPL);
  const long long per_block =
      static_cast<long long>(kWarpsPerBlock) * (kVecsAhead / kVPL);
  const long long want = (slabs + per_block - 1) / per_block;
  const int grid = static_cast<int>(want < resident ? want : resident);
  quant_vec_kernel<T, kGiven, kVPL, kFault><<<grid, kThreads, 0, s>>>(
      x, q, scales, total, stored, log2_block, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVPL>
int quant_vec_path(const T* x, int8_t* q, float* scales, bool given,
                   long long total, long long stored, int log2_block,
                   int lanes, int path, cudaStream_t s) {
  if (given && path == 1)
    return launch_quant_vec<T, true, kVPL, kNoFault>(x, q, scales, total, stored, log2_block, lanes, s);
  if (given && path == 3)
    return launch_quant_vec<T, true, kVPL, kNeighbourGiven>(x, q, scales, total, stored, log2_block, lanes, s);
  if (!given && path == 1)
    return launch_quant_vec<T, false, kVPL, kNoFault>(x, q, scales, total, stored, log2_block, lanes, s);
  if (!given && path == 2)
    return launch_quant_vec<T, false, kVPL, kShortAbsmax>(x, q, scales, total, stored, log2_block, lanes, s);
  return -1;  // path 2 plants a computed scale's fault, path 3 a given one's
}

// the streaming quantize over rows x n elements: -1 unless the rows are
// contiguous in the codes (n == nb * block, or one row), block is a power
// of two holding 1 to 32 * kMaxVPL whole 16-byte vectors of x, and x, q
// and scales lie on 16-byte boundaries
template <typename T>
int quant_stream(const T* x, int8_t* q, float* scales, bool given,
                 long long rows, int n, int nb, int block, int path,
                 cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if ((n != static_cast<long long>(nb) * block && rows != 1) || block < V ||
      block > 32 * kMaxVPL * V || (block & (block - 1)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(scales) % 16)
    return -1;
  int log2_block = 0;
  while ((1 << log2_block) < block) ++log2_block;
  const long long total = rows * n;
  const long long stored = rows * nb * static_cast<long long>(block);
  const int vecs = block / V;  // a cell's vectors
  const int lanes = vecs < 32 ? vecs : 32;
  if (vecs <= 32)
    return quant_vec_path<T, 1>(x, q, scales, given, total, stored, log2_block, lanes, path, s);
  if (vecs == 64)
    return quant_vec_path<T, 2>(x, q, scales, given, total, stored, log2_block, lanes, path, s);
  return quant_vec_path<T, 4>(x, q, scales, given, total, stored, log2_block, lanes, path, s);
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
// scales); else they are computed and written there. path 0: the first
// design (any rows, n, nb, block); path 1: the streaming body, 2 its
// planted fault on computed scales, 3 on given ones (-1 where the rows are
// not contiguous in the codes, block is not a power of two holding 1 to
// 128 vectors, or x, q or scales lies off a 16-byte boundary). Returns a
// CUDA error code (0: launched), or -1 for arguments the kernel has no
// instance for.
extern "C" int apex_quant8(const void* x, int8_t* q, float* scales,
                           long long rows, int n, int nb, int block,
                           int dtype, int given, int path, void* stream) {
  if (path < 0 || path > 3) return -1;
  if (rows <= 0 || nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path != 0) {
    if (dtype == 0)
      return quant_stream(static_cast<const float*>(x), q, scales, given != 0,
                          rows, n, nb, block, path, s);
    if (dtype == 1)
      return quant_stream(static_cast<const __nv_bfloat16*>(x), q, scales,
                          given != 0, rows, n, nb, block, path, s);
    return -1;
  }
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
