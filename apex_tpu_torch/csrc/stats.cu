// Multi-tensor numerics statistics for Hopper (sm_90a), bound to Python
// with ctypes: the per-tensor sums behind telemetry/numerics.py's
// TensorStats (K7).
//
// The port's counterpart of apex_tpu/telemetry/numerics.py `_raw_sums`
// (:82-102), jnp reductions that XLA fuses into the step (no Pallas
// kernel). For each element x of each tensor (fp32, bf16 or fp16, widened
// to fp32), with a = |x| where x is finite and 0 where it is not, and 0
// where it is an fp32 subnormal (below 2^-126: XLA's CPU and TPU backends
// flush those, so the JAX package counts them as zeros):
//   sumsq      += a * a                       (fp32)
//   absmax      = max(absmax, a)              (an integer max of a's bits:
//                                              a >= 0, so the bits order
//                                              as the values)
//   zeros      += x finite and a == 0
//   nonfinite  += !isfinite(x)
//   fp16_over  += a > 65504                   fp16_under += 0 < a < 2^-14
//   bf16_over  += a > 3.3895313892515355e38   bf16_under += 0 < a < 2^-126
// (numerics.py:53-56's thresholds). The counts are exact 64-bit integers.
//
// Each tensor belongs to a group (a module prefix); the group's row is
// the fold of its tensors' rows in table order, as numerics.py's
// `tree_stats` folds its leaves: sumsq added in fp32, absmax maxed, the
// counts added. A list longer than one launch's table runs as several
// launches on one stream, in order, each adding into the same group rows,
// so the fold keeps the leaves' order across launches.
//
// Bound on the H100: memory. Each element is read once (GPT-2 345M's
// 406 M gradients: 0.81 GB in bf16, >= 243 us at 3.35 TB/s; 1.62 GB in
// fp32, >= 485 us).
//
// Design: a table of up to kMaxTensors = 64 tensors of any of the three
// dtypes, cut into chunks of kThreads * kPer * kBatches elements; a
// resident grid walks the chunks grid-stride. A thread loads kPer
// elements of its chunk at once, as 16-byte words where the tensor is
// 16-byte aligned, else kThreads apart (coalesced scalar loads),
// kBatches times (chunk_acc), keeps its own sums, and the block folds
// them in a fixed
// order (each warp's: a butterfly of fp32 adds for the sum of squares,
// the hardware's integer warp reductions for absmax and the counts; then
// the warps in order, by thread 0, one barrier a chunk over a double
// buffer) into one partial of 8 words a chunk in the scratch. The block
// that writes a tensor's last partial (an integer count a tensor, no
// floating-point atomics, as novograd.cu's norms) sums that tensor's
// partials in a fixed order (a thread's strided share in turn, then the
// block as above) into the tensor's row, so the tensors finish on many
// SMs while others stream; the block that writes the last row folds the
// rows into their groups, one thread a group, in table order. The order
// depends on the sizes only, never on which block ran what, so two runs
// give the same bits. (The first design folded every tensor in the one
// last block: 2531 us at GPT-2's list, its serial tail most of it.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;      // elements a thread loads at once
constexpr int kBatches = 32;  // such loads a thread makes in a chunk
constexpr int kVecBatches = 4;  // batches read together as 16-byte words
constexpr long long kBatch = static_cast<long long>(kThreads) * kPer;
constexpr long long kChunk = kBatch * kBatches;
constexpr int kMaxTensors = 64;
constexpr int kWords = 8;  // a partial: sumsq bits, absmax bits, 6 counts
constexpr int kCounts = 6;

// dtype codes (kernels/stats.py DTYPES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

// planted faults (fault codes 1 and 2; no caller passes them): each
// tensor's last chunk's non-finite count dropped; each tensor's first
// chunk counted twice
constexpr int kNonfiniteDropped = 1;
constexpr int kChunkTwice = 2;


struct Table {
  const void* x[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int dtype[kMaxTensors];
  int group[kMaxTensors];
  int n;
  int live;  // tensors with at least one chunk (one row each)
};

struct Acc {
  float sumsq;
  unsigned absmax;
  unsigned c[kCounts];  // zeros, nonfinite, fp16 over, under, bf16 over, under
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// bits of |a| at the thresholds
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kFp16MaxBits = 0x477fe000u;   // 65504
constexpr unsigned kFp16TinyBits = 0x38800000u;  // 2^-14
constexpr unsigned kBf16MaxBits = 0x7f7f0000u;   // 3.3895313892515355e38
constexpr unsigned kBf16TinyBits = 0x00800000u;  // 2^-126

// One element, on the bits of |x| (the same tests as the floats: a >= 0,
// so its bits order as its values): a is |x| where x is finite and 0
// where it is not, and 0 where it is an fp32 subnormal.
__device__ __forceinline__ void take(Acc& acc, float x) {
  const unsigned bits = __float_as_uint(x) & 0x7fffffffu;
  const bool finite = bits < kInfBits;
  const unsigned ab = (finite && bits >= kBf16TinyBits) ? bits : 0u;
  const float a = __uint_as_float(ab);
  acc.sumsq = __fadd_rn(acc.sumsq, __fmul_rn(a, a));
  acc.absmax = max(acc.absmax, ab);
  acc.c[0] += finite && ab == 0u;
  acc.c[1] += !finite;
  acc.c[2] += ab > kFp16MaxBits;
  acc.c[3] += ab - 1u < kFp16TinyBits - 1u;  // 0 < a < 2^-14
  acc.c[4] += ab > kBf16MaxBits;
  acc.c[5] += ab - 1u < kBf16TinyBits - 1u;  // 0 < a < 2^-126
}

// 16-byte words of raw elements, taken in element order (a word's low
// half first): fp32 as is, bf16 by moving its bits to the top of an fp32,
// fp16 widened.
__device__ __forceinline__ void take_word(Acc& acc, unsigned u, float) {
  take(acc, __uint_as_float(u));
}
__device__ __forceinline__ void take_word(Acc& acc, unsigned u,
                                          __nv_bfloat16) {
  take(acc, __uint_as_float(u << 16));
  take(acc, __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void take_word(Acc& acc, unsigned u, __half) {
  take(acc, __half2float(__ushort_as_half(static_cast<unsigned short>(u))));
  take(acc, __half2float(__ushort_as_half(
                static_cast<unsigned short>(u >> 16))));
}

template <typename T>
__device__ __forceinline__ void take_vec(Acc& acc, const uint4& w) {
  take_word(acc, w.x, T());
  take_word(acc, w.y, T());
  take_word(acc, w.z, T());
  take_word(acc, w.w, T());
}

// A thread's share of one chunk of a tensor of element type T: kBatches
// batches of kThreads * kPer elements. Where the tensor starts on a
// 16-byte boundary, kVecBatches full batches at a time are read as
// 16-byte words, a thread's kPer consecutive elements of each batch
// (every load of the group issued before the first is used); otherwise,
// and for what is left, a thread loads kPer elements kThreads apart
// (immediate offsets from one pointer, no bounds test in a full batch).
// Either way the order of a thread's additions is fixed by the sizes and
// the tensor's alignment.
template <typename T>
__device__ __forceinline__ void chunk_acc(const T* __restrict__ x,
                                          long long local, long long size,
                                          Acc& acc) {
  constexpr int kVec = kPer * static_cast<int>(sizeof(T)) / 16;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  int b = 0;
  if (aligned)
    for (; b + kVecBatches <= kBatches; b += kVecBatches) {
      const long long start = local * kChunk + b * kBatch;
      if (size - start < kVecBatches * kBatch) break;
      const uint4* const q = reinterpret_cast<const uint4*>(x + start);
      uint4 w[kVecBatches * kVec];
#pragma unroll
      for (int j = 0; j < kVecBatches; ++j)
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          w[j * kVec + v] = q[(j * kThreads + threadIdx.x) * kVec + v];
#pragma unroll
      for (int j = 0; j < kVecBatches * kVec; ++j) take_vec<T>(acc, w[j]);
    }
  for (; b < kBatches; ++b) {
    const long long start = local * kChunk + b * kBatch;
    if (start >= size) break;  // the same for the whole block
    const T* const p = x + start + threadIdx.x;
    T raw[kPer];
    if (size - start >= kBatch) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) raw[u] = p[u * kThreads];
#pragma unroll
      for (int u = 0; u < kPer; ++u) take(acc, widen(raw[u]));
    } else {
      const int rem = static_cast<int>(size - start);
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (static_cast<int>(threadIdx.x) + u * kThreads < rem)
          raw[u] = p[u * kThreads];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (static_cast<int>(threadIdx.x) + u * kThreads < rem)
          take(acc, widen(raw[u]));
    }
  }
}

// A warp's fields folded in a fixed order, valid in lane 0: the sum of
// squares by a butterfly of fp32 adds, absmax and the counts by the
// hardware's integer warp reductions.
__device__ __forceinline__ void warp_fold(Acc& acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc.sumsq = __fadd_rn(acc.sumsq,
                          __shfl_xor_sync(0xffffffffu, acc.sumsq, o));
  acc.absmax = __reduce_max_sync(0xffffffffu, acc.absmax);
#pragma unroll
  for (int j = 0; j < kCounts; ++j)
    acc.c[j] = __reduce_add_sync(0xffffffffu, acc.c[j]);
}

// One chunk's partial, the block's fields folded in a fixed order: each
// warp's fold, then thread 0 adds the warps in order and writes the eight
// words. `shared` is this iteration's half of a double buffer, so one
// barrier an iteration keeps it free: a warp writes the other half next
// time, and thread 0 reads this half before it reaches the next barrier.
__device__ __forceinline__ void block_partial(Acc acc, unsigned* shared,
                                              unsigned* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  warp_fold(acc);
  if (lane == 0) {
    unsigned* w = shared + warp * kWords;
    w[0] = __float_as_uint(acc.sumsq);
    w[1] = acc.absmax;
#pragma unroll
    for (int j = 0; j < kCounts; ++j) w[2 + j] = acc.c[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ss = __uint_as_float(shared[0]);
    unsigned am = shared[1];
    unsigned c[kCounts];
#pragma unroll
    for (int j = 0; j < kCounts; ++j) c[j] = shared[2 + j];
    for (int w = 1; w < kWarps; ++w) {
      const unsigned* x = shared + w * kWords;
      ss = __fadd_rn(ss, __uint_as_float(x[0]));
      am = max(am, x[1]);
#pragma unroll
      for (int j = 0; j < kCounts; ++j) c[j] += x[2 + j];
    }
    out[0] = __float_as_uint(ss);
    out[1] = am;
#pragma unroll
    for (int j = 0; j < kCounts; ++j) out[2 + j] = c[j];
  }
}

// Tensor k's row in fixed order, in thread 0: its chunks' partials, a
// thread's strided share in turn, then the block's fold (each warp's, the
// warps in order), written as 8 words into rows[8 k] (counts in 32 bits:
// a tensor holds fewer than 2^32 elements). Every thread calls it.
__device__ void finish_tensor(const Table& t, int k, int fault,
                              const unsigned* __restrict__ partials,
                              unsigned* __restrict__ rows,
                              unsigned* shared) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long first = t.first_chunk[k], end = t.first_chunk[k + 1];
  Acc acc{0.f, 0u, {0u, 0u, 0u, 0u, 0u, 0u}};
  for (long long c = first + threadIdx.x; c < end; c += kThreads) {
    const unsigned* const p = partials + c * kWords;
    const int times = (fault == kChunkTwice && c == first) ? 2 : 1;
    for (int r = 0; r < times; ++r) {
      acc.sumsq = __fadd_rn(acc.sumsq, __uint_as_float(__ldcg(p)));
      acc.absmax = max(acc.absmax, __ldcg(p + 1));
#pragma unroll
      for (int q = 0; q < kCounts; ++q) {
        if (q == 1 && fault == kNonfiniteDropped && c == end - 1) continue;
        acc.c[q] += __ldcg(p + 2 + q);
      }
    }
  }
  warp_fold(acc);
  __syncthreads();  // shared free from its last use
  if (lane == 0) {
    unsigned* w = shared + warp * kWords;
    w[0] = __float_as_uint(acc.sumsq);
    w[1] = acc.absmax;
#pragma unroll
    for (int j = 0; j < kCounts; ++j) w[2 + j] = acc.c[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ss = __uint_as_float(shared[0]);
    unsigned am = shared[1];
    unsigned c[kCounts];
#pragma unroll
    for (int j = 0; j < kCounts; ++j) c[j] = shared[2 + j];
    for (int w = 1; w < kWarps; ++w) {
      const unsigned* x = shared + w * kWords;
      ss = __fadd_rn(ss, __uint_as_float(x[0]));
      am = max(am, x[1]);
#pragma unroll
      for (int j = 0; j < kCounts; ++j) c[j] += x[2 + j];
    }
    unsigned* out = rows + k * kWords;
    out[0] = __float_as_uint(ss);
    out[1] = am;
#pragma unroll
    for (int j = 0; j < kCounts; ++j) out[2 + j] = c[j];
  }
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const __grid_constant__ Table t, int fault,
             unsigned* __restrict__ partials, unsigned* __restrict__ rows,
             unsigned* __restrict__ chunks_done,
             unsigned* __restrict__ tensors_done, float* __restrict__ sums,
             unsigned long long* __restrict__ counts) {
  __shared__ unsigned shared[2][kWarps * kWords];
  __shared__ unsigned fold[kWarps * kWords];
  __shared__ bool finisher, last;
  if (threadIdx.x == 0) last = false;
  const long long chunks = t.first_chunk[t.n];
  int k = 0, half = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x, half ^= 1) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long local = c - t.first_chunk[k];
    const long long size = t.size[k];
    const int dtype = t.dtype[k];
    const void* const x = t.x[k];
    Acc acc{0.f, 0u, {0u, 0u, 0u, 0u, 0u, 0u}};
    // one branch a chunk on the dtype, so a batch's loads issue back to
    // back (a branch between them would wait for each before the next)
    if (dtype == kF32)
      chunk_acc(static_cast<const float*>(x), local, size, acc);
    else if (dtype == kBF16)
      chunk_acc(static_cast<const __nv_bfloat16*>(x), local, size, acc);
    else
      chunk_acc(static_cast<const __half*>(x), local, size, acc);
    block_partial(acc, shared[half], partials + c * kWords);
    // the block that writes a tensor's last partial finishes its row
    if (threadIdx.x == 0) {
      __threadfence();  // the partial before its count
      const unsigned n_chunks =
          static_cast<unsigned>(t.first_chunk[k + 1] - t.first_chunk[k]);
      finisher = atomicAdd(chunks_done + k, 1u) == n_chunks - 1;
    }
    __syncthreads();
    if (finisher) {
      __threadfence();
      finish_tensor(t, k, fault, partials, rows, fold);
      if (threadIdx.x == 0) {
        __threadfence();  // the row before its count
        last = atomicAdd(tensors_done, 1u) ==
               static_cast<unsigned>(t.live) - 1;
      }
    }
  }
  __syncthreads();
  if (!last) return;
  // the block that finished the last row folds the rows into the groups
  // in table order: a group's tensors all by one thread, in order
  __threadfence();
  for (int j = 0; j < t.n; ++j) {
    const int g = t.group[j];
    if (g % kThreads != static_cast<int>(threadIdx.x) ||
        t.first_chunk[j + 1] == t.first_chunk[j])
      continue;
    const unsigned* const row = rows + j * kWords;
    sums[2 * g] = __fadd_rn(sums[2 * g], __uint_as_float(__ldcg(row)));
    sums[2 * g + 1] = __uint_as_float(
        max(__float_as_uint(sums[2 * g + 1]), __ldcg(row + 1)));
#pragma unroll
    for (int q = 0; q < kCounts; ++q)
      counts[kCounts * g + q] += __ldcg(row + 2 + q);
  }
}

int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, reinterpret_cast<const void*>(stats_kernel), kThreads,
            0) != cudaSuccess ||
        sms * per_sm < 1)
      return -1;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// Statistics of the n (1..64) tensors x[k] of sizes[k] elements
// (dtypes[k] 0 fp32, 1 bf16, 2 fp16), each folded into group groups[k]:
// sums[2 g] (fp32 sum of squares of the finite elements) and sums[2 g + 1]
// (fp32 absmax of the finite elements) and counts[6 g .. 6 g + 5] (uint64:
// zeros, non-finite, fp16 over- and underflows, bf16 over- and
// underflows) are added to, in the tensors' order; the caller zeroes
// them before a list's first launch. scratch holds scratch_len 32-bit
// words, all 0 (kernels/stats.py `scratch_words`): 8 a chunk of `CHUNK`
// elements of each tensor, 8 a tensor's row, a count a tensor and the
// rows' count. fault: 0, or a planted fault (1
// each tensor's last chunk's non-finite count dropped, 2 each tensor's
// first chunk counted twice). Returns the CUDA error of the launch (0 on
// success); -1 for a count, size (2^32 elements or more), dtype, scratch
// or fault it does not take.
extern "C" int apex_multi_tensor_stats(void* const* x, const long long* sizes,
                                       const int* dtypes, const int* groups,
                                       int n, float* sums,
                                       unsigned long long* counts,
                                       unsigned* scratch,
                                       long long scratch_len, int fault,
                                       void* stream) {
  if (n < 1 || n > kMaxTensors || fault < 0 || fault > 2 || sums == nullptr ||
      counts == nullptr || scratch == nullptr || scratch_len < 1)
    return -1;
  Table t;
  t.n = n;
  t.live = 0;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] < 0 || sizes[k] >= (1LL << 32) || groups[k] < 0 ||
        dtypes[k] < kF32 ||
        dtypes[k] > kF16 || (sizes[k] > 0 && x[k] == nullptr))
      return -1;
    t.x[k] = x[k];
    t.size[k] = sizes[k];
    t.dtype[k] = dtypes[k];
    t.group[k] = groups[k];
    t.first_chunk[k + 1] = t.first_chunk[k] + (sizes[k] + kChunk - 1) / kChunk;
    t.live += sizes[k] > 0;
  }
  const long long chunks = t.first_chunk[n];
  if (chunks == 0) return 0;
  // partials, the tensors' rows, their chunk counts, the rows' count
  if (chunks * kWords + n * (kWords + 1) + 1 > scratch_len) return -1;
  const int resident = resident_blocks();
  if (resident < 1) return -1;
  const int grid = static_cast<int>(chunks < resident ? chunks : resident);
  unsigned* const rows = scratch + chunks * kWords;
  unsigned* const chunks_done = rows + n * kWords;
  stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, fault, scratch, rows, chunks_done, chunks_done + n, sums, counts);
  return static_cast<int>(cudaGetLastError());
}
