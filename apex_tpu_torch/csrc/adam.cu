// Multi-tensor Adam/AdamW update for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces apex_tpu/kernels/optim.py `_adam_kernel` (launched by
// `fused_adam_update`), which updates one flat fp32 buffer per call; the
// JAX FusedAdam computes the same update with `ops/multi_tensor.py`
// `multi_tensor_adam`, a jnp loop over the parameter tensors that XLA
// fuses. Per element, in fp32 and in this order:
//   mode 0 (L2):   g = g + wd * p
//   m = b1 * m + (1 - b1) * g;   v = b2 * v + (1 - b2) * g * g
//   update = (m / bc1) / (sqrt(v / bc2) + eps)
//   mode 1 (AdamW, wd != 0): update = update + wd * p
//   p = p - lr * update
// with (1 - b1) and (1 - b2) rounded to fp32 from double by the caller,
// as JAX rounds its weakly typed Python floats. The whole update is
// skipped, leaving p, m and v untouched, when the device-side fp32
// `noop` flag is non-zero (the JAX op's `_keep`, without a branch on the
// host).
//
// Bound on the H100: memory. 28 bytes per parameter (read g, p, m, v;
// write p, m, v) and ~15 flops: 30.8 GB, >= 9.2 ms at 3.35 TB/s for
// TinyLlama-1.1B's 1.10 B parameters.
//
// Both designs take the reference's multi_tensor_apply: eager PyTorch
// has no XLA to fuse a per-tensor loop, which for the model's 179 tensors
// would be ~2,000 small launches a step, so one launch updates up to
// kMaxTensors = 64 tensors: a table of their g, p, m, v pointers, sizes,
// chunk counts and heads travels by value as the kernel's parameter
// (3.6 KB, under the 4 KB parameter limit, and captured as it is by a
// CUDA graph), and blocks walk the chunks grid-stride, finding a chunk's
// tensor from the table's prefix count of chunks. Every operation is
// written with a round-to-nearest intrinsic (adam_update), so nvcc does
// not contract it into an FMA and no division becomes a reciprocal
// product: both designs give the oracle's fp32 results bit for bit.
//
// The streaming body (path 1, adam_vec_kernel): each tensor is a scalar
// head up to the first element where g, p, m and v all lie on a 16-byte
// boundary, a span of float4 vectors, and a scalar tail of size % 4
// (kernels/optim.py `adam_plan` computes the heads; a tensor whose four
// arrays are not equally aligned is all head). A chunk is kThreads *
// kUnroll vectors of the span (16 KB of each array) and as many scalar
// elements: a thread loads its kUnroll float4 of each of the four arrays
// (16 independent 16-byte loads in flight) before any arithmetic, then
// updates and stores them; every access carries a streaming hint
// (ld/st.global.cs: each byte is touched once). The grid is what the
// card holds resident (occupancy times SMs), and the chunks are small, so
// the launch's last wave is short. The first design (path 0,
// adam_kernel) stays: chunks of 65,536 elements, one 4-byte access a
// thread per array, a store of p, m, v before the next element's loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;  // path 0: elements a chunk
constexpr int kMaxBlocks = 132 * 8;  // path 0: the grid
constexpr int kUnroll = 4;           // path 1: float4 an array a thread loads
constexpr long long kVecChunk = kThreads * kUnroll;  // path 1: float4 a chunk
constexpr int kMaxDevices = 64;

// Planted faults of the streaming body (launch paths 2 and 3; no caller
// passes them): m * (1 / bc1) for m / bc1 (at most an ulp off), the
// scalar tail of each tensor left unwritten.
constexpr int kNoFault = 0;
constexpr int kReciprocal = 1;
constexpr int kTailUnwritten = 2;

struct Table {
  float* g[kMaxTensors];
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  long long head[kMaxTensors];  // path 1: scalar elements before the span
  int n;
};

struct Hyper {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int adam_w;
};

// One element's update, in place on p, m and v.
template <int kFault>
__device__ __forceinline__ void adam_update(const Hyper& hp, float g,
                                            float& p, float& m, float& v) {
  if (!hp.adam_w) g = __fadd_rn(g, __fmul_rn(hp.wd, p));
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(hp.one_minus_b2, __fmul_rn(g, g)));
  const float mhat = kFault == kReciprocal ? __fmul_rn(m, __frcp_rn(hp.bc1))
                                           : __fdiv_rn(m, hp.bc1);
  float u = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.bc2)), hp.eps));
  if (hp.adam_w && hp.wd != 0.f) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
  p = __fsub_rn(p, __fmul_rn(hp.lr, u));
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ Table t, const __grid_constant__ Hyper hp,
            const float* __restrict__ noop) {
  if (*noop != 0.f) return;
  const long long chunks = t.first_chunk[t.n];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    int k = 0;
    while (t.first_chunk[k + 1] <= c) ++k;
    const long long start = (c - t.first_chunk[k]) * kChunk;
    const long long end = min(start + kChunk, t.size[k]);
    float* __restrict__ g = t.g[k];
    float* __restrict__ p = t.p[k];
    float* __restrict__ m = t.m[k];
    float* __restrict__ v = t.v[k];
#pragma unroll 4
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      float pi = p[i], mi = m[i], vi = v[i];
      adam_update<kNoFault>(hp, g[i], pi, mi, vi);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
}

template <int kFault>
__device__ __forceinline__ void adam_update4(const Hyper& hp, const float4& g,
                                             float4& p, float4& m, float4& v) {
  adam_update<kFault>(hp, g.x, p.x, m.x, v.x);
  adam_update<kFault>(hp, g.y, p.y, m.y, v.y);
  adam_update<kFault>(hp, g.z, p.z, m.z, v.z);
  adam_update<kFault>(hp, g.w, p.w, m.w, v.w);
}

template <int kFault>
__global__ void __launch_bounds__(kThreads)
adam_vec_kernel(const __grid_constant__ Table t,
                const __grid_constant__ Hyper hp,
                const float* __restrict__ noop) {
  if (*noop != 0.f) return;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long local = c - t.first_chunk[k];
    const long long size = t.size[k];
    const long long head = t.head[k];
    const long long vecs = (size - head) / 4;
    float* const g = t.g[k];
    float* const p = t.p[k];
    float* const m = t.m[k];
    float* const v = t.v[k];
    // the vector span: float4 i of each array starts at element head + 4 i
    const float4* const g4 = reinterpret_cast<const float4*>(g + head);
    float4* const p4 = reinterpret_cast<float4*>(p + head);
    float4* const m4 = reinterpret_cast<float4*>(m + head);
    float4* const v4 = reinterpret_cast<float4*>(v + head);
    const long long base = local * kVecChunk + threadIdx.x;
    float4 gv[kUnroll], pv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        gv[u] = __ldcs(g4 + i);
        pv[u] = __ldcs(p4 + i);
        mv[u] = __ldcs(m4 + i);
        vv[u] = __ldcs(v4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        adam_update4<kFault>(hp, gv[u], pv[u], mv[u], vv[u]);
        __stcs(p4 + i, pv[u]);
        __stcs(m4 + i, mv[u]);
        __stcs(v4 + i, vv[u]);
      }
    }
    // the scalar head and tail: scalar q is element q < head ? q : q + 4 vecs
    const long long scalars = size - 4 * vecs;
    const long long q_end = min((local + 1) * 4 * kVecChunk, scalars);
    for (long long q = local * 4 * kVecChunk + threadIdx.x; q < q_end;
         q += kThreads) {
      if (kFault == kTailUnwritten && q >= head) break;
      const long long e = q < head ? q : q + 4 * vecs;
      float pe = __ldcs(p + e), me = __ldcs(m + e), ve = __ldcs(v + e);
      adam_update<kFault>(hp, __ldcs(g + e), pe, me, ve);
      __stcs(p + e, pe);
      __stcs(m + e, me);
      __stcs(v + e, ve);
    }
  }
}

// Blocks of adam_vec_kernel<kFault> the current device holds resident at
// once (occupancy times SMs; read once a device); -1 on an error.
template <int kFault>
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
            &per_sm, adam_vec_kernel<kFault>, kThreads, 0) != cudaSuccess ||
        sms * per_sm < 1)
      return -1;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <int kFault>
int launch_vec(const Table& t, const Hyper& hp, const float* noop,
               cudaStream_t stream) {
  const int resident = resident_blocks<kFault>();
  if (resident < 1) return -1;
  const long long chunks = t.first_chunk[t.n];
  const int blocks = static_cast<int>(chunks < resident ? chunks : resident);
  adam_vec_kernel<kFault><<<blocks, kThreads, 0, stream>>>(t, hp, noop);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Updates the n (1..64) fp32 tensors g[k], p[k], m[k], v[k] of sizes[k]
// elements in place. path: 0 = the first design (adam_kernel; heads not
// read, may be null), 1 = the streaming body (adam_vec_kernel) with
// heads[k] scalar elements before tensor k's vector span (0..3 with g, p,
// m, v + heads[k] on 16-byte boundaries, or sizes[k]: no vector span;
// kernels/optim.py `adam_plan`), 2 and 3 = path 1 with a planted fault
// (m * (1 / bc1); the scalar tails unwritten). Returns the CUDA error of
// the launch (0 on success); -1 for a tensor count, size, head or path
// the kernel does not take.
extern "C" int apex_adam(void* const* g, void* const* p, void* const* m,
                         void* const* v, const long long* sizes,
                         const long long* heads, int n, const float* noop,
                         float lr,
                         float bc1, float bc2, float b1, float one_minus_b1,
                         float b2, float one_minus_b2, float eps, float wd,
                         int adam_w, int path, void* stream) {
  if (n < 1 || n > kMaxTensors || path < 0 || path > 3) return -1;
  if (path != 0 && heads == nullptr) return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    const long long size = sizes[k];
    if (size < 0) return -1;
    t.g[k] = static_cast<float*>(g[k]);
    t.p[k] = static_cast<float*>(p[k]);
    t.m[k] = static_cast<float*>(m[k]);
    t.v[k] = static_cast<float*>(v[k]);
    t.size[k] = size;
    long long chunks = (size + kChunk - 1) / kChunk;
    t.head[k] = 0;
    if (path != 0) {
      const long long head = heads[k];
      if (head < 0 || head > size) return -1;
      const long long vecs = (size - head) / 4;
      if (vecs > 0 &&
          !(aligned16(t.g[k] + head) && aligned16(t.p[k] + head) &&
            aligned16(t.m[k] + head) && aligned16(t.v[k] + head)))
        return -1;
      const long long scalars = size - 4 * vecs;
      const long long by_vecs = (vecs + kVecChunk - 1) / kVecChunk;
      const long long by_scalars = (scalars + 4 * kVecChunk - 1) / (4 * kVecChunk);
      chunks = by_vecs > by_scalars ? by_vecs : by_scalars;
      t.head[k] = head;
    }
    t.first_chunk[k + 1] = t.first_chunk[k] + chunks;
  }
  const long long chunks = t.first_chunk[n];
  if (chunks == 0) return 0;
  const Hyper hp{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd,
                 adam_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) return launch_vec<kNoFault>(t, hp, noop, s);
  if (path == 2) return launch_vec<kReciprocal>(t, hp, noop, s);
  if (path == 3) return launch_vec<kTailUnwritten>(t, hp, noop, s);
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  adam_kernel<<<blocks, kThreads, 0, s>>>(t, hp, noop);
  return static_cast<int>(cudaGetLastError());
}
