// Multi-tensor Adam/AdamW update for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces apex_tpu/kernels/optim.py `_adam_kernel` (launched by
// `fused_adam_update`), which updates one flat fp32 buffer per call; the
// JAX FusedAdam computes the same update with `ops/multi_tensor.py`
// `multi_tensor_adam`, a jnp loop over the parameter tensors that XLA
// fuses. Per element, in fp32 and in this order:
//   g = g * inv_scale                 (only where an inv_scale is given)
//   mode 0 (L2):   g = g + wd * p
//   m = b1 * m + (1 - b1) * g;   v = b2 * v + (1 - b2) * g * g
//   update = (m / bc1) / (sqrt(v / bc2) + eps)
//   mode 1 (AdamW, wd != 0): update = update + wd * p
//   p = p - lr * update
// with (1 - b1) and (1 - b2) rounded to fp32 from double by the caller,
// as JAX rounds its weakly typed Python floats. The whole update is
// skipped, leaving p, m and v untouched, when the device-side fp32
// `noop` flag is > 0 (the JAX op's `_keep`, without a branch on the
// host).
//
// What amp keeps on the device is read there, so a step that an overflow
// skips costs the host no synchronisation (JAX's
// `multi_tensor_adam_capturable` and `_capturable_master`, ops/
// multi_tensor.py:197-225): the bias corrections come from the host's
// values or from a device step count (int32, the count after this
// update; multi_tensor.cuh `bias_correction`, which gives the host's
// values), the unscale factor is a device fp32 scalar (JAX's
// `g.astype(f32) * inv_scale`), g is bf16 or fp32 (widened in
// registers), the updated tensor p is an fp32 master or the parameter
// itself (fp32, or bf16 without a master: rounded back, as JAX's `_keep`
// casts to p's dtype), and where an output list is given the parameter is
// written from the new master in the same pass (`nm.astype(p.dtype)`).
//
// Bound on the H100: memory. 28 bytes per parameter in fp32 (read g, p,
// m, v; write p, m, v) and ~15 flops: 30.8 GB, >= 9.2 ms at 3.35 TB/s for
// TinyLlama-1.1B's 1.10 B parameters; 26 bytes with a bf16 gradient and an
// fp32 master, plus 2 for the bf16 parameter written from it.
//
// Both designs take the reference's multi_tensor_apply: eager PyTorch
// has no XLA to fuse a per-tensor loop, which for the model's 179 tensors
// would be ~2,000 small launches a step, so one launch updates up to
// kMaxTensors = 64 tensors: a table of their g, p, m, v and output
// pointers, sizes, chunk counts and heads travels by value as the
// kernel's parameter (3.9 KB, under the 4 KB parameter limit, and
// captured as it is by a CUDA graph), and blocks walk the chunks
// grid-stride, finding a chunk's tensor from the table's prefix count of
// chunks. Every operation is written with a round-to-nearest intrinsic
// (adam_update), so nvcc does not contract it into an FMA and no division
// becomes a reciprocal product: both designs give the oracle's fp32
// results bit for bit.
//
// The streaming body (path 1, adam_vec_kernel): each tensor is a scalar
// head up to the first element where g, p, m, v (and the output) all lie
// on a boundary of 4 elements (16 bytes of fp32, 8 of bf16), a span of
// 4-element vectors, and a scalar tail of size % 4 (kernels/optim.py
// `adam_plan` computes the heads; a tensor whose arrays are not equally
// aligned is all head). A chunk is kThreads * kUnroll vectors of the
// span and as many scalar elements: a thread loads its kUnroll vectors of
// each array (16 independent loads in flight) before any arithmetic, then
// updates and stores them; every access carries a streaming hint
// (ld/st.global.cs: each byte is touched once). The grid is what the
// card holds resident (occupancy times SMs), and the chunks are small, so
// the launch's last wave is short. The first design (path 0,
// adam_kernel, fp32 with the host's bias corrections only) stays: chunks
// of 65,536 elements, one 4-byte access a thread per array, a store of p,
// m, v before the next element's loads.

#include <cuda_runtime.h>

#include "multi_tensor.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;  // path 0: elements a chunk
constexpr int kMaxBlocks = 132 * 8;  // path 0: the grid
constexpr int kUnroll = 4;           // path 1: vectors an array a thread loads
constexpr long long kVecChunk = kThreads * kUnroll;  // path 1: vectors a chunk

// Planted faults of the streaming body (launch paths 2 to 5; no caller
// passes them): m * (1 / bc1) for m / bc1 (at most an ulp off), the
// scalar tail of each tensor left unwritten (fp32 only); the bias
// corrections of the step before, the output list left unwritten (bf16
// gradients, fp32 masters, bf16 outputs).
constexpr int kNoFault = 0;
constexpr int kReciprocal = 1;
constexpr int kTailUnwritten = 2;
constexpr int kStepBefore = 3;
constexpr int kOutUnwritten = 4;

struct Table {
  const void* g[kMaxTensors];
  void* p[kMaxTensors];    // the fp32 master, or the parameter itself
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  void* out[kMaxTensors];  // the parameter written from the master, or null
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int head[kMaxTensors];  // path 1: scalar elements before the span, -1: all
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
  if (mt::raised(noop)) return;
  const long long chunks = t.first_chunk[t.n];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    int k = 0;
    while (t.first_chunk[k + 1] <= c) ++k;
    const long long start = (c - t.first_chunk[k]) * kChunk;
    const long long end = min(start + kChunk, t.size[k]);
    const float* __restrict__ g = static_cast<const float*>(t.g[k]);
    float* __restrict__ p = static_cast<float*>(t.p[k]);
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

// Streaming loads and stores (multi_tensor.cuh, shared with the
// multi-tensor scale and SGD kernels).
using mt::ld1;
using mt::ld4;
using mt::st1;
using mt::st4;

template <int kFault>
__device__ __forceinline__ void adam_update4(const Hyper& hp, float4 g,
                                             float inv, bool unscale,
                                             float4& p, float4& m, float4& v) {
  if (unscale) {
    g.x = __fmul_rn(g.x, inv);
    g.y = __fmul_rn(g.y, inv);
    g.z = __fmul_rn(g.z, inv);
    g.w = __fmul_rn(g.w, inv);
  }
  adam_update<kFault>(hp, g.x, p.x, m.x, v.x);
  adam_update<kFault>(hp, g.y, p.y, m.y, v.y);
  adam_update<kFault>(hp, g.z, p.z, m.z, v.z);
  adam_update<kFault>(hp, g.w, p.w, m.w, v.w);
}

template <typename TG, typename TP, typename TO, int kFault>
__global__ void __launch_bounds__(kThreads)
adam_vec_kernel(const __grid_constant__ Table t,
                const __grid_constant__ Hyper hp,
                const float* __restrict__ noop, const int* __restrict__ step,
                const float* __restrict__ inv_scale) {
  if (mt::raised(noop)) return;
  Hyper h = hp;
  if (step != nullptr) {  // the bias corrections of the device step
    __shared__ float bc[2];
    if (threadIdx.x == 0) {
      const int s = kFault == kStepBefore ? *step - 1 : *step;
      bc[0] = mt::bias_correction(hp.b1, s);
      bc[1] = mt::bias_correction(hp.b2, s);
    }
    __syncthreads();
    h.bc1 = bc[0];
    h.bc2 = bc[1];
  }
  const bool unscale = inv_scale != nullptr;
  const float inv = unscale ? *inv_scale : 1.f;
  constexpr bool kWriteOut = kFault != kOutUnwritten;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long local = c - t.first_chunk[k];
    const long long size = t.size[k];
    const long long head = t.head[k] < 0 ? size : t.head[k];
    const long long vecs = (size - head) / 4;
    // the vector span: vector i of each array starts at element head + 4 i
    const TG* const g = static_cast<const TG*>(t.g[k]) + head;
    TP* const p = static_cast<TP*>(t.p[k]) + head;
    float* const m = t.m[k] + head;
    float* const v = t.v[k] + head;
    TO* const out = static_cast<TO*>(t.out[k]) + head;
    const long long base = local * kVecChunk + threadIdx.x;
    float4 gv[kUnroll], pv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        gv[u] = ld4(g, i);
        pv[u] = ld4(p, i);
        mv[u] = ld4(m, i);
        vv[u] = ld4(v, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        adam_update4<kFault>(h, gv[u], inv, unscale, pv[u], mv[u], vv[u]);
        st4(p, i, pv[u]);
        st4(m, i, mv[u]);
        st4(v, i, vv[u]);
        if (kWriteOut) st4(out, i, pv[u]);
      }
    }
    // the scalar head and tail: scalar q is element q < head ? q : q + 4 vecs
    const long long scalars = size - 4 * vecs;
    const long long q_end = min((local + 1) * 4 * kVecChunk, scalars);
    for (long long q = local * 4 * kVecChunk + threadIdx.x; q < q_end;
         q += kThreads) {
      if (kFault == kTailUnwritten && q >= head) break;
      const long long e = (q < head ? q : q + 4 * vecs) - head;
      float ge = ld1(g, e);
      if (unscale) ge = __fmul_rn(ge, inv);
      float pe = ld1(p, e), me = ld1(m, e), ve = ld1(v, e);
      adam_update<kFault>(h, ge, pe, me, ve);
      st1(p, e, pe);
      st1(m, e, me);
      st1(v, e, ve);
      if (kWriteOut) st1(out, e, pe);
    }
  }
}

// Blocks of adam_vec_kernel<...> the current device holds resident at
// once (mt::resident_blocks, cached here); -1 on an error.
template <typename TG, typename TP, typename TO, int kFault>
int resident_blocks() {
  static int cached[mt::kMaxDevices] = {};
  return mt::resident_blocks(
      reinterpret_cast<const void*>(adam_vec_kernel<TG, TP, TO, kFault>),
      kThreads, cached);
}

struct Launch {
  const Table& t;
  const Hyper& hp;
  const float* noop;
  const int* step;
  const float* inv_scale;
  cudaStream_t stream;
};

template <typename TG, typename TP, typename TO, int kFault>
int launch_vec(const Launch& l) {
  const int resident = resident_blocks<TG, TP, TO, kFault>();
  if (resident < 1) return -1;
  const long long chunks = l.t.first_chunk[l.t.n];
  const int blocks = static_cast<int>(chunks < resident ? chunks : resident);
  adam_vec_kernel<TG, TP, TO, kFault><<<blocks, kThreads, 0, l.stream>>>(
      l.t, l.hp, l.noop, l.step, l.inv_scale);
  return static_cast<int>(cudaGetLastError());
}

// The streaming body for a gradient dtype: the parameter and output
// dtypes it takes (an fp32 master with no, fp32 or bf16 output; a bf16
// parameter without a master).
template <typename TG>
int launch_by_p(int p_dtype, int out_dtype, const Launch& l) {
  if (p_dtype == mt::kFloat32 && out_dtype == mt::kNone)
    return launch_vec<TG, float, mt::None, kNoFault>(l);
  if (p_dtype == mt::kFloat32 && out_dtype == mt::kFloat32)
    return launch_vec<TG, float, float, kNoFault>(l);
  if (p_dtype == mt::kFloat32 && out_dtype == mt::kBFloat16)
    return launch_vec<TG, float, bf16, kNoFault>(l);
  if (p_dtype == mt::kBFloat16 && out_dtype == mt::kNone)
    return launch_vec<TG, bf16, mt::None, kNoFault>(l);
  return -1;
}

}  // namespace

// Updates the n (1..64) tensors g[k], p[k], m[k], v[k] of sizes[k]
// elements in place: g[k] (g_dtype: 0 fp32, 1 bf16) times *inv_scale
// (null: no product), the Adam update of p[k] (p_dtype: an fp32 master
// or parameter, or a bf16 parameter without a master), m[k] and v[k]
// (fp32), then out[k] (out_dtype 0 or 1, or -1: no output list, out may
// be null) written from the new p[k]. The bias corrections are bc1 and
// bc2, or, where step is not null, those of *step (int32, the count after
// this update). Nothing is written when *noop > 0. path: 0 = the first
// design (adam_kernel: fp32 g and p, no output, step or inv_scale; heads
// not read, may be null), 1 = the streaming body (adam_vec_kernel) with
// heads[k] scalar elements before tensor k's vector span (0..3 with
// every array + heads[k] on a 4-element boundary, or sizes[k]: no
// vector span; kernels/optim.py `adam_plan`), 2 to 5 = path 1 with a
// planted fault (2 m * (1 / bc1) and 3 the scalar tails unwritten, for
// fp32 g and p without an output; 4 the bias corrections of *step - 1
// and 5 the outputs unwritten, for bf16 g, fp32 p and bf16 outputs).
// Returns the CUDA error of the launch (0 on success); -1 for a tensor
// count, size, head, dtype combination or path the kernel does not take.
extern "C" int apex_adam(void* const* g, void* const* p, void* const* m,
                         void* const* v, void* const* out,
                         const long long* sizes, const long long* heads, int n,
                         int g_dtype, int p_dtype, int out_dtype,
                         const float* noop, const int* step,
                         const float* inv_scale, float lr, float bc1,
                         float bc2, float b1, float one_minus_b1, float b2,
                         float one_minus_b2, float eps, float wd, int adam_w,
                         int path, void* stream) {
  if (n < 1 || n > kMaxTensors || path < 0 || path > 5 || noop == nullptr)
    return -1;
  if (path != 0 && heads == nullptr) return -1;
  if (g_dtype != mt::kFloat32 && g_dtype != mt::kBFloat16) return -1;
  if (p_dtype != mt::kFloat32 && p_dtype != mt::kBFloat16) return -1;
  const bool plain32 = g_dtype == mt::kFloat32 && p_dtype == mt::kFloat32 &&
                       out_dtype == mt::kNone;
  if ((path == 0 && !(plain32 && step == nullptr && inv_scale == nullptr)) ||
      ((path == 2 || path == 3) && !plain32) ||
      ((path == 4 || path == 5) &&
       !(g_dtype == mt::kBFloat16 && p_dtype == mt::kFloat32 &&
         out_dtype == mt::kBFloat16)) ||
      (path == 4 && step == nullptr))
    return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    const long long size = sizes[k];
    if (size < 0) return -1;
    t.g[k] = g[k];
    t.p[k] = p[k];
    t.m[k] = static_cast<float*>(m[k]);
    t.v[k] = static_cast<float*>(v[k]);
    t.out[k] = out_dtype == mt::kNone ? nullptr : out[k];
    t.size[k] = size;
    t.head[k] = 0;
    const long long chunks =
        path == 0 ? (size + kChunk - 1) / kChunk
                  : mt::stream_chunks(size, heads[k], 4, kVecChunk,
                                      {{t.g[k], g_dtype},
                                       {t.p[k], p_dtype},
                                       {t.m[k], mt::kFloat32},
                                       {t.v[k], mt::kFloat32},
                                       {t.out[k], out_dtype}},
                                      &t.head[k]);
    if (chunks < 0) return -1;
    t.first_chunk[k + 1] = t.first_chunk[k] + chunks;
  }
  const long long chunks = t.first_chunk[n];
  if (chunks == 0) return 0;
  const Hyper hp{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd,
                 adam_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Launch l{t, hp, noop, step, inv_scale, s};
  switch (path) {
    case 1:
      return g_dtype == mt::kFloat32 ? launch_by_p<float>(p_dtype, out_dtype, l)
                                     : launch_by_p<bf16>(p_dtype, out_dtype, l);
    case 2: return launch_vec<float, float, mt::None, kReciprocal>(l);
    case 3: return launch_vec<float, float, mt::None, kTailUnwritten>(l);
    case 4: return launch_vec<bf16, float, bf16, kStepBefore>(l);
    case 5: return launch_vec<bf16, float, bf16, kOutUnwritten>(l);
  }
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  adam_kernel<<<blocks, kThreads, 0, s>>>(t, hp, noop);
  return static_cast<int>(cudaGetLastError());
}
