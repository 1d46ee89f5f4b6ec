// Multi-tensor SGD with momentum for Hopper (sm_90a), bound to Python
// with ctypes: FusedSGD's step, amp's O1 + FusedSGD.
//
// The port's counterpart of apex_tpu/ops/multi_tensor.py
// `multi_tensor_sgd` (:113-149), a jnp loop over the tensors that XLA
// fuses (no Pallas kernel). Per element, in fp32 and in this order:
//   g = g * inv_scale                 (inv_scale a device scalar; bf16 or
//                                      fp32 g widened in registers)
//   wd != 0, not wd_after_momentum:   g = g + wd * p
//   momentum != 0:  mom = first_run ? g : momentum * mom + (1 - dampening) * g
//                   d = nesterov ? g + momentum * mom : mom
//   momentum == 0:  d = g             (mom untouched)
//   wd != 0, wd_after_momentum:       d = d + wd * p
//   p = p - lr * d
// with (1 - dampening) rounded to fp32 from double by the caller, as JAX
// rounds its weakly typed Python floats. first_run is the device step
// count (int32, before this update) equal to 0, as JAX's FusedSGD takes
// `state["step"] == 0`: a step that overflow skipped leaves the count,
// so the next one is still the first. Nothing is written when the device
// fp32 noop flag is > 0. p and mom are fp32; where an output list is
// given, the parameter is written from the new p in the same pass (amp's
// masters).
//
// Bound on the H100: memory. An element reads g, p and mom and writes p
// and mom: 18 bytes with a bf16 gradient, 20 with an fp32 one.
//
// Both designs take adam.cu's multi_tensor_apply: up to kMaxTensors = 64
// tensors a launch from a table of their pointers, sizes, prefix chunk
// counts and heads passed by value as the kernel's parameter (3.3 KB),
// chunks walked grid-stride; every product and sum a round-to-nearest
// intrinsic (no FMA contraction), so both give the oracle's values bit
// for bit.
//
// The streaming body (path 1, sgd_vec_kernel; #12's, adam.cu): each
// tensor is a scalar head up to the first element where g, p, mom and
// the output all lie on a 4-element boundary, a span of 4-element vectors
// (16 bytes of fp32, 8 of bf16) and a scalar tail (kernels/optim.py
// `adam_plan` gives the heads; a tensor whose lists are not aligned alike
// is all head). A chunk is kThreads * kUnroll vectors of the span and as
// many scalar elements: a thread loads its kUnroll vectors of g, p and
// (where the step reads it) mom before any arithmetic, then updates and
// stores them; every access carries the streaming hint. The grid is what
// the card holds resident, so the last wave is short. The first design
// (path 0, sgd_kernel) stays: chunks of 65,536 elements walked by a
// fixed 132 * 8 blocks, one 4-byte access a thread per array, each
// element stored before the next one is loaded.

#include "multi_tensor.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;  // path 0: elements a chunk
constexpr int kMaxBlocks = 132 * 8;  // path 0: the grid
constexpr int kUnroll = 4;           // path 1: vectors an array a thread loads
constexpr long long kVecChunk = kThreads * kUnroll;  // path 1: vectors a chunk

// planted faults (fault codes 1 and 2; no caller passes them), on either
// path: first_run never taken; the unscale factor not applied
constexpr int kFirstRunIgnored = 1;
constexpr int kNotUnscaled = 2;

struct Table {
  const void* g[kMaxTensors];
  float* p[kMaxTensors];
  float* mom[kMaxTensors];
  void* out[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int head[kMaxTensors];  // path 1: scalar elements before the span, -1: all
  int n;
};

struct Hyper {
  float wd, momentum, one_minus_dampening, lr;
  int nesterov, wd_after_momentum, fault;
};

// One element's step on p and mom (mom read only where the momentum is
// not 0 and this is not the first run), g already unscaled.
__device__ __forceinline__ void sgd_update(const Hyper& hp, bool first_run,
                                           float g, float& p, float& mom) {
  if (hp.wd != 0.f && !hp.wd_after_momentum)
    g = __fadd_rn(g, __fmul_rn(hp.wd, p));
  float d = g;
  if (hp.momentum != 0.f) {
    mom = first_run ? g
                    : __fadd_rn(__fmul_rn(hp.momentum, mom),
                                __fmul_rn(hp.one_minus_dampening, g));
    d = hp.nesterov ? __fadd_rn(g, __fmul_rn(hp.momentum, mom)) : mom;
  }
  if (hp.wd != 0.f && hp.wd_after_momentum)
    d = __fadd_rn(d, __fmul_rn(hp.wd, p));
  p = __fsub_rn(p, __fmul_rn(hp.lr, d));
}

template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(const __grid_constant__ Table t, const __grid_constant__ Hyper hp,
           const float* __restrict__ noop, const int* __restrict__ step,
           const float* __restrict__ inv_scale) {
  if (mt::raised(noop)) return;
  const bool first_run = *step == 0 && hp.fault != kFirstRunIgnored;
  const bool unscale = inv_scale != nullptr && hp.fault != kNotUnscaled;
  const float inv = inv_scale != nullptr ? *inv_scale : 1.f;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long start = (c - t.first_chunk[k]) * kChunk;
    const long long end = min(start + kChunk, t.size[k]);
    const TG* g = static_cast<const TG*>(t.g[k]);
    float* p = t.p[k];
    float* mom = t.mom[k];
    void* out = t.out[k];
#pragma unroll 4
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      float gi = mt::to_float(g[i]);
      if (unscale) gi = __fmul_rn(gi, inv);
      float pi = p[i];
      if (hp.wd != 0.f && !hp.wd_after_momentum)
        gi = __fadd_rn(gi, __fmul_rn(hp.wd, pi));
      float d = gi;
      if (hp.momentum != 0.f) {
        const float mi = first_run
            ? gi
            : __fadd_rn(__fmul_rn(hp.momentum, mom[i]),
                        __fmul_rn(hp.one_minus_dampening, gi));
        mom[i] = mi;
        d = hp.nesterov ? __fadd_rn(gi, __fmul_rn(hp.momentum, mi)) : mi;
      }
      if (hp.wd != 0.f && hp.wd_after_momentum)
        d = __fadd_rn(d, __fmul_rn(hp.wd, pi));
      pi = __fsub_rn(pi, __fmul_rn(hp.lr, d));
      p[i] = pi;
      mt::store<TO>(out, i, pi);
    }
  }
}

template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads)
sgd_vec_kernel(const __grid_constant__ Table t,
               const __grid_constant__ Hyper hp,
               const float* __restrict__ noop, const int* __restrict__ step,
               const float* __restrict__ inv_scale) {
  if (mt::raised(noop)) return;
  const bool first_run = *step == 0 && hp.fault != kFirstRunIgnored;
  const bool unscale = inv_scale != nullptr && hp.fault != kNotUnscaled;
  const float inv = inv_scale != nullptr ? *inv_scale : 1.f;
  const bool has_mom = hp.momentum != 0.f;
  const bool reads_mom = has_mom && !first_run;
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
    float* const p = t.p[k] + head;
    float* const mom = t.mom[k] + head;
    TO* const out = static_cast<TO*>(t.out[k]) + head;
    const long long base = local * kVecChunk + threadIdx.x;
    float4 gv[kUnroll], pv[kUnroll], mv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        gv[u] = mt::ld4(g, i);
        pv[u] = mt::ld4(p, i);
        mv[u] = reads_mom ? mt::ld4(mom, i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        float4 gu = gv[u];
        if (unscale) {
          gu.x = __fmul_rn(gu.x, inv);
          gu.y = __fmul_rn(gu.y, inv);
          gu.z = __fmul_rn(gu.z, inv);
          gu.w = __fmul_rn(gu.w, inv);
        }
        sgd_update(hp, first_run, gu.x, pv[u].x, mv[u].x);
        sgd_update(hp, first_run, gu.y, pv[u].y, mv[u].y);
        sgd_update(hp, first_run, gu.z, pv[u].z, mv[u].z);
        sgd_update(hp, first_run, gu.w, pv[u].w, mv[u].w);
        mt::st4(p, i, pv[u]);
        if (has_mom) mt::st4(mom, i, mv[u]);
        mt::st4(out, i, pv[u]);
      }
    }
    // the scalar head and tail: scalar q is element q < head ? q : q + 4 vecs
    const long long scalars = size - 4 * vecs;
    const long long q_end = min((local + 1) * 4 * kVecChunk, scalars);
    for (long long q = local * 4 * kVecChunk + threadIdx.x; q < q_end;
         q += kThreads) {
      const long long e = (q < head ? q : q + 4 * vecs) - head;
      float ge = mt::ld1(g, e);
      if (unscale) ge = __fmul_rn(ge, inv);
      float pe = mt::ld1(p, e);
      float me = reads_mom ? mt::ld1(mom, e) : 0.f;
      sgd_update(hp, first_run, ge, pe, me);
      mt::st1(p, e, pe);
      if (has_mom) mt::st1(mom, e, me);
      mt::st1(out, e, pe);
    }
  }
}

// Blocks of sgd_vec_kernel<TG, TO> the current device holds resident at
// once (mt::resident_blocks, cached here); -1 on an error.
template <typename TG, typename TO>
int resident_blocks() {
  static int cached[mt::kMaxDevices] = {};
  return mt::resident_blocks(
      reinterpret_cast<const void*>(sgd_vec_kernel<TG, TO>), kThreads, cached);
}

template <typename TG, typename TO>
int launch(const Table& t, const Hyper& hp, const float* noop, const int* step,
           const float* inv_scale, int path, cudaStream_t s) {
  const long long chunks = t.first_chunk[t.n];
  if (path == 0) {
    const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
    sgd_kernel<TG, TO><<<blocks, kThreads, 0, s>>>(t, hp, noop, step, inv_scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int resident = resident_blocks<TG, TO>();
  if (resident < 1) return -1;
  const int blocks = static_cast<int>(chunks < resident ? chunks : resident);
  sgd_vec_kernel<TG, TO><<<blocks, kThreads, 0, s>>>(t, hp, noop, step,
                                                     inv_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int by_out(int out_dtype, const Table& t, const Hyper& hp, const float* noop,
           const int* step, const float* inv_scale, int path, cudaStream_t s) {
  if (out_dtype == mt::kNone)
    return launch<TG, mt::None>(t, hp, noop, step, inv_scale, path, s);
  if (out_dtype == mt::kFloat32)
    return launch<TG, float>(t, hp, noop, step, inv_scale, path, s);
  if (out_dtype == mt::kBFloat16)
    return launch<TG, __nv_bfloat16>(t, hp, noop, step, inv_scale, path, s);
  return -1;
}

}  // namespace

// SGD over the n (1..64) tensors of sizes[k] elements: g[k] (g_dtype 0
// fp32, 1 bf16) times *inv_scale (null: 1), p[k] and mom[k] (fp32) in
// place, then out[k] (out_dtype 0 or 1, or -1: none, out may be null)
// written from the new p[k]. first_run where *step (int32, the count
// before this update) is 0; nothing is written when *noop > 0. fault: 0,
// or a planted fault on either path (1 first_run never taken, 2
// inv_scale not applied). path: 0 = the first design (sgd_kernel; heads
// not read, may be null), 1 = the streaming body (sgd_vec_kernel) with
// heads[k] scalar elements before tensor k's vector span (0..3 with
// every array + heads[k] on a 4-element boundary, or sizes[k]: no vector
// span; kernels/optim.py `adam_plan`). Returns the CUDA error of the
// launch (0 on success); -1 for a count, size, head, dtype, fault or
// path the kernel does not take.
extern "C" int apex_sgd(void* const* g, void* const* p, void* const* mom,
                        void* const* out, const long long* sizes,
                        const long long* heads, int n, int g_dtype,
                        int out_dtype, const float* noop, const int* step,
                        const float* inv_scale, float wd, float momentum,
                        float one_minus_dampening, float lr, int nesterov,
                        int wd_after_momentum, int fault, int path,
                        void* stream) {
  if (n < 1 || n > kMaxTensors || fault < 0 || fault > 2 || path < 0 ||
      path > 1 || noop == nullptr || step == nullptr ||
      (path != 0 && heads == nullptr))
    return -1;
  if (g_dtype != mt::kFloat32 && g_dtype != mt::kBFloat16) return -1;
  if (out_dtype != mt::kNone && out_dtype != mt::kFloat32 &&
      out_dtype != mt::kBFloat16)
    return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    const long long size = sizes[k];
    if (size < 0) return -1;
    t.g[k] = g[k];
    t.p[k] = static_cast<float*>(p[k]);
    t.mom[k] = static_cast<float*>(mom[k]);
    t.out[k] = out_dtype == mt::kNone ? nullptr : out[k];
    t.size[k] = size;
    t.head[k] = 0;
    const long long chunks =
        path == 0 ? (size + kChunk - 1) / kChunk
                  : mt::stream_chunks(size, heads[k], 4, kVecChunk,
                                      {{t.g[k], g_dtype},
                                       {t.p[k], mt::kFloat32},
                                       {t.mom[k], mt::kFloat32},
                                       {t.out[k], out_dtype}},
                                      &t.head[k]);
    if (chunks < 0) return -1;
    t.first_chunk[k + 1] = t.first_chunk[k] + chunks;
  }
  if (t.first_chunk[n] == 0) return 0;
  const Hyper hp{wd, momentum, one_minus_dampening, lr, nesterov,
                 wd_after_momentum, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == mt::kFloat32)
    return by_out<float>(out_dtype, t, hp, noop, step, inv_scale, path, s);
  return by_out<__nv_bfloat16>(out_dtype, t, hp, noop, step, inv_scale, path,
                               s);
}
