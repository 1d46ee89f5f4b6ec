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
// Design: adam.cu's first multi_tensor_apply: up to kMaxTensors = 64
// tensors a launch from a table passed by value as the kernel's
// parameter, chunks of 65,536 elements walked grid-stride, neighbouring
// threads on neighbouring elements; every product and sum a
// round-to-nearest intrinsic (no FMA contraction), so the kernel gives
// the oracle's values bit for bit.

#include "multi_tensor.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;
constexpr int kMaxBlocks = 132 * 8;

// planted faults (fault codes 1 and 2; no caller passes them): first_run
// never taken; the unscale factor not applied
constexpr int kFirstRunIgnored = 1;
constexpr int kNotUnscaled = 2;

struct Table {
  const void* g[kMaxTensors];
  float* p[kMaxTensors];
  float* mom[kMaxTensors];
  void* out[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int n;
};

struct Hyper {
  float wd, momentum, one_minus_dampening, lr;
  int nesterov, wd_after_momentum, fault;
};

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
int launch(const Table& t, const Hyper& hp, const float* noop, const int* step,
           const float* inv_scale, cudaStream_t s) {
  const long long chunks = t.first_chunk[t.n];
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  sgd_kernel<TG, TO><<<blocks, kThreads, 0, s>>>(t, hp, noop, step, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int by_out(int out_dtype, const Table& t, const Hyper& hp, const float* noop,
           const int* step, const float* inv_scale, cudaStream_t s) {
  if (out_dtype == mt::kNone)
    return launch<TG, mt::None>(t, hp, noop, step, inv_scale, s);
  if (out_dtype == mt::kFloat32)
    return launch<TG, float>(t, hp, noop, step, inv_scale, s);
  if (out_dtype == mt::kBFloat16)
    return launch<TG, __nv_bfloat16>(t, hp, noop, step, inv_scale, s);
  return -1;
}

}  // namespace

// SGD over the n (1..64) tensors of sizes[k] elements: g[k] (g_dtype 0
// fp32, 1 bf16) times *inv_scale (null: 1), p[k] and mom[k] (fp32) in
// place, then out[k] (out_dtype 0 or 1, or -1: none, out may be null)
// written from the new p[k]. first_run where *step (int32, the count
// before this update) is 0; nothing is written when *noop > 0. fault: 0,
// or a planted fault (1 first_run never taken, 2 inv_scale not applied).
// Returns the CUDA error of the launch (0 on success); -1 for a count,
// size, dtype or fault the kernel does not take.
extern "C" int apex_sgd(void* const* g, void* const* p, void* const* mom,
                        void* const* out, const long long* sizes, int n,
                        int g_dtype, int out_dtype, const float* noop,
                        const int* step, const float* inv_scale, float wd,
                        float momentum, float one_minus_dampening, float lr,
                        int nesterov, int wd_after_momentum, int fault,
                        void* stream) {
  if (n < 1 || n > kMaxTensors || fault < 0 || fault > 2 ||
      noop == nullptr || step == nullptr)
    return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] < 0) return -1;
    t.g[k] = g[k];
    t.p[k] = static_cast<float*>(p[k]);
    t.mom[k] = static_cast<float*>(mom[k]);
    t.out[k] = out_dtype == mt::kNone ? nullptr : out[k];
    t.size[k] = sizes[k];
    t.first_chunk[k + 1] = t.first_chunk[k] + (sizes[k] + kChunk - 1) / kChunk;
  }
  if (t.first_chunk[n] == 0) return 0;
  const Hyper hp{wd, momentum, one_minus_dampening, lr, nesterov,
                 wd_after_momentum, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == mt::kFloat32)
    return by_out<float>(out_dtype, t, hp, noop, step, inv_scale, s);
  if (g_dtype == mt::kBFloat16)
    return by_out<__nv_bfloat16>(out_dtype, t, hp, noop, step, inv_scale, s);
  return -1;
}
