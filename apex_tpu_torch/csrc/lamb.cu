// Multi-tensor LAMB for Hopper (sm_90a), bound to Python with ctypes:
// stage 1 (moments and raw update) and stage 2 (the parameter step).
//
// Replaces apex_tpu/kernels/optim.py `_lamb_kernel` (launched by
// `fused_lamb_mvu`), which updates one flat fp32 buffer per call; the JAX
// FusedLAMB computes the same per-tensor step with `ops/multi_tensor.py`
// `_lamb_tensor_direction`, a jnp loop over the parameter tensors that
// XLA fuses, and `multi_tensor_lamb_mp` (:395) the same step on fp32
// masters. Stage 1, per element, in fp32 and in this order:
//   g = g * inv_scale                 (only where an inv_scale is given)
//   g = g / clip                      (the global gradient-clip factor)
//   mode 0 (L2, wd != 0):  g = g + wd * p
//   m = b1 * m + beta3 * g;   v = b2 * v + (1 - b2) * g * g
//   u = (m / bc1) / (sqrt(v / bc2) + eps)
//   mode 1 (decoupled, wd != 0):  u = u + wd * p
// g is bf16 or fp32 (widened in registers) and p the fp32 parameter or
// master; m and v are written in place and u into a buffer of its own,
// which may be g itself (fp32 g): the reference's multi_tensor_lamb stage
// 1 stores its update in the gradient, and a bf16 gradient cannot hold
// it. The bias corrections are the host's values or those of a device
// step count (int32, the count after this update; multi_tensor.cuh
// `bias_correction`, which gives the host's values). (1 - b2) and beta3
// are rounded to fp32 from double by the caller, as JAX rounds its weakly
// typed Python floats. The clip factor and inv_scale are read from device
// scalars, so the caller needs no host synchronisation. Nothing is
// written when the device fp32 `noop` or `found_inf` flag is > 0 (JAX's
// `max(noop, found_inf)`).
//
// Stage 2 is the parameter step, p = p - f[k] * u with f[k] = lr * the
// trust ratio of tensor k (a device fp32 array; the ratios are the
// caller's), in JAX's order (`p - lr * ratio * update`: the product
// rounded, then the difference), under the same flags, the low-precision
// parameter written from the new master in the same pass where there is
// one.
//
// Bound on the H100: memory. Stage 1 moves 28 bytes per parameter with
// fp32 g (read g, p, m, v; write m, v, u) and ~16 flops: 10.29 GB, >=
// 3.07 ms at 3.35 TB/s for BERT-large's 367 M parameters; stage 2 12
// (read p, u; write p), plus 2 for a bf16 parameter.
//
// Design: adam.cu's multi_tensor_apply. One launch updates up to
// kMaxTensors = 64 tensors from a table of their pointers and sizes
// passed by value as the kernel's parameter (3.6 KB, under the 4 KB
// parameter limit); each tensor is cut into chunks of 65,536 elements
// that blocks walk grid-stride. Threads read and write neighbouring
// elements (coalesced). Every operation is written with a
// round-to-nearest intrinsic so nvcc does not contract it into an FMA:
// the kernels give the oracle's fp32 results bit for bit.

#include <cuda_runtime.h>

#include "multi_tensor.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;
constexpr int kMaxBlocks = 132 * 8;

// planted faults (fault codes 1 and 2; no caller passes them): stage 1,
// the gradient not unscaled (1) and u written unclipped (2); stage 2,
// tensor k moved by tensor k + 1's factor (1) and the outputs unwritten
// (2)
constexpr int kNotUnscaled = 1;
constexpr int kUnclipped = 2;
constexpr int kNextFactor = 1;
constexpr int kOutUnwritten = 2;

struct Table {
  const void* g[kMaxTensors];
  const float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* u[kMaxTensors];  // the raw update; may be g (fp32 g)
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int n;
};

struct Hyper {
  float bc1, bc2, b1, beta3, b2, one_minus_b2, eps, wd;
  int adam_w, fault;
};

// g and u are not __restrict__: u may be g.
template <typename TG>
__global__ void __launch_bounds__(kThreads)
lamb_kernel(const __grid_constant__ Table t, const __grid_constant__ Hyper hp,
            const float* __restrict__ noop,
            const float* __restrict__ found_inf,
            const float* __restrict__ clip, const int* __restrict__ step,
            const float* __restrict__ inv_scale) {
  if (mt::raised(noop) || mt::raised(found_inf)) return;
  float bc1 = hp.bc1, bc2 = hp.bc2;
  if (step != nullptr) {  // the bias corrections of the device step
    __shared__ float bc[2];
    if (threadIdx.x == 0) {
      bc[0] = mt::bias_correction(hp.b1, *step);
      bc[1] = mt::bias_correction(hp.b2, *step);
    }
    __syncthreads();
    bc1 = bc[0];
    bc2 = bc[1];
  }
  const bool unscale = inv_scale != nullptr && hp.fault != kNotUnscaled;
  const float inv = inv_scale != nullptr ? *inv_scale : 1.f;
  const bool clipped = clip != nullptr && hp.fault != kUnclipped;
  const float c = clip != nullptr ? *clip : 1.f;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    while (t.first_chunk[k + 1] <= ch) ++k;  // ch only grows, and so does k
    const long long start = (ch - t.first_chunk[k]) * kChunk;
    const long long end = min(start + kChunk, t.size[k]);
    const TG* g = static_cast<const TG*>(t.g[k]);
    const float* __restrict__ p = t.p[k];
    float* __restrict__ m = t.m[k];
    float* __restrict__ v = t.v[k];
    float* u = t.u[k];
#pragma unroll 4
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      float gi = mt::to_float(g[i]);
      if (unscale) gi = __fmul_rn(gi, inv);
      if (clipped) gi = __fdiv_rn(gi, c);
      const float pi = p[i];
      if (!hp.adam_w && hp.wd != 0.f) gi = __fadd_rn(gi, __fmul_rn(hp.wd, pi));
      const float mi = __fadd_rn(__fmul_rn(hp.b1, m[i]), __fmul_rn(hp.beta3, gi));
      const float vi = __fadd_rn(__fmul_rn(hp.b2, v[i]),
                                 __fmul_rn(hp.one_minus_b2, __fmul_rn(gi, gi)));
      float ui = __fdiv_rn(__fdiv_rn(mi, bc1),
                           __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), hp.eps));
      if (hp.adam_w && hp.wd != 0.f) ui = __fadd_rn(ui, __fmul_rn(hp.wd, pi));
      m[i] = mi;
      v[i] = vi;
      u[i] = ui;
    }
  }
}

struct Stage2Table {
  float* p[kMaxTensors];
  const float* u[kMaxTensors];
  void* out[kMaxTensors];
  const float* f[kMaxTensors];  // the tensor's factor, lr * trust ratio
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int n;
};

template <typename TO>
__global__ void __launch_bounds__(kThreads)
lamb_stage2_kernel(const __grid_constant__ Stage2Table t,
                   const float* __restrict__ noop,
                   const float* __restrict__ found_inf, int fault) {
  if (mt::raised(noop) || mt::raised(found_inf)) return;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    while (t.first_chunk[k + 1] <= ch) ++k;  // ch only grows, and so does k
    const long long start = (ch - t.first_chunk[k]) * kChunk;
    const long long end = min(start + kChunk, t.size[k]);
    const float f = *t.f[fault == kNextFactor && k + 1 < t.n ? k + 1 : k];
    float* p = t.p[k];
    const float* u = t.u[k];
    void* out = fault == kOutUnwritten ? nullptr : t.out[k];
#pragma unroll 4
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      const float pi = __fsub_rn(p[i], __fmul_rn(f, u[i]));
      p[i] = pi;
      if (out != nullptr) mt::store<TO>(out, i, pi);
    }
  }
}

template <typename TO>
int launch_stage2(const Stage2Table& t, const float* noop,
                  const float* found_inf, int fault, cudaStream_t s) {
  const long long chunks = t.first_chunk[t.n];
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  lamb_stage2_kernel<TO><<<blocks, kThreads, 0, s>>>(t, noop, found_inf,
                                                     fault);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Stage 1 over the n (1..64) tensors of sizes[k] elements: g[k] (g_dtype
// 0 fp32, 1 bf16) times *inv_scale (null: no product) and divided by
// *clip (null: no clipping), m[k] and v[k] (fp32) in place, the update
// into u[k] (fp32; may be g[k] where g is fp32) from the fp32 p[k]. The
// bias corrections are bc1 and bc2, or, where step is not null, those of
// *step (int32, the count after this update). Nothing is written when
// *noop or *found_inf (null: 0) is > 0. fault: 0, or a planted fault (1
// the gradient not unscaled, 2 not clipped). Returns the CUDA error of
// the launch (0 on success); -1 for a count, size, dtype or fault the
// kernel does not take.
extern "C" int apex_lamb_stage1(void* const* g, void* const* p, void* const* m,
                                void* const* v, void* const* u,
                                const long long* sizes, int n, int g_dtype,
                                const float* noop, const float* found_inf,
                                const float* clip, const int* step,
                                const float* inv_scale, float bc1, float bc2,
                                float b1, float beta3, float b2,
                                float one_minus_b2, float eps, float wd,
                                int adam_w, int fault, void* stream) {
  if (n < 1 || n > kMaxTensors || fault < 0 || fault > 2 || noop == nullptr)
    return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] < 0) return -1;
    t.g[k] = g[k];
    t.p[k] = static_cast<const float*>(p[k]);
    t.m[k] = static_cast<float*>(m[k]);
    t.v[k] = static_cast<float*>(v[k]);
    t.u[k] = static_cast<float*>(u[k]);
    if (sizes[k] > 0 && g_dtype != mt::kFloat32 && u[k] == g[k]) return -1;
    t.size[k] = sizes[k];
    t.first_chunk[k + 1] = t.first_chunk[k] + (sizes[k] + kChunk - 1) / kChunk;
  }
  const long long chunks = t.first_chunk[n];
  if (chunks == 0) return 0;
  const Hyper hp{bc1, bc2, b1, beta3, b2, one_minus_b2, eps, wd, adam_w, fault};
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == mt::kFloat32)
    lamb_kernel<float><<<blocks, kThreads, 0, s>>>(t, hp, noop, found_inf,
                                                   clip, step, inv_scale);
  else if (g_dtype == mt::kBFloat16)
    lamb_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        t, hp, noop, found_inf, clip, step, inv_scale);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 over the n (1..64) tensors of sizes[k] elements: p[k] (fp32)
// -= *factors[k] * u[k] (each product rounded, then the difference),
// then out[k] (out_dtype 0 fp32, 1 bf16, or -1: none, out may be null)
// written from the new p[k]; factors[k] points at tensor k's device fp32
// factor. Nothing
// is written when *noop or *found_inf (null: 0) is > 0. fault: 0, or a
// planted fault (1 tensor k moved by factors[k + 1], 2 the outputs
// unwritten). Returns the CUDA error of the launch (0 on success); -1 for
// a count, size, dtype or fault the kernel does not take.
extern "C" int apex_lamb_stage2(void* const* p, void* const* u,
                                void* const* out, void* const* factors,
                                const long long* sizes, int n, int out_dtype,
                                const float* noop, const float* found_inf,
                                int fault, void* stream) {
  if (n < 1 || n > kMaxTensors || fault < 0 || fault > 2 || noop == nullptr)
    return -1;
  Stage2Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] < 0) return -1;
    t.p[k] = static_cast<float*>(p[k]);
    t.u[k] = static_cast<const float*>(u[k]);
    t.out[k] = out_dtype == mt::kNone ? nullptr : out[k];
    t.f[k] = static_cast<const float*>(factors[k]);
    if (t.f[k] == nullptr) return -1;
    t.size[k] = sizes[k];
    t.first_chunk[k + 1] = t.first_chunk[k] + (sizes[k] + kChunk - 1) / kChunk;
  }
  if (t.first_chunk[n] == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == mt::kNone)
    return launch_stage2<mt::None>(t, noop, found_inf, fault, s);
  if (out_dtype == mt::kFloat32)
    return launch_stage2<float>(t, noop, found_inf, fault, s);
  if (out_dtype == mt::kBFloat16)
    return launch_stage2<__nv_bfloat16>(t, noop, found_inf, fault, s);
  return -1;
}
