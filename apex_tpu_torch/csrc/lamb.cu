// Multi-tensor LAMB stage 1 (moments and raw update) for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces apex_tpu/kernels/optim.py `_lamb_kernel` (launched by
// `fused_lamb_mvu`), which updates one flat fp32 buffer per call; the JAX
// FusedLAMB computes the same per-tensor step with `ops/multi_tensor.py`
// `_lamb_tensor_direction`, a jnp loop over the parameter tensors that
// XLA fuses. Per element, in fp32 and in this order:
//   g = g / clip                      (the global gradient-clip factor)
//   mode 0 (L2, wd != 0):  g = g + wd * p
//   m = b1 * m + beta3 * g;   v = b2 * v + (1 - b2) * g * g
//   u = (m / bc1) / (sqrt(v / bc2) + eps)
//   mode 1 (decoupled, wd != 0):  u = u + wd * p
// m and v are written in place and u is written over g, as the
// reference's multi_tensor_lamb stage 1 stores its update in the
// gradient: no buffer of the parameters' size is allocated. The
// per-tensor trust ratio (||p|| / ||u||) and p -= lr * ratio * u stay
// with the caller, as they do in JAX. (1 - b2) and beta3 are rounded to
// fp32 from double by the caller, as JAX rounds its weakly typed Python
// floats. The clip factor is read from a device scalar (null: no
// clipping), so the caller needs no host synchronisation. Nothing is
// written, leaving g, m and v untouched, when the device-side fp32 `noop`
// flag is non-zero.
//
// Bound on the H100: memory. 28 bytes per parameter (read g, p, m, v;
// write m, v, u) and ~16 flops: 10.29 GB, >= 3.07 ms at 3.35 TB/s for
// BERT-large's 367 M parameters.
//
// Design: adam.cu's multi_tensor_apply. One launch updates up to
// kMaxTensors = 64 tensors from a table of their g, p, m, v pointers and
// sizes passed by value as the kernel's parameter (3.1 KB, under the 4 KB
// parameter limit); each tensor is cut into chunks of 65,536 elements
// that blocks walk grid-stride. Threads read and write neighbouring
// elements (coalesced). Every operation is written with a
// round-to-nearest intrinsic so nvcc does not contract it into an FMA:
// the kernel gives the oracle's fp32 results bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;
constexpr int kMaxBlocks = 132 * 8;

struct Table {
  float* g[kMaxTensors];
  const float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int n;
};

struct Hyper {
  float bc1, bc2, b1, beta3, b2, one_minus_b2, eps, wd;
  int adam_w;
};

__global__ void __launch_bounds__(kThreads)
lamb_kernel(const __grid_constant__ Table t, const __grid_constant__ Hyper hp,
            const float* __restrict__ noop, const float* __restrict__ clip) {
  if (*noop != 0.f) return;
  const float c = clip != nullptr ? *clip : 1.f;
  const long long chunks = t.first_chunk[t.n];
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    int k = 0;
    while (t.first_chunk[k + 1] <= ch) ++k;
    const long long start = (ch - t.first_chunk[k]) * kChunk;
    const long long end = min(start + kChunk, t.size[k]);
    float* __restrict__ g = t.g[k];
    const float* __restrict__ p = t.p[k];
    float* __restrict__ m = t.m[k];
    float* __restrict__ v = t.v[k];
#pragma unroll 4
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      float gi = clip != nullptr ? __fdiv_rn(g[i], c) : g[i];
      const float pi = p[i];
      if (!hp.adam_w && hp.wd != 0.f) gi = __fadd_rn(gi, __fmul_rn(hp.wd, pi));
      const float mi = __fadd_rn(__fmul_rn(hp.b1, m[i]), __fmul_rn(hp.beta3, gi));
      const float vi = __fadd_rn(__fmul_rn(hp.b2, v[i]),
                                 __fmul_rn(hp.one_minus_b2, __fmul_rn(gi, gi)));
      float u = __fdiv_rn(__fdiv_rn(mi, hp.bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, hp.bc2)), hp.eps));
      if (hp.adam_w && hp.wd != 0.f) u = __fadd_rn(u, __fmul_rn(hp.wd, pi));
      m[i] = mi;
      v[i] = vi;
      g[i] = u;
    }
  }
}

}  // namespace

// Stage 1 over the n (1..64) fp32 tensors g[k], p[k], m[k], v[k] of
// sizes[k] elements: m and v in place, the update into g. clip: a device
// fp32 scalar or null. Returns the CUDA error of the launch (0 on
// success); -1 for a tensor count or size the kernel does not take.
extern "C" int apex_lamb_stage1(void* const* g, void* const* p, void* const* m,
                                void* const* v, const long long* sizes, int n,
                                const float* noop, const float* clip,
                                float bc1, float bc2, float b1, float beta3,
                                float b2, float one_minus_b2, float eps,
                                float wd, int adam_w, void* stream) {
  if (n < 1 || n > kMaxTensors) return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] < 0) return -1;
    t.g[k] = static_cast<float*>(g[k]);
    t.p[k] = static_cast<const float*>(p[k]);
    t.m[k] = static_cast<float*>(m[k]);
    t.v[k] = static_cast<float*>(v[k]);
    t.size[k] = sizes[k];
    t.first_chunk[k + 1] = t.first_chunk[k] + (sizes[k] + kChunk - 1) / kChunk;
  }
  const long long chunks = t.first_chunk[n];
  if (chunks == 0) return 0;
  const Hyper hp{bc1, bc2, b1, beta3, b2, one_minus_b2, eps, wd, adam_w};
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  lamb_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, hp, noop, clip);
  return static_cast<int>(cudaGetLastError());
}
