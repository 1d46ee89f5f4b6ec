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
// Design: the reference's multi_tensor_apply. Eager PyTorch has no XLA
// to fuse a per-tensor loop, which for the model's 179 tensors would be
// ~2,000 small launches a step, so one launch updates up to kMaxTensors
// = 64 tensors: a table of their g, p, m, v pointers and sizes travels
// by value as the kernel's parameter (3.1 KB, under the 4 KB parameter
// limit, and captured as it is by a CUDA graph), each tensor is cut into
// chunks of 65,536 elements, and blocks walk the chunks grid-stride,
// finding a chunk's tensor from the table's prefix count of chunks.
// Threads read and write neighbouring elements (coalesced). Every
// operation is written with a round-to-nearest intrinsic so nvcc does
// not contract it into an FMA: the kernel gives the oracle's fp32
// results bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;
constexpr int kMaxBlocks = 132 * 8;

struct Table {
  float* g[kMaxTensors];
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int n;
};

struct Hyper {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int adam_w;
};

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
      float gi = g[i];
      const float pi = p[i];
      if (!hp.adam_w) gi = __fadd_rn(gi, __fmul_rn(hp.wd, pi));
      const float mi = __fadd_rn(__fmul_rn(hp.b1, m[i]),
                                 __fmul_rn(hp.one_minus_b1, gi));
      const float vi = __fadd_rn(__fmul_rn(hp.b2, v[i]),
                                 __fmul_rn(hp.one_minus_b2, __fmul_rn(gi, gi)));
      float u = __fdiv_rn(__fdiv_rn(mi, hp.bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, hp.bc2)), hp.eps));
      if (hp.adam_w && hp.wd != 0.f) u = __fadd_rn(u, __fmul_rn(hp.wd, pi));
      p[i] = __fsub_rn(pi, __fmul_rn(hp.lr, u));
      m[i] = mi;
      v[i] = vi;
    }
  }
}

}  // namespace

// Updates the n (1..64) fp32 tensors g[k], p[k], m[k], v[k] of sizes[k]
// elements in place. Returns the CUDA error of the launch (0 on
// success); -1 for a tensor count or size the kernel does not take.
extern "C" int apex_adam(void* const* g, void* const* p, void* const* m,
                         void* const* v, const long long* sizes, int n,
                         const float* noop, float lr, float bc1, float bc2,
                         float b1, float one_minus_b1, float b2,
                         float one_minus_b2, float eps, float wd, int adam_w,
                         void* stream) {
  if (n < 1 || n > kMaxTensors) return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] < 0) return -1;
    t.g[k] = static_cast<float*>(g[k]);
    t.p[k] = static_cast<float*>(p[k]);
    t.m[k] = static_cast<float*>(m[k]);
    t.v[k] = static_cast<float*>(v[k]);
    t.size[k] = sizes[k];
    t.first_chunk[k + 1] = t.first_chunk[k] + (sizes[k] + kChunk - 1) / kChunk;
  }
  const long long chunks = t.first_chunk[n];
  if (chunks == 0) return 0;
  const Hyper hp{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd,
                 adam_w};
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, hp, noop);
  return static_cast<int>(cudaGetLastError());
}
