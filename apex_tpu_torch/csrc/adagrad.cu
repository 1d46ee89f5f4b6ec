// Multi-tensor Adagrad for Hopper (sm_90a), bound to Python with ctypes:
// FusedAdagrad's step (K5).
//
// The port's counterpart of apex_tpu/ops/multi_tensor.py
// `multi_tensor_adagrad` (:228-245), a jnp loop over the tensors that XLA
// fuses (no Pallas kernel). Per element, in fp32 and in this order:
//   g = g / scale                     (scale a device scalar, where given:
//                                      FusedAdagrad's g.astype(f32) / scale;
//                                      bf16 or fp32 g widened in registers)
//   mode 0, wd != 0:  g = g + wd * p  (L2 into the gradient)
//   h = h + g * g
//   u = g / (sqrt(h) + eps)
//   mode 1, wd != 0:  u = u + wd * p  (decoupled, adagrad_w_mode)
//   p = p - lr * u
// Every product, sum, quotient and the square root is a round-to-nearest
// intrinsic (no FMA contraction), so the kernel gives the oracle's fp32
// values bit for bit. Nothing is written when the device fp32 noop flag
// is > 0. p and h are fp32; where an output list is given, the parameter
// is written from the new p in the same pass (amp's masters).
//
// Bound on the H100: memory. An element reads g, p and h and writes p and
// h: 18 bytes with a bf16 gradient, 20 with an fp32 one (GPT-2 345M's
// 406 M fp32 parameters: 8.13 GB, >= 2426 us at 3.35 TB/s).
//
// Design: the streaming body of #12, K1 and K3 (adam.cu, sgd.cu). Up to
// kMaxTensors = 64 tensors a launch from a table of their pointers,
// sizes, prefix chunk counts and heads passed by value as the kernel's
// parameter (3.3 KB); each tensor is a scalar head up to the first
// element where g, p, h and the output all lie on a 4-element boundary, a
// span of 4-element vectors (16 bytes of fp32, 8 of bf16) and a scalar
// tail (kernels/optim.py `adam_plan` gives the heads; a tensor whose
// lists are not aligned alike is all head). A chunk is kThreads * kUnroll
// vectors of the span and as many scalar elements: a thread loads its
// kUnroll vectors of g, p and h before any arithmetic, then updates and
// stores them, every access with the streaming hint. The grid is what the
// card holds resident, walking the chunks grid-stride.

#include "multi_tensor.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr int kUnroll = 4;  // vectors an array a thread loads
constexpr long long kVecChunk = kThreads * kUnroll;  // vectors a chunk

// planted faults (fault codes 1 and 2; no caller passes them): the
// denominator from h before g * g is added; the gradient not divided by
// the scale
constexpr int kOldSum = 1;
constexpr int kNotUnscaled = 2;

struct Table {
  const void* g[kMaxTensors];
  float* p[kMaxTensors];
  float* h[kMaxTensors];
  void* out[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int head[kMaxTensors];  // scalar elements before the span, -1: all
  int n;
};

struct Hyper {
  float lr, eps, wd;
  int mode, fault;
};

// One element's step on p and h, g already divided by the scale.
__device__ __forceinline__ void adagrad_update(const Hyper& hp, float g,
                                               float& p, float& h) {
  if (hp.mode == 0 && hp.wd != 0.f) g = __fadd_rn(g, __fmul_rn(hp.wd, p));
  const float h_new = __fadd_rn(h, __fmul_rn(g, g));
  const float root = __fsqrt_rn(hp.fault == kOldSum ? h : h_new);
  float u = __fdiv_rn(g, __fadd_rn(root, hp.eps));
  if (hp.mode == 1 && hp.wd != 0.f) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
  h = h_new;
  p = __fsub_rn(p, __fmul_rn(hp.lr, u));
}

template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads)
adagrad_vec_kernel(const __grid_constant__ Table t,
                   const __grid_constant__ Hyper hp,
                   const float* __restrict__ noop,
                   const float* __restrict__ scale) {
  if (mt::raised(noop)) return;
  const bool divide = scale != nullptr && hp.fault != kNotUnscaled;
  const float s = scale != nullptr ? *scale : 1.f;
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
    float* const h = t.h[k] + head;
    TO* const out = static_cast<TO*>(t.out[k]) + head;
    const long long base = local * kVecChunk + threadIdx.x;
    float4 gv[kUnroll], pv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        gv[u] = mt::ld4(g, i);
        pv[u] = mt::ld4(p, i);
        hv[u] = mt::ld4(h, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        float4 gu = gv[u];
        if (divide) {
          gu.x = __fdiv_rn(gu.x, s);
          gu.y = __fdiv_rn(gu.y, s);
          gu.z = __fdiv_rn(gu.z, s);
          gu.w = __fdiv_rn(gu.w, s);
        }
        adagrad_update(hp, gu.x, pv[u].x, hv[u].x);
        adagrad_update(hp, gu.y, pv[u].y, hv[u].y);
        adagrad_update(hp, gu.z, pv[u].z, hv[u].z);
        adagrad_update(hp, gu.w, pv[u].w, hv[u].w);
        mt::st4(p, i, pv[u]);
        mt::st4(h, i, hv[u]);
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
      if (divide) ge = __fdiv_rn(ge, s);
      float pe = mt::ld1(p, e);
      float he = mt::ld1(h, e);
      adagrad_update(hp, ge, pe, he);
      mt::st1(p, e, pe);
      mt::st1(h, e, he);
      mt::st1(out, e, pe);
    }
  }
}

// Blocks of adagrad_vec_kernel<TG, TO> the current device holds resident
// at once (mt::resident_blocks, cached here); -1 on an error.
template <typename TG, typename TO>
int resident_blocks() {
  static int cached[mt::kMaxDevices] = {};
  return mt::resident_blocks(
      reinterpret_cast<const void*>(adagrad_vec_kernel<TG, TO>), kThreads,
      cached);
}

template <typename TG, typename TO>
int launch(const Table& t, const Hyper& hp, const float* noop,
           const float* scale, cudaStream_t s) {
  const long long chunks = t.first_chunk[t.n];
  const int resident = resident_blocks<TG, TO>();
  if (resident < 1) return -1;
  const int blocks = static_cast<int>(chunks < resident ? chunks : resident);
  adagrad_vec_kernel<TG, TO><<<blocks, kThreads, 0, s>>>(t, hp, noop, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int by_out(int out_dtype, const Table& t, const Hyper& hp, const float* noop,
           const float* scale, cudaStream_t s) {
  if (out_dtype == mt::kNone)
    return launch<TG, mt::None>(t, hp, noop, scale, s);
  if (out_dtype == mt::kFloat32)
    return launch<TG, float>(t, hp, noop, scale, s);
  if (out_dtype == mt::kBFloat16)
    return launch<TG, __nv_bfloat16>(t, hp, noop, scale, s);
  return -1;
}

}  // namespace

// Adagrad over the n (1..64) tensors of sizes[k] elements: g[k] (g_dtype
// 0 fp32, 1 bf16) divided by *scale (null: no division), p[k] and h[k]
// (fp32) in place, then out[k] (out_dtype 0 or 1, or -1: none, out may be
// null) written from the new p[k]; heads[k] scalar elements before tensor
// k's vector span (0..3 with every array + heads[k] on a 4-element
// boundary, or sizes[k]: no vector span; kernels/optim.py `adam_plan`).
// mode 0 adds wd * p to the gradient, 1 to the update. Nothing is
// written when *noop > 0. fault: 0, or a planted fault (1 the denominator
// from the old h, 2 the scale not applied). Returns the CUDA error of the
// launch (0 on success); -1 for a count, size, head, dtype, mode or fault
// the kernel does not take.
extern "C" int apex_adagrad(void* const* g, void* const* p, void* const* h,
                            void* const* out, const long long* sizes,
                            const long long* heads, int n, int g_dtype,
                            int out_dtype, const float* noop,
                            const float* scale, float lr, float eps, float wd,
                            int mode, int fault, void* stream) {
  if (n < 1 || n > kMaxTensors || fault < 0 || fault > 2 || mode < 0 ||
      mode > 1 || noop == nullptr || heads == nullptr)
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
    t.h[k] = static_cast<float*>(h[k]);
    t.out[k] = out_dtype == mt::kNone ? nullptr : out[k];
    t.size[k] = size;
    t.head[k] = 0;
    const long long chunks = mt::stream_chunks(
        size, heads[k], 4, kVecChunk,
        {{t.g[k], g_dtype}, {t.p[k], mt::kFloat32}, {t.h[k], mt::kFloat32},
         {t.out[k], out_dtype}},
        &t.head[k]);
    if (chunks < 0) return -1;
    t.first_chunk[k + 1] = t.first_chunk[k] + chunks;
  }
  if (t.first_chunk[n] == 0) return 0;
  const Hyper hp{lr, eps, wd, mode, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == mt::kFloat32)
    return by_out<float>(out_dtype, t, hp, noop, scale, s);
  return by_out<__nv_bfloat16>(out_dtype, t, hp, noop, scale, s);
}
