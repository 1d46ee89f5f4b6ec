// Multi-tensor NovoGrad for Hopper (sm_90a), bound to Python with ctypes:
// FusedNovoGrad's step (K6).
//
// The port's counterpart of apex_tpu/ops/multi_tensor.py
// `multi_tensor_novograd` (:248-302), a jnp loop over the tensors that
// XLA fuses (no Pallas kernel). NovoGrad keeps one second moment a
// tensor, from the tensor's gradient norm, so a step is a reduction per
// tensor and then an elementwise pass, in fp32 and in this order:
//   g = g / scale                      (scale a device scalar, where given:
//                                       FusedNovoGrad's g.astype(f32) / scale)
//   n_k = sum(g * g)  (norm_type 2)    or  max(|g|)^2  (norm_type 0: inf)
//   v_k = step == 1 ? first : b2 * v_k + (1 - b2) * n_k,
//         first = init_zero ? (1 - b2) * n_k : n_k
//   per element:
//   gn = g / (sqrt(v_k) + eps)
//   moment_mode 0, wd != 0:  gn = gn + wd * p
//   m = b1 * m + beta3 * gn
//   u = m / bc1                        (bc1 = 1 - b1^step, or 1)
//   moment_mode 1, wd != 0:  u = u + wd * p
//   p = p - lr * u
// step is the device step count (int32, the count after this update, as
// JAX's FusedNovoGrad passes `state["step"] + where(noop > 0, 0, 1)`); bc1
// is multi_tensor.cuh `bias_correction`, the value of JAX's traced fp32
// power. (1 - b2) and beta3 are rounded to fp32 from double by the caller,
// as JAX rounds its weakly typed Python floats. Nothing is written, v
// included, when the device fp32 noop flag is > 0. p and m are fp32; v is
// fp32, one value a tensor (v[k] points at tensor k's); where an output
// list is given, the parameter is written from the new p in the same pass
// (amp's masters).
//
// Bound on the H100: memory. An element's gradient is read twice (once
// for its norm, once for the update) and p and m are read and written:
// 24 bytes with an fp32 gradient, 20 with a bf16 one (GPT-2 345M's 406 M
// fp32 parameters: 9.75 GB, >= 2911 us at 3.35 TB/s).
//
// Design: two kernels a table, each on the streaming body of #12, K1 and
// K3 (adam.cu, sgd.cu; the same table of up to kMaxTensors = 64 tensors,
// heads from kernels/optim.py `adam_plan`, chunks of kThreads * kUnroll
// 4-element vectors and as many scalar elements, a resident grid walking
// them grid-stride, 16-byte streaming loads):
//  1. novograd_norm_kernel: each chunk's partial (the sum of g * g in a
//     fixed order: a thread's own elements in turn, a warp's butterfly,
//     the eight warps in order; or the max of |g|) into scratch[chunk]; the
//     last block to finish (an integer count in scratch, no
//     floating-point atomics) sums each tensor's partials in a fixed
//     order (a thread's strided share in turn, then the block as above)
//     and writes v[k]. The order depends on the sizes and alignment only,
//     never on which block ran what, so two runs give the same bits.
//  2. novograd_update_kernel: the elementwise pass, sqrt(v_k) + eps once
//     a chunk.
// Every operation is a round-to-nearest intrinsic (no FMA contraction):
// given the norms, the update is the oracle's bit for bit; the norms are
// sums in another order than XLA's or torch's.

#include "multi_tensor.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTensors = 64;
constexpr int kUnroll = 4;  // vectors an array a thread loads
constexpr long long kVecChunk = kThreads * kUnroll;  // vectors a chunk

// planted faults (fault codes 1 and 2; no caller passes them): each
// tensor's last chunk left out of its norm; the first step's v never
// taken
constexpr int kLastChunkDropped = 1;
constexpr int kFirstIgnored = 2;

struct Table {
  const void* g[kMaxTensors];
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  void* out[kMaxTensors];
  float* v[kMaxTensors];  // tensor k's second moment, one fp32 value
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int head[kMaxTensors];  // scalar elements before the span, -1: all
  int n;
};

struct Hyper {
  float lr, b1, beta3, b2, one_minus_b2, eps, wd;
  int moment_mode, l2, init_zero, bias_correction, fault;
};

// a NaN-keeping max (jnp.max's): NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The norm's accumulation of one element: g * g added, or |g| maxed.
__device__ __forceinline__ float accumulate(bool l2, float acc, float g) {
  return l2 ? __fadd_rn(acc, __fmul_rn(g, g)) : nan_max(acc, fabsf(g));
}

// The block's sum (or max) of x in a fixed order, in thread 0: each
// warp's butterfly, then the warps in order. `shared` holds kWarps
// floats; every thread of the block calls it.
__device__ __forceinline__ float block_reduce(bool l2, float x,
                                              float* shared) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = l2 ? __fadd_rn(x, y) : nan_max(x, y);
  }
  __syncthreads();  // shared free from an earlier call
  if (lane == 0) shared[warp] = x;
  __syncthreads();
  float r = shared[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w)
      r = l2 ? __fadd_rn(r, shared[w]) : nan_max(r, shared[w]);
  return r;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
novograd_norm_kernel(const __grid_constant__ Table t,
                     const __grid_constant__ Hyper hp,
                     const float* __restrict__ noop,
                     const int* __restrict__ step,
                     const float* __restrict__ scale,
                     float* __restrict__ partials,
                     unsigned* __restrict__ done) {
  if (mt::raised(noop)) return;
  __shared__ float shared[kWarps];
  __shared__ bool last;
  const bool l2 = hp.l2 != 0;
  const bool divide = scale != nullptr;
  const float s = divide ? *scale : 1.f;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long local = c - t.first_chunk[k];
    const long long size = t.size[k];
    const long long head = t.head[k] < 0 ? size : t.head[k];
    const long long vecs = (size - head) / 4;
    const TG* const g = static_cast<const TG*>(t.g[k]) + head;
    const long long base = local * kVecChunk + threadIdx.x;
    float4 gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) gv[u] = mt::ld4(g, i);
    }
    float acc = 0.f;
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
        acc = accumulate(l2, acc, gu.x);
        acc = accumulate(l2, acc, gu.y);
        acc = accumulate(l2, acc, gu.z);
        acc = accumulate(l2, acc, gu.w);
      }
    }
    const long long scalars = size - 4 * vecs;
    const long long q_end = min((local + 1) * 4 * kVecChunk, scalars);
    for (long long q = local * 4 * kVecChunk + threadIdx.x; q < q_end;
         q += kThreads) {
      const long long e = (q < head ? q : q + 4 * vecs) - head;
      float ge = mt::ld1(g, e);
      if (divide) ge = __fdiv_rn(ge, s);
      acc = accumulate(l2, acc, ge);
    }
    const float part = block_reduce(l2, acc, shared);
    if (threadIdx.x == 0) partials[c] = part;
  }
  // the last block to get here finishes every tensor's norm and v
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partials before its count
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int now = *step;
  const bool first = now == 1 && hp.fault != kFirstIgnored;
  for (int j = 0; j < t.n; ++j) {
    long long end = t.first_chunk[j + 1];
    if (hp.fault == kLastChunkDropped && end > t.first_chunk[j]) --end;
    float acc = 0.f;
    for (long long c = t.first_chunk[j] + threadIdx.x; c < end; c += kThreads)
      acc = l2 ? __fadd_rn(acc, __ldcg(partials + c))
               : nan_max(acc, __ldcg(partials + c));
    const float total = block_reduce(l2, acc, shared);
    if (threadIdx.x == 0) {
      const float norm = l2 ? total : __fmul_rn(total, total);
      const float blended = __fmul_rn(hp.one_minus_b2, norm);
      float* const v = t.v[j];
      *v = first ? (hp.init_zero ? blended : norm)
                 : __fadd_rn(__fmul_rn(hp.b2, *v), blended);
    }
  }
}

// One element's step on p and m, g already divided by the scale.
__device__ __forceinline__ void novograd_update(const Hyper& hp, float denom,
                                                float bc1, float g, float& p,
                                                float& m) {
  float gn = __fdiv_rn(g, denom);
  if (hp.moment_mode == 0 && hp.wd != 0.f)
    gn = __fadd_rn(gn, __fmul_rn(hp.wd, p));
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.beta3, gn));
  float u = __fdiv_rn(m, bc1);
  if (hp.moment_mode == 1 && hp.wd != 0.f)
    u = __fadd_rn(u, __fmul_rn(hp.wd, p));
  p = __fsub_rn(p, __fmul_rn(hp.lr, u));
}

template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads)
novograd_update_kernel(const __grid_constant__ Table t,
                       const __grid_constant__ Hyper hp,
                       const float* __restrict__ noop,
                       const int* __restrict__ step,
                       const float* __restrict__ scale) {
  if (mt::raised(noop)) return;
  const bool divide = scale != nullptr;
  const float s = divide ? *scale : 1.f;
  const float bc1 =
      hp.bias_correction ? mt::bias_correction(hp.b1, *step) : 1.f;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long local = c - t.first_chunk[k];
    const long long size = t.size[k];
    const long long head = t.head[k] < 0 ? size : t.head[k];
    const long long vecs = (size - head) / 4;
    const float denom = __fadd_rn(__fsqrt_rn(*t.v[k]), hp.eps);
    const TG* const g = static_cast<const TG*>(t.g[k]) + head;
    float* const p = t.p[k] + head;
    float* const m = t.m[k] + head;
    TO* const out = static_cast<TO*>(t.out[k]) + head;
    const long long base = local * kVecChunk + threadIdx.x;
    float4 gv[kUnroll], pv[kUnroll], mv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vecs) {
        gv[u] = mt::ld4(g, i);
        pv[u] = mt::ld4(p, i);
        mv[u] = mt::ld4(m, i);
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
        novograd_update(hp, denom, bc1, gu.x, pv[u].x, mv[u].x);
        novograd_update(hp, denom, bc1, gu.y, pv[u].y, mv[u].y);
        novograd_update(hp, denom, bc1, gu.z, pv[u].z, mv[u].z);
        novograd_update(hp, denom, bc1, gu.w, pv[u].w, mv[u].w);
        mt::st4(p, i, pv[u]);
        mt::st4(m, i, mv[u]);
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
      float me = mt::ld1(m, e);
      novograd_update(hp, denom, bc1, ge, pe, me);
      mt::st1(p, e, pe);
      mt::st1(m, e, me);
      mt::st1(out, e, pe);
    }
  }
}

// Blocks of each kernel the current device holds resident at once
// (mt::resident_blocks, cached here); -1 on an error.
template <typename TG>
int norm_blocks() {
  static int cached[mt::kMaxDevices] = {};
  return mt::resident_blocks(
      reinterpret_cast<const void*>(novograd_norm_kernel<TG>), kThreads,
      cached);
}

template <typename TG, typename TO>
int update_blocks() {
  static int cached[mt::kMaxDevices] = {};
  return mt::resident_blocks(
      reinterpret_cast<const void*>(novograd_update_kernel<TG, TO>), kThreads,
      cached);
}

template <typename TG, typename TO>
int launch(const Table& t, const Hyper& hp, const float* noop, const int* step,
           const float* scale, float* partials, unsigned* done,
           cudaStream_t s) {
  const long long chunks = t.first_chunk[t.n];
  const int resident_norm = norm_blocks<TG>();
  const int resident = update_blocks<TG, TO>();
  if (resident_norm < 1 || resident < 1) return -1;
  const int norm_grid =
      static_cast<int>(chunks < resident_norm ? chunks : resident_norm);
  novograd_norm_kernel<TG><<<norm_grid, kThreads, 0, s>>>(
      t, hp, noop, step, scale, partials, done);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(chunks < resident ? chunks : resident);
  novograd_update_kernel<TG, TO><<<grid, kThreads, 0, s>>>(t, hp, noop, step,
                                                           scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int by_out(int out_dtype, const Table& t, const Hyper& hp, const float* noop,
           const int* step, const float* scale, float* partials,
           unsigned* done, cudaStream_t s) {
  if (out_dtype == mt::kNone)
    return launch<TG, mt::None>(t, hp, noop, step, scale, partials, done, s);
  if (out_dtype == mt::kFloat32)
    return launch<TG, float>(t, hp, noop, step, scale, partials, done, s);
  if (out_dtype == mt::kBFloat16)
    return launch<TG, __nv_bfloat16>(t, hp, noop, step, scale, partials,
                                     done, s);
  return -1;
}

}  // namespace

// NovoGrad over the n (1..64) tensors of sizes[k] elements: g[k] (g_dtype
// 0 fp32, 1 bf16) divided by *scale (null: no division), v[k] (fp32, one
// value: tensor k's second moment) from the norm of the divided g[k]
// (norm_type 2: L2, squared; 0: the max norm, squared), then p[k] and
// m[k] (fp32) in place, then out[k] (out_dtype 0 or 1, or -1: none, out
// may be null) written from the new p[k]; heads[k] scalar elements before
// tensor k's vector span (kernels/optim.py `adam_plan`). *step (int32) is
// the count after this update: v takes its first value where it is 1, and
// with bias_correction bc1 = 1 - b1^step. moment_mode 0 adds wd * p to
// the normalised gradient, 1 to the update. scratch holds scratch_len
// floats, all 0: a partial for each chunk and, in its last float, the
// blocks' count. Nothing is written when *noop > 0. fault: 0, or a
// planted fault (1 each tensor's last chunk out of its norm, 2 the first
// step's v never taken). Returns the CUDA error of the launches (0 on
// success); -1 for a count, size, head, dtype, mode, scratch or fault the
// kernels do not take.
extern "C" int apex_novograd(void* const* g, void* const* p, void* const* m,
                             void* const* out, void* const* v,
                             const long long* sizes, const long long* heads,
                             int n, int g_dtype, int out_dtype,
                             const float* noop, const int* step,
                             const float* scale, float* scratch,
                             long long scratch_len, float lr, float b1,
                             float beta3, float b2, float one_minus_b2,
                             float eps, float wd, int moment_mode,
                             int norm_type, int init_zero,
                             int bias_correction, int fault, void* stream) {
  if (n < 1 || n > kMaxTensors || fault < 0 || fault > 2 || moment_mode < 0 ||
      moment_mode > 1 || (norm_type != 0 && norm_type != 2) ||
      noop == nullptr || step == nullptr || heads == nullptr ||
      scratch == nullptr || scratch_len < 1)
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
    if (size < 0 || v[k] == nullptr) return -1;
    t.g[k] = g[k];
    t.p[k] = static_cast<float*>(p[k]);
    t.m[k] = static_cast<float*>(m[k]);
    t.out[k] = out_dtype == mt::kNone ? nullptr : out[k];
    t.v[k] = static_cast<float*>(v[k]);
    t.size[k] = size;
    t.head[k] = 0;
    const long long chunks = mt::stream_chunks(
        size, heads[k], 4, kVecChunk,
        {{t.g[k], g_dtype}, {t.p[k], mt::kFloat32}, {t.m[k], mt::kFloat32},
         {t.out[k], out_dtype}},
        &t.head[k]);
    if (chunks < 0) return -1;
    t.first_chunk[k + 1] = t.first_chunk[k] + chunks;
  }
  if (t.first_chunk[n] == 0) return 0;
  if (t.first_chunk[n] > scratch_len - 1) return -1;
  const Hyper hp{lr,          b1, beta3, b2, one_minus_b2, eps, wd,
                 moment_mode, norm_type == 2 ? 1 : 0, init_zero,
                 bias_correction, fault};
  unsigned* done = reinterpret_cast<unsigned*>(scratch + scratch_len - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == mt::kFloat32)
    return by_out<float>(out_dtype, t, hp, noop, step, scale, scratch, done,
                         s);
  return by_out<__nv_bfloat16>(out_dtype, t, hp, noop, step, scale, scratch,
                               done, s);
}
