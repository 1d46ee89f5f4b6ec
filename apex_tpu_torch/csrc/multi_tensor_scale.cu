// Multi-tensor scale and axpby with overflow detection for Hopper
// (sm_90a), bound to Python with ctypes: amp's unscale of the gradients.
//
// The port's counterpart of apex_tpu/ops/multi_tensor.py
// `multi_tensor_scale` (:46) and `multi_tensor_axpby` (:63), jnp loops
// over the tensors that XLA fuses (no Pallas kernel): JAX's AmpOptimizer
// and LossScaler unscale every gradient a step with the first. Per
// element, in fp32:
//   mode 0 (scale): r = x * s          s read from a device fp32 scalar
//   mode 1 (axpby): r = a * x + b * y  two products rounded, then the sum
// and out = r rounded to out's dtype (bf16 or fp32; x, y and out each
// bf16 or fp32, out may be x itself). The device fp32 flag is set to 1
// where some r, the fp32 value before that rounding, is inf or NaN (JAX's
// `_finite_flag` of the fp32 product); it is never cleared, so a flag
// that starts at 0 ends as max(0, found), as JAX returns it. Every
// element is written whatever the flag holds.
//
// Bound on the H100: memory. An element reads x (and y) once and writes
// out once: 4 bytes a bf16 gradient unscaled in place, 8 an fp32 one.
//
// Both designs take adam.cu's multi_tensor_apply: one launch covers up
// to kMaxTensors = 64 tensors from a table of their pointers, sizes,
// prefix chunk counts and heads passed by value as the kernel's
// parameter (2.8 KB), and blocks walk the chunks grid-stride. A block
// ORs its threads' flags (__syncthreads_or) and one thread writes the
// flag. Products and sums are written with round-to-nearest intrinsics,
// so nvcc contracts nothing into an FMA: both designs give the oracle's
// values bit for bit.
//
// The streaming body (path 1, scale_vec_kernel; #12's, adam.cu): each
// tensor is a scalar head up to the first element where x, y and out all
// lie on a vector boundary, a span of vectors and a scalar tail
// (kernels/optim.py `adam_plan` gives the heads; a tensor whose lists
// are not aligned alike is all head). A vector is 8 elements where x, y
// and out are all bf16 (one 16-byte access) and 4 otherwise (16 bytes of
// fp32, 8 of bf16; kernels/scale.py `vector_width`). A chunk is kThreads
// * kUnroll vectors of the span and as many scalar elements: a thread
// loads its kUnroll vectors of each input before it computes or stores
// anything, and every access carries the streaming hint. The grid is
// what the card holds resident (occupancy times SMs), and the chunks are
// small, so the launch's last wave is short. The first design (path 0,
// scale_kernel) stays: chunks of 65,536 elements walked by a fixed 132 *
// 8 blocks, one scalar access a thread per array, each element stored
// before the next one is loaded.

#include "multi_tensor.cuh"

namespace {

using mt::bf16;

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;  // path 0: elements a chunk
constexpr int kMaxBlocks = 132 * 8;  // path 0: the grid
constexpr int kUnroll = 4;           // path 1: vectors an input a thread loads
constexpr long long kVecChunk = kThreads * kUnroll;  // path 1: vectors a chunk

// planted faults (fault codes 1 and 2; no caller passes them), on either
// path: the flag never written; each tensor's last element left as it
// was (path 1: the last element of its tail, or its whole last vector
// where it has no tail)
constexpr int kFlagUnset = 1;
constexpr int kLastSkipped = 2;

struct Table {
  const void* x[kMaxTensors];
  const void* y[kMaxTensors];  // axpby only
  void* out[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int head[kMaxTensors];  // path 1: scalar elements before the span, -1: all
  int n;
};

// One element's result in fp32: x * s, or a * x + b * y.
template <bool kAxpby>
__device__ __forceinline__ float result(float x, float y, float s, float a,
                                        float b) {
  if constexpr (kAxpby) return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
  return __fmul_rn(x, s);
}

template <typename TX, typename TY, typename TO, bool kAxpby>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const __grid_constant__ Table t, const float* __restrict__ scale,
             float a, float b, float* flag, int fault) {
  const float s = kAxpby ? 0.f : *scale;
  bool bad = false;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long start = (c - t.first_chunk[k]) * kChunk;
    long long end = min(start + kChunk, t.size[k]);
    if (fault == kLastSkipped && end == t.size[k]) --end;
    const TX* x = static_cast<const TX*>(t.x[k]);
    const TY* y = static_cast<const TY*>(t.y[k]);
    void* out = t.out[k];
#pragma unroll 4
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      float r;
      if constexpr (kAxpby) {
        r = __fadd_rn(__fmul_rn(a, mt::to_float(x[i])),
                      __fmul_rn(b, mt::to_float(y[i])));
      } else {
        r = __fmul_rn(mt::to_float(x[i]), s);
      }
      bad |= !isfinite(r);
      mt::store<TO>(out, i, r);
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0 && fault != kFlagUnset)
    *flag = 1.f;
}

// Vector i of a list (kVec elements from the span's start), widened to
// fp32 or rounded from it; 8-element vectors are bf16 only.
template <int kVec, typename T>
__device__ __forceinline__ void ldv(const T* a, long long i, float (&x)[kVec]) {
  if constexpr (kVec == 8) {
    mt::ld8(a, i, x);
  } else {
    const float4 v = mt::ld4(a, i);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
}
template <int kVec, typename T>
__device__ __forceinline__ void stv(T* a, long long i, const float (&x)[kVec]) {
  if constexpr (kVec == 8)
    mt::st8(a, i, x);
  else
    mt::st4(a, i, make_float4(x[0], x[1], x[2], x[3]));
}

template <typename TX, typename TY, typename TO, bool kAxpby, int kVec>
__global__ void __launch_bounds__(kThreads)
scale_vec_kernel(const __grid_constant__ Table t,
                 const float* __restrict__ scale, float a, float b,
                 float* flag, int fault) {
  const float s = kAxpby ? 0.f : *scale;
  bool bad = false;
  const long long chunks = t.first_chunk[t.n];
  int k = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first_chunk[k + 1] <= c) ++k;  // c only grows, and so does k
    const long long local = c - t.first_chunk[k];
    const long long size = t.size[k];
    const long long head = t.head[k] < 0 ? size : t.head[k];
    const long long vecs = (size - head) / kVec;
    const long long scalars = size - kVec * vecs;
    long long vec_end = vecs, scalar_end = scalars;
    if (fault == kLastSkipped) {  // the tail's last element, or the last vector
      if (scalars > head || vecs == 0)
        --scalar_end;
      else
        --vec_end;
    }
    // the vector span: vector i of each list starts at element head + kVec i
    const TX* const x = static_cast<const TX*>(t.x[k]) + head;
    const TY* const y = static_cast<const TY*>(t.y[k]) + head;
    TO* const out = static_cast<TO*>(t.out[k]) + head;
    const long long base = local * kVecChunk + threadIdx.x;
    float xv[kUnroll][kVec], yv[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vec_end) {
        ldv<kVec>(x, i, xv[u]);
        if constexpr (kAxpby) ldv<kVec>(y, i, yv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < vec_end) {
        float r[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          r[e] = result<kAxpby>(xv[u][e], kAxpby ? yv[u][e] : 0.f, s, a, b);
          bad |= !isfinite(r[e]);
        }
        stv<kVec>(out, i, r);
      }
    }
    // the scalar head and tail: scalar q is element q < head ? q : q + kVec vecs
    const long long q_end = min((local + 1) * kVec * kVecChunk, scalar_end);
    for (long long q = local * kVec * kVecChunk + threadIdx.x; q < q_end;
         q += kThreads) {
      const long long e = (q < head ? q : q + kVec * vecs) - head;
      const float r = result<kAxpby>(mt::ld1(x, e),
                                     kAxpby ? mt::ld1(y, e) : 0.f, s, a, b);
      bad |= !isfinite(r);
      mt::st1(out, e, r);
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0 && fault != kFlagUnset)
    *flag = 1.f;
}

// Blocks of scale_vec_kernel<...> the current device holds resident at
// once (mt::resident_blocks, cached here); -1 on an error.
template <typename TX, typename TY, typename TO, bool kAxpby, int kVec>
int resident_blocks() {
  static int cached[mt::kMaxDevices] = {};
  return mt::resident_blocks(
      reinterpret_cast<const void*>(scale_vec_kernel<TX, TY, TO, kAxpby, kVec>),
      kThreads, cached);
}

struct Launch {
  const Table& t;
  const float* scale;
  float a, b;
  float* flag;
  int fault, path;
  cudaStream_t stream;
};

// The streaming body's vector: 8 elements where the lists the kernel
// reads and writes are all bf16 (one 16-byte access), else 4.
template <typename TX, typename TY, typename TO, bool kAxpby>
constexpr int kVecOf = std::is_same_v<TX, bf16> && std::is_same_v<TO, bf16> &&
                               (!kAxpby || std::is_same_v<TY, bf16>)
                           ? 8
                           : 4;

template <typename TX, typename TY, typename TO, bool kAxpby, int kVec>
int launch_vec(const Launch& l) {
  const int resident = resident_blocks<TX, TY, TO, kAxpby, kVec>();
  if (resident < 1) return -1;
  const long long chunks = l.t.first_chunk[l.t.n];
  const int blocks = static_cast<int>(chunks < resident ? chunks : resident);
  scale_vec_kernel<TX, TY, TO, kAxpby, kVec><<<blocks, kThreads, 0, l.stream>>>(
      l.t, l.scale, l.a, l.b, l.flag, l.fault);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY, typename TO, bool kAxpby>
int launch(const Launch& l) {
  if (l.path == 0) {
    const long long chunks = l.t.first_chunk[l.t.n];
    const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
    scale_kernel<TX, TY, TO, kAxpby><<<blocks, kThreads, 0, l.stream>>>(
        l.t, l.scale, l.a, l.b, l.flag, l.fault);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_vec<TX, TY, TO, kAxpby, kVecOf<TX, TY, TO, kAxpby>>(l);
}

template <typename TX, typename TY, bool kAxpby>
int by_out(int out_dtype, const Launch& l) {
  if (out_dtype == mt::kFloat32) return launch<TX, TY, float, kAxpby>(l);
  if (out_dtype == mt::kBFloat16) return launch<TX, TY, bf16, kAxpby>(l);
  return -1;
}

template <typename TX, bool kAxpby>
int by_y(int y_dtype, int out_dtype, const Launch& l) {
  if (y_dtype == mt::kFloat32) return by_out<TX, float, kAxpby>(out_dtype, l);
  if (y_dtype == mt::kBFloat16) return by_out<TX, bf16, kAxpby>(out_dtype, l);
  return -1;
}

template <bool kAxpby>
int by_x(int x_dtype, int y_dtype, int out_dtype, const Launch& l) {
  if (x_dtype == mt::kFloat32)
    return by_y<float, kAxpby>(y_dtype, out_dtype, l);
  if (x_dtype == mt::kBFloat16)
    return by_y<bf16, kAxpby>(y_dtype, out_dtype, l);
  return -1;
}

}  // namespace

// mode 0: out[k] = x[k] * (*scale); mode 1: out[k] = a * x[k] + b * y[k]
// (y ignored, may be null, in mode 0), over the n (1..64) tensors of
// sizes[k] elements, each list of one dtype (0 fp32, 1 bf16; y_dtype 0 in
// mode 0). *flag is set to 1 where a result is not finite. path: 0 = the
// first design (scale_kernel; heads not read, may be null), 1 = the
// streaming body (scale_vec_kernel) with heads[k] scalar elements before
// tensor k's vector span (below the vector width, with every list +
// heads[k] on a vector boundary, or sizes[k]: no vector span;
// kernels/optim.py `adam_plan` at kernels/scale.py `vector_width`: 8
// elements where x, y and out are all bf16, else 4). fault: 0, or a
// planted fault on either path (1 the flag never written, 2 each
// tensor's last element, or on path 1 its last vector, skipped).
// Returns the CUDA error of the launch (0 on success); -1 for a count,
// size, head, dtype, mode, fault or path the kernel does not take.
extern "C" int apex_multi_tensor_scale(void* const* x, void* const* y,
                                       void* const* out,
                                       const long long* sizes,
                                       const long long* heads, int n,
                                       int x_dtype, int y_dtype,
                                       int out_dtype, int mode,
                                       const float* scale, float a, float b,
                                       float* flag, int fault, int path,
                                       void* stream) {
  if (n < 1 || n > kMaxTensors || mode < 0 || mode > 1 || fault < 0 ||
      fault > 2 || path < 0 || path > 1 || flag == nullptr ||
      (mode == 0 && scale == nullptr) || (path != 0 && heads == nullptr))
    return -1;
  if (mode == 0) y_dtype = mt::kFloat32;
  for (int dtype : {x_dtype, y_dtype, out_dtype})
    if (dtype != mt::kFloat32 && dtype != mt::kBFloat16) return -1;
  const bool all_bf16 = x_dtype == mt::kBFloat16 && out_dtype == mt::kBFloat16 &&
                        (mode == 0 || y_dtype == mt::kBFloat16);
  const int width = all_bf16 ? 8 : 4;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    const long long size = sizes[k];
    if (size < 0) return -1;
    t.x[k] = x[k];
    t.y[k] = mode == 1 ? y[k] : nullptr;
    t.out[k] = out[k];
    t.size[k] = size;
    t.head[k] = 0;
    const long long chunks =
        path == 0 ? (size + kChunk - 1) / kChunk
                  : mt::stream_chunks(size, heads[k], width, kVecChunk,
                                      {{t.x[k], x_dtype},
                                       {t.y[k], y_dtype},
                                       {t.out[k], out_dtype}},
                                      &t.head[k]);
    if (chunks < 0) return -1;
    t.first_chunk[k + 1] = t.first_chunk[k] + chunks;
  }
  if (t.first_chunk[n] == 0) return 0;
  const Launch l{t, scale, a, b, flag, fault, path,
                 static_cast<cudaStream_t>(stream)};
  if (mode == 0) return by_x<false>(x_dtype, mt::kFloat32, out_dtype, l);
  return by_x<true>(x_dtype, y_dtype, out_dtype, l);
}
