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
// Design: adam.cu's first multi_tensor_apply. One launch covers up to
// kMaxTensors = 64 tensors from a table of their pointers and sizes
// passed by value as the kernel's parameter (2.6 KB); each tensor is cut
// into chunks of 65,536 elements that blocks walk grid-stride, threads
// on neighbouring elements (coalesced). A block ORs its threads' flags
// (__syncthreads_or) and one thread writes the flag. Products and sums
// are written with round-to-nearest intrinsics, so nvcc contracts
// nothing into an FMA: the kernel gives the oracle's values bit for bit.

#include "multi_tensor.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;
constexpr long long kChunk = 65536;
constexpr int kMaxBlocks = 132 * 8;

// planted faults (fault codes 1 and 2; no caller passes them): the flag
// never written; each tensor's last element left as it was
constexpr int kFlagUnset = 1;
constexpr int kLastSkipped = 2;

struct Table {
  const void* x[kMaxTensors];
  const void* y[kMaxTensors];  // axpby only
  void* out[kMaxTensors];
  long long size[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];  // prefix count of chunks
  int n;
};

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

template <typename TX, typename TY, typename TO, bool kAxpby>
int launch(const Table& t, const float* scale, float a, float b, float* flag,
           int fault, cudaStream_t stream) {
  const long long chunks = t.first_chunk[t.n];
  const int blocks = static_cast<int>(chunks < kMaxBlocks ? chunks : kMaxBlocks);
  scale_kernel<TX, TY, TO, kAxpby><<<blocks, kThreads, 0, stream>>>(
      t, scale, a, b, flag, fault);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY, bool kAxpby>
int by_out(int out_dtype, const Table& t, const float* scale, float a,
           float b, float* flag, int fault, cudaStream_t s) {
  if (out_dtype == mt::kFloat32)
    return launch<TX, TY, float, kAxpby>(t, scale, a, b, flag, fault, s);
  if (out_dtype == mt::kBFloat16)
    return launch<TX, TY, __nv_bfloat16, kAxpby>(t, scale, a, b, flag, fault, s);
  return -1;
}

template <typename TX, bool kAxpby>
int by_y(int y_dtype, int out_dtype, const Table& t, const float* scale,
         float a, float b, float* flag, int fault, cudaStream_t s) {
  if (y_dtype == mt::kFloat32)
    return by_out<TX, float, kAxpby>(out_dtype, t, scale, a, b, flag, fault, s);
  if (y_dtype == mt::kBFloat16)
    return by_out<TX, __nv_bfloat16, kAxpby>(out_dtype, t, scale, a, b, flag,
                                             fault, s);
  return -1;
}

template <bool kAxpby>
int by_x(int x_dtype, int y_dtype, int out_dtype, const Table& t,
         const float* scale, float a, float b, float* flag, int fault,
         cudaStream_t s) {
  if (x_dtype == mt::kFloat32)
    return by_y<float, kAxpby>(y_dtype, out_dtype, t, scale, a, b, flag,
                               fault, s);
  if (x_dtype == mt::kBFloat16)
    return by_y<__nv_bfloat16, kAxpby>(y_dtype, out_dtype, t, scale, a, b,
                                       flag, fault, s);
  return -1;
}

}  // namespace

// mode 0: out[k] = x[k] * (*scale); mode 1: out[k] = a * x[k] + b * y[k]
// (y ignored, may be null, in mode 0), over the n (1..64) tensors of
// sizes[k] elements, each list of one dtype (0 fp32, 1 bf16; y_dtype 0 in
// mode 0). *flag is set to 1 where a result is not finite. fault: 0, or
// a planted fault (1 the flag never written, 2 each tensor's last
// element skipped). Returns the CUDA error of the launch (0 on success);
// -1 for a count, size, dtype, mode or fault the kernel does not take.
extern "C" int apex_multi_tensor_scale(void* const* x, void* const* y,
                                       void* const* out,
                                       const long long* sizes, int n,
                                       int x_dtype, int y_dtype,
                                       int out_dtype, int mode,
                                       const float* scale, float a, float b,
                                       float* flag, int fault, void* stream) {
  if (n < 1 || n > kMaxTensors || mode < 0 || mode > 1 || fault < 0 ||
      fault > 2 || flag == nullptr || (mode == 0 && scale == nullptr))
    return -1;
  Table t;
  t.n = n;
  t.first_chunk[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] < 0) return -1;
    t.x[k] = x[k];
    t.y[k] = mode == 1 ? y[k] : nullptr;
    t.out[k] = out[k];
    t.size[k] = sizes[k];
    t.first_chunk[k + 1] = t.first_chunk[k] + (sizes[k] + kChunk - 1) / kChunk;
  }
  if (t.first_chunk[n] == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return by_x<false>(x_dtype, mt::kFloat32, out_dtype, t, scale, 0.f, 0.f,
                       flag, fault, s);
  return by_x<true>(x_dtype, y_dtype, out_dtype, t, scale, a, b, flag, fault,
                    s);
}
