// Shared pieces of the multi-tensor kernels that amp's step runs
// (multi_tensor_scale.cu, sgd.cu, the device-step paths of adam.cu and
// lamb.cu): fp32 / bf16 element access, the streaming bodies' loads and
// stores and their host side (the heads checked, the chunks counted, the
// resident grid), and the bias corrections read from a device step
// count.
//
// Nothing here holds state (no static locals: each .cu is its own
// ctypes library, and a header's static would be one object per
// library; each .cu keeps its own cache of resident blocks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace mt {

using bf16 = __nv_bfloat16;

// the dtype codes of the C interfaces (kernels/_checks.py DTYPE_CODES);
// kNone marks an absent output list
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kNone = -1;

// the element type of an absent output list
struct None {};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stores v into out[i] in out's dtype; nothing for an absent list.
template <typename TO>
__device__ __forceinline__ void store(void* out, long long i, float v) {
  if constexpr (!std::is_same_v<TO, None>) static_cast<TO*>(out)[i] = from_float<TO>(v);
}

// Streaming loads and stores (ld/st.global.cs: each byte is touched
// once) of one element, of 4-element vectors (16 bytes of fp32, 8 of
// bf16) and of 8-element bf16 vectors (16 bytes), widened to or rounded
// from fp32; an absent output list stores nothing. Index i counts
// elements for ld1/st1 and vectors for the others.
__device__ __forceinline__ float ld1(const float* a, long long i) {
  return __ldcs(a + i);
}
__device__ __forceinline__ float ld1(const bf16* a, long long i) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(a) + i)));
}
__device__ __forceinline__ void st1(float* a, long long i, float x) {
  __stcs(a + i, x);
}
__device__ __forceinline__ void st1(bf16* a, long long i, float x) {
  __stcs(reinterpret_cast<unsigned short*>(a) + i,
         __bfloat16_as_ushort(__float2bfloat16_rn(x)));
}
__device__ __forceinline__ void st1(None*, long long, float) {}

__device__ __forceinline__ float4 ld4(const float* a, long long i) {
  return __ldcs(reinterpret_cast<const float4*>(a) + i);
}
__device__ __forceinline__ float4 ld4(const bf16* a, long long i) {
  const uint2 r = __ldcs(reinterpret_cast<const uint2*>(a) + i);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void st4(float* a, long long i, const float4& x) {
  __stcs(reinterpret_cast<float4*>(a) + i, x);
}
__device__ __forceinline__ void st4(bf16* a, long long i, const float4& x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 r;
  r.x = *reinterpret_cast<const unsigned*>(&lo);
  r.y = *reinterpret_cast<const unsigned*>(&hi);
  __stcs(reinterpret_cast<uint2*>(a) + i, r);
}
__device__ __forceinline__ void st4(None*, long long, const float4&) {}

__device__ __forceinline__ void ld8(const bf16* a, long long i, float (&x)[8]) {
  const uint4 r = __ldcs(reinterpret_cast<const uint4*>(a) + i);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void st8(bf16* a, long long i, const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(a) + i, make_uint4(w[0], w[1], w[2], w[3]));
}

// The host side of the streaming bodies (adam.cu, multi_tensor_scale.cu,
// sgd.cu). Their walk over the table stays in each body: moved into a
// shared device helper, it made the fp32 scale body 2 % slower on an
// H100.

inline int itemsize(int dtype) { return dtype == kBFloat16 ? 2 : 4; }

// One list of a launch for the alignment check: the tensor's data and
// its dtype code (null data: an absent list, not checked).
struct List {
  const void* data;
  int dtype;
};

// The host side of one tensor's table entry for a streaming body in
// vectors of `width` elements, a chunk being `vec_chunk` vectors and
// width * vec_chunk scalar elements: the tensor's chunks, with its head
// stored in *table_head (-1 where it is all head); -1 for a head the
// plan (kernels/optim.py `adam_plan`) cannot give: below `width` with
// every list + head on a vector boundary where the tensor has a vector,
// or `size` (no vector span).
inline long long stream_chunks(long long size, long long head, int width,
                               long long vec_chunk,
                               std::initializer_list<List> lists,
                               int* table_head) {
  if (head < 0 || head > size || (head >= width && head != size)) return -1;
  const long long vecs = (size - head) / width;
  if (vecs > 0)
    for (const List& l : lists) {
      const int item = itemsize(l.dtype);
      if (l.data != nullptr &&
          (reinterpret_cast<uintptr_t>(l.data) + head * item) % (width * item))
        return -1;
    }
  const long long scalars = size - width * vecs;
  const long long by_vecs = (vecs + vec_chunk - 1) / vec_chunk;
  const long long by_scalars =
      (scalars + width * vec_chunk - 1) / (width * vec_chunk);
  *table_head = head >= width ? -1 : static_cast<int>(head);
  return by_vecs > by_scalars ? by_vecs : by_scalars;
}

constexpr int kMaxDevices = 64;

// Blocks of `kernel` (`threads` a block, no dynamic shared memory) that
// the current device holds resident at once: occupancy times SMs, read
// once a device into cached[device], the caller's cache (one for each
// kernel instance, kept in that kernel's .cu); -1 on an error.
inline int resident_blocks(const void* kernel, int threads,
                           int (&cached)[kMaxDevices]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0) !=
            cudaSuccess ||
        sms * per_sm < 1)
      return -1;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

// 1 - beta^step as the host's ops/multi_tensor.py `bias_corrections`
// gives it for an fp32 beta: the double power rounded once to fp32, then
// subtracted from 1 in fp32 (the value of XLA's fp32 power in JAX's
// jitted step).
__device__ __forceinline__ float bias_correction(float beta, int step) {
  const float power = __double2float_rn(pow(static_cast<double>(beta),
                                            static_cast<double>(step)));
  return __fsub_rn(1.f, power);
}

// Whether an overflow flag (a device fp32 scalar, or null: none) says
// skip: JAX's `noop > 0`.
__device__ __forceinline__ bool raised(const float* flag) {
  return flag != nullptr && *flag > 0.f;
}

}  // namespace mt
