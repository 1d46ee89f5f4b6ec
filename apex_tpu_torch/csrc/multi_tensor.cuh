// Shared pieces of the multi-tensor kernels that amp's step runs
// (multi_tensor_scale.cu, sgd.cu, the device-step paths of adam.cu and
// lamb.cu): fp32 / bf16 element access and the bias corrections read
// from a device step count.
//
// Nothing here holds state (no static locals: each .cu is its own
// ctypes library, and a header's static would be one object per
// library).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace mt {

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
