// Row helpers of the register-path row kernels (layer_norm.cu #5,
// rms_norm.cu #7): a lane's chunks of a row held as loaded, stored and
// widened on use, the weight's chunks, and the warp's xor butterfly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage: each .cu is its own library.
namespace apex_rows {
namespace {

// N consecutive values of a row as loaded (read once, with streaming
// hints), widened to fp32 on each use: fp32 as floats, bf16 as pairs
// packed in 32-bit words (half the registers); N = 1, or 16-byte
// multiples. bf16 -> fp32 is exact: the 16 bits become the top half.
template <typename T, int N>
struct Chunk;

template <int N>
struct Chunk<float, N> {
  float v[N];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (N == 1) {
      v[0] = __ldcs(p);
    } else {
      static_assert(N % 4 == 0, "fp32: 1 or a multiple of 4 values");
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(p + i));
        v[i] = t.x;
        v[i + 1] = t.y;
        v[i + 2] = t.z;
        v[i + 3] = t.w;
      }
    }
  }
  __device__ __forceinline__ float operator[](int e) const { return v[e]; }
};

template <int N>
struct Chunk<__nv_bfloat16, N> {
  unsigned u[(N + 1) / 2];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    if constexpr (N == 1) {
      u[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
    } else {
      static_assert(N % 8 == 0, "bf16: 1 or a multiple of 8 values");
#pragma unroll
      for (int i = 0; i < N; i += 8) {
        const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p + i));
        u[i / 2] = t.x;
        u[i / 2 + 1] = t.y;
        u[i / 2 + 2] = t.z;
        u[i / 2 + 3] = t.w;
      }
    }
  }
  __device__ __forceinline__ float operator[](int e) const {
    return __uint_as_float(e % 2 == 0 ? u[e / 2] << 16
                                      : u[e / 2] & 0xffff0000u);
  }
};

template <int N>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (N == 1) {
    __stcs(p, v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 1) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(bf16_bits(v[0])));
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 t;
      t.x = bf16_bits(v[i]) | (bf16_bits(v[i + 1]) << 16);
      t.y = bf16_bits(v[i + 2]) | (bf16_bits(v[i + 3]) << 16);
      t.z = bf16_bits(v[i + 4]) | (bf16_bits(v[i + 5]) << 16);
      t.w = bf16_bits(v[i + 6]) | (bf16_bits(v[i + 7]) << 16);
      __stcs(reinterpret_cast<uint4*>(p + i), t);
    }
  }
}

// N weights at w + j (fp32, kept in cache): float4 loads when `whole`
// (w on a 16-byte boundary, N a multiple of 4), else one at a time.
template <int N>
__device__ __forceinline__ void load_weight(const float* w, int j, bool whole,
                                            float* v) {
  if constexpr (N % 4 == 0) {
    if (whole) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(w + j + i));
        v[i] = t.x;
        v[i + 1] = t.y;
        v[i + 2] = t.z;
        v[i + 3] = t.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __ldg(w + j + i);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
}  // namespace apex_rows
