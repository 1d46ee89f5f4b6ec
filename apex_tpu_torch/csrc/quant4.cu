// int4 dual quantization for Hopper (sm_90a), bound to Python with ctypes:
// quantize, dequantize, split-half nibble pack and unpack, and the fused
// quantize+pack and unpack+dequantize of the int4 gather.
//
// Replaces apex_tpu/kernels/quant4.py `_quant_kernel` (#16),
// `_dequant_kernel` (#17), `_pack_kernel` (#18) and `_unpack_kernel` (#19),
// launched by `quantize_int4`, `dequantize_int4`, `pack_int4` and
// `unpack_int4`, and apex_tpu/kernels/fused_cc.py `_qp_kernel` (#23) and
// `_ud_kernel` (#24), launched by `quantize_pack_int4` and
// `unpack_dequantize_int4`, on [nb, B] rows of one block each:
//   quantize:   q = clip(rint(x / s), -7, 7) as int8, s the row's
//               effective scale (fp32 [nb]);
//   dequantize: out = float(q) * s;
//   pack:       p[r, j] = (q[r, j] & 0xF) | (q[r, j + H] & 0xF) << 4 for
//               j < H = ceil(B / 2); the lane j + H = B of an odd row is a
//               zero pad lane;
//   unpack:     out[r, j] = ((p[r, j] & 0xF) ^ 8) - 8 and
//               out[r, j + H] = (((p[r, j] >> 4) & 0xF) ^ 8) - 8, written
//               for the lanes below n (n <= 2H drops an odd row's pad);
//   quantize+pack:     pack(quantize(x)), the pad lane of an odd row a
//                      zero value quantized; the codes stay in registers;
//   unpack+dequantize: dequantize(unpack(p)) for the lanes below n.
//
// Exactness: bit-identical to the plain versions and to the JAX oracle:
// the division is IEEE (__fdiv_rn; the library is never built with
// --use_fast_math), rintf rounds half to even as jnp.round and
// torch.round do, the product is __fmul_rn, and int8 -> float is exact.
// A NaN value or scale gives an unspecified code (here -7; the casts of
// NaN differ by library), but its dequantized value is NaN in every
// version.
//
// Bound on the H100: memory; nothing here computes much. Quantize reads 4
// bytes a lane plus 4 a row and writes 1; dequantize reads 1 plus 4 a row
// and writes 4; pack reads 1 and writes 0.5; unpack the reverse. At a
// 51.5 M-lane GPT-2 bucket ([201216, 256]) quantize moves 258 MB, 77 us
// at 3.35 TB/s, and pack 77 MB, 23 us. The fused pair moves 4.5 bytes a
// lane plus 4 a row: 1.84 GB at the flat GPT-2 gather ([1587432, 256]),
// 548 us.
//
// Design: one warp a row (a block of B lanes), eight warps a CUDA block,
// so the row's scale is read once and no thread divides a flat index by
// B. Rows whose width and addresses allow it move four lanes a thread
// (16-byte fp32 loads and stores, 4-byte int8 ones); other rows go lane by
// lane. Offsets are 64-bit: the flat GPT-2 gather is 406 M lanes. A
// simple first version: rows of 256 lanes leave each lane two vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ int8_t code4(float x, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -7.f), 7.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ float value4(int8_t q, float s) {
  return __fmul_rn(static_cast<float>(q), s);
}

__device__ __forceinline__ uint8_t nibbles(int8_t lo, int8_t hi) {
  return static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4));
}

__device__ __forceinline__ int8_t low4(uint8_t p) {
  return static_cast<int8_t>(((p & 0xF) ^ 8) - 8);
}

__device__ __forceinline__ int8_t high4(uint8_t p) {
  return static_cast<int8_t>((((p >> 4) & 0xF) ^ 8) - 8);
}

__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quant4_kernel(const float* __restrict__ x, const float* __restrict__ s,
              int8_t* __restrict__ q, long long nb, int B) {
  const long long row = warp_row();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float sc = s[row];
  const long long base = row * B;
  if (kVec) {
    const float4* xv = reinterpret_cast<const float4*>(x + base);
    char4* qv = reinterpret_cast<char4*>(q + base);
    for (int j = lane; j < B / 4; j += 32) {
      const float4 v = xv[j];
      qv[j] = make_char4(code4(v.x, sc), code4(v.y, sc), code4(v.z, sc),
                         code4(v.w, sc));
    }
  } else {
    for (int j = lane; j < B; j += 32) q[base + j] = code4(x[base + j], sc);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant4_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ out, long long nb, int B) {
  const long long row = warp_row();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float sc = s[row];
  const long long base = row * B;
  if (kVec) {
    const char4* qv = reinterpret_cast<const char4*>(q + base);
    float4* ov = reinterpret_cast<float4*>(out + base);
    for (int j = lane; j < B / 4; j += 32) {
      const char4 c = qv[j];
      ov[j] = make_float4(value4(c.x, sc), value4(c.y, sc), value4(c.z, sc),
                          value4(c.w, sc));
    }
  } else {
    for (int j = lane; j < B; j += 32) out[base + j] = value4(q[base + j], sc);
  }
}

// kVec: B % 8 == 0, so both halves and the output row are 4-aligned
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack4_kernel(const int8_t* __restrict__ q, uint8_t* __restrict__ p,
             long long nb, int B, int H) {
  const long long row = warp_row();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const int8_t* qr = q + row * B;
  uint8_t* pr = p + row * H;
  if (kVec) {
    const char4* lo = reinterpret_cast<const char4*>(qr);
    const char4* hi = reinterpret_cast<const char4*>(qr + H);
    uchar4* pv = reinterpret_cast<uchar4*>(pr);
    for (int j = lane; j < H / 4; j += 32) {
      const char4 a = lo[j], b = hi[j];
      pv[j] = make_uchar4(nibbles(a.x, b.x), nibbles(a.y, b.y),
                          nibbles(a.z, b.z), nibbles(a.w, b.w));
    }
  } else {
    for (int j = lane; j < H; j += 32)
      pr[j] = nibbles(qr[j], j + H < B ? qr[j + H] : int8_t(0));
  }
}

// kVec: H % 4 == 0 and n == 2H
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
unpack4_kernel(const uint8_t* __restrict__ p, int8_t* __restrict__ out,
               long long nb, int H, int n) {
  const long long row = warp_row();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* pr = p + row * H;
  int8_t* orow = out + row * n;
  if (kVec) {
    const uchar4* pv = reinterpret_cast<const uchar4*>(pr);
    char4* lo = reinterpret_cast<char4*>(orow);
    char4* hi = reinterpret_cast<char4*>(orow + H);
    for (int j = lane; j < H / 4; j += 32) {
      const uchar4 v = pv[j];
      lo[j] = make_char4(low4(v.x), low4(v.y), low4(v.z), low4(v.w));
      hi[j] = make_char4(high4(v.x), high4(v.y), high4(v.z), high4(v.w));
    }
  } else {
    for (int j = lane; j < H; j += 32) {
      const uint8_t v = pr[j];
      if (j < n) orow[j] = low4(v);
      if (j + H < n) orow[j + H] = high4(v);
    }
  }
}

// kVec: B % 8 == 0, so both fp32 halves are 16-byte and the output row
// 4-byte aligned
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quant_pack4_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   uint8_t* __restrict__ p, long long nb, int B, int H) {
  const long long row = warp_row();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float sc = s[row];
  const float* xr = x + row * B;
  uint8_t* pr = p + row * H;
  if (kVec) {
    const float4* lo = reinterpret_cast<const float4*>(xr);
    const float4* hi = reinterpret_cast<const float4*>(xr + H);
    uchar4* pv = reinterpret_cast<uchar4*>(pr);
    for (int j = lane; j < H / 4; j += 32) {
      const float4 a = lo[j], b = hi[j];
      pv[j] = make_uchar4(nibbles(code4(a.x, sc), code4(b.x, sc)),
                          nibbles(code4(a.y, sc), code4(b.y, sc)),
                          nibbles(code4(a.z, sc), code4(b.z, sc)),
                          nibbles(code4(a.w, sc), code4(b.w, sc)));
    }
  } else {
    for (int j = lane; j < H; j += 32)
      pr[j] = nibbles(code4(xr[j], sc),
                      code4(j + H < B ? xr[j + H] : 0.f, sc));
  }
}

// kVec: H % 4 == 0 and n == 2H
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
unpack_dequant4_kernel(const uint8_t* __restrict__ p,
                       const float* __restrict__ s, float* __restrict__ out,
                       long long nb, int H, int n) {
  const long long row = warp_row();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float sc = s[row];
  const uint8_t* pr = p + row * H;
  float* orow = out + row * n;
  if (kVec) {
    const uchar4* pv = reinterpret_cast<const uchar4*>(pr);
    float4* lo = reinterpret_cast<float4*>(orow);
    float4* hi = reinterpret_cast<float4*>(orow + H);
    for (int j = lane; j < H / 4; j += 32) {
      const uchar4 v = pv[j];
      lo[j] = make_float4(value4(low4(v.x), sc), value4(low4(v.y), sc),
                          value4(low4(v.z), sc), value4(low4(v.w), sc));
      hi[j] = make_float4(value4(high4(v.x), sc), value4(high4(v.y), sc),
                          value4(high4(v.z), sc), value4(high4(v.w), sc));
    }
  } else {
    for (int j = lane; j < H; j += 32) {
      const uint8_t v = pr[j];
      if (j < n) orow[j] = value4(low4(v), sc);
      if (j + H < n) orow[j + H] = value4(high4(v), sc);
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

unsigned grid(long long nb) {
  return static_cast<unsigned>((nb + kWarps - 1) / kWarps);
}

}  // namespace

// Each returns a CUDA error code (0: launched). Rows nb, widths B (codes),
// H (packed bytes) and n (unpacked lanes) are counted in elements.
extern "C" int apex_quant4(const float* x, const float* s, int8_t* q,
                           long long nb, int B, void* stream) {
  if (nb <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B % 4 == 0 && aligned(x, 16) && aligned(q, 4))
    quant4_kernel<true><<<grid(nb), kThreads, 0, st>>>(x, s, q, nb, B);
  else
    quant4_kernel<false><<<grid(nb), kThreads, 0, st>>>(x, s, q, nb, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_dequant4(const int8_t* q, const float* s, float* out,
                             long long nb, int B, void* stream) {
  if (nb <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B % 4 == 0 && aligned(q, 4) && aligned(out, 16))
    dequant4_kernel<true><<<grid(nb), kThreads, 0, st>>>(q, s, out, nb, B);
  else
    dequant4_kernel<false><<<grid(nb), kThreads, 0, st>>>(q, s, out, nb, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_pack4(const int8_t* q, uint8_t* p, long long nb, int B,
                          int H, void* stream) {
  if (nb <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B % 8 == 0 && aligned(q, 4) && aligned(p, 4))
    pack4_kernel<true><<<grid(nb), kThreads, 0, st>>>(q, p, nb, B, H);
  else
    pack4_kernel<false><<<grid(nb), kThreads, 0, st>>>(q, p, nb, B, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_unpack4(const uint8_t* p, int8_t* out, long long nb,
                            int H, int n, void* stream) {
  if (nb <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 4 == 0 && n == 2 * H && aligned(p, 4) && aligned(out, 4))
    unpack4_kernel<true><<<grid(nb), kThreads, 0, st>>>(p, out, nb, H, n);
  else
    unpack4_kernel<false><<<grid(nb), kThreads, 0, st>>>(p, out, nb, H, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_quant_pack4(const float* x, const float* s, uint8_t* p,
                                long long nb, int B, int H, void* stream) {
  if (nb <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B % 8 == 0 && aligned(x, 16) && aligned(p, 4))
    quant_pack4_kernel<true><<<grid(nb), kThreads, 0, st>>>(x, s, p, nb, B,
                                                            H);
  else
    quant_pack4_kernel<false><<<grid(nb), kThreads, 0, st>>>(x, s, p, nb, B,
                                                             H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_unpack_dequant4(const uint8_t* p, const float* s,
                                    float* out, long long nb, int H, int n,
                                    void* stream) {
  if (nb <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 4 == 0 && n == 2 * H && aligned(p, 4) && aligned(out, 16))
    unpack_dequant4_kernel<true><<<grid(nb), kThreads, 0, st>>>(p, s, out,
                                                                nb, H, n);
  else
    unpack_dequant4_kernel<false><<<grid(nb), kThreads, 0, st>>>(p, s, out,
                                                                 nb, H, n);
  return static_cast<int>(cudaGetLastError());
}
