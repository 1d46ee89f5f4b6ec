// Speculative-verify attention over the int8 KV cache for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/kernels/fused_cc.py `_verify_kernel` (launched by
// `spec_verify_attention`): flash attention of a w-position verify
// window, q [w, b, g, rep, d] at positions start .. start + w - 1 of each
// batch row (starts [b] int32 on the device; the JAX function takes one
// slot, [w, g, rep, d] and a scalar start, and runs under vmap for a
// batch), against the int8 blockwise serving store: codes kq, vq
// [T, b, nb, B] int8 and scales ks, vs [T, b, nb] fp32 (one per block of
// B lanes of a cache row's g * d lanes; trailing lanes past g * d are
// quantization padding and never read). Causal at each query's own
// position, no window, no softcap (the TPU kernel has neither); fp32
// output [w, b, g, rep, d].
//
// Bound on the H100: at the TinyLlama verify window (w 5, g 4, rep 8,
// d 64) over a 2048-row cache the work is the live rows' codes and
// scales, ~0.5 MB per slot, and ~10 MFLOP: both bounds are well under a
// microsecond, so the launch and the tile loop dominate.
//
// Design: the body the window kernel #21 had before its redesign
// (flash_rows.cuh: a grid of (b*g cells, row tiles of 16), the cache
// streamed through shared memory in tiles, online softmax in fp32) with
// the Int8KV loader: each tile's
// codes are widened and multiplied by their block's scale on the way
// into shared memory, as the TPU kernel widens them in VMEM, so the
// dequantized cache never exists in device memory (the alternative the
// JAX engine takes is to dequantize every slot row with #15 first).

#include "flash_rows.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(apex_flash::kThreads)
verify_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
              const float* __restrict__ ks, const int8_t* __restrict__ vq,
              const float* __restrict__ vs, float* __restrict__ out,
              apex_flash::CellArgs a, int b, int nb, int block) {
  const long long cell = blockIdx.x;
  const int bi = static_cast<int>(cell / a.groups);
  const int gi = static_cast<int>(cell % a.groups);
  const long long row_bytes = static_cast<long long>(nb) * block;
  const apex_flash::Int8KV kv{kq + bi * row_bytes, vq + bi * row_bytes,
                              ks + static_cast<long long>(bi) * nb,
                              vs + static_cast<long long>(bi) * nb,
                              b * row_bytes, static_cast<long long>(b) * nb,
                              gi * D, block};
  const long long q_off = cell * a.rep * D;
  apex_flash::attend_rows<T, D>(q + q_off, kv, out + q_off,
                                blockIdx.y * apex_flash::kRows,
                                a.starts[bi], a);
}

template <typename T, int D>
int launch(const void* q, const int8_t* kq, const float* ks, const int8_t* vq,
           const float* vs, float* out, int b, int nb, int block,
           const apex_flash::CellArgs& a, cudaStream_t stream) {
  const dim3 grid(b * a.groups, (a.n_rows + apex_flash::kRows - 1) / apex_flash::kRows);
  verify_kernel<T, D><<<grid, apex_flash::kThreads, 0, stream>>>(
      static_cast<const T*>(q), kq, ks, vq, vs, out, a, b, nb, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes (of q): 0 = float32, 1 = bfloat16; head dims 64 and 128.
extern "C" int apex_spec_verify(const void* q, const int8_t* kq,
                                const float* ks, const int8_t* vq,
                                const float* vs, float* out, int w, int b,
                                int g, int rep, int d, int cache_len, int nb,
                                int block, const int* starts, float sm_scale,
                                int dtype, void* stream) {
  apex_flash::CellArgs a;
  a.n_rows = w * rep;
  a.rep = rep;
  a.groups = g;
  a.pos_stride = static_cast<long long>(b) * g * rep * d;
  a.starts = starts;
  a.start_bias = 0;
  a.cache_len = cache_len;
  a.window = 0;
  a.sm_scale = sm_scale;
  a.softcap = 0.f;
  if (b <= 0 || g <= 0 || a.n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, kq, ks, vq, vs, out, b, nb, block, a, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, kq, ks, vq, vs, out, b, nb, block, a, s);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(q, kq, ks, vq, vs, out, b, nb, block, a, s);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(q, kq, ks, vq, vs, out, b, nb, block, a, s);
  return -1;
}
