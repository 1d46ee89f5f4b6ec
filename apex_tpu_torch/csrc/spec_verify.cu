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
// Two bodies; apex_spec_verify's path (kernels/fused_cc.py `verify_plan`
// picks it) chooses:
//  * path 1, the split tensor-core body of #21 and #25
//    (kv_attention.cuh) with its int8 source, Int8KV: the grid (b*g
//    cells, row tiles of 16, S splits of the live key range), the split
//    rule and the in-launch merge are #21's; a stage lands the cell's d
//    code bytes of 64 key rows by 16-byte cp.async and the rows' fp32
//    scales by 4-byte ones. Codes are exact in bf16, so the m16n8k16
//    fragments are built from the int8 words in registers (four codes
//    widened by two byte permutes, four fp32 subtractions and two packs)
//    and no dequantized value is ever rounded; the scales fold in fp32:
//    the scores are (q . c) * ks * sm_scale, and P.V takes p * vs split
//    into #21's three bf16 terms times the codes, the denominator staying
//    the sum of p. It takes bf16 q at d 64 or 128 where a cell's lanes lie
//    in one block (B % d == 0) and the codes on 16-byte boundaries (the
//    serving store: B = 256). Paths 2 and 3 are planted faults (the last
//    live split left out of the merge; each score on its neighbour key
//    row's scale).
//  * path 0, the first design (flash_rows.cuh: a grid of (b*g cells, row
//    tiles of 16), each block walking its cell's live keys alone in fp32
//    on the CUDA cores), each tile's codes widened and multiplied by
//    their block's scale on the way into shared memory. It takes fp32 q
//    and a cell's lanes across a block boundary.
// Either way the dequantized cache never exists in device memory, as the
// TPU kernel widens the codes in VMEM (the alternative the JAX engine
// takes is to dequantize every slot row with #15 first).

#include "flash_rows.cuh"
#include "kv_attention.cuh"

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
// path 0: the first design (splits, scratch and counters unused); path 1:
// the split body (bf16 q, B % d == 0, aligned codes; splits 1 ..
// kMaxSplits, above 1 with scratch and counters), 2 and 3 its planted
// faults. Returns the launch's cudaError_t, or -1 for arguments the path
// has no instance for.
extern "C" int apex_spec_verify(const void* q, const int8_t* kq,
                                const float* ks, const int8_t* vq,
                                const float* vs, float* out, int w, int b,
                                int g, int rep, int d, int cache_len, int nb,
                                int block, const int* starts, float sm_scale,
                                int dtype, int splits, float* scratch,
                                int* counters, int path, void* stream) {
  if (path < 0 || path > 3) return -1;
  if (path != 0) {
    if (dtype != 1) return -1;
    apex_kv::Args k;
    k.q = q;
    k.k = kq;
    k.v = vq;
    k.out = out;
    k.n_rows = w * rep;
    k.rep = rep;
    k.groups = g;
    k.pos_stride = static_cast<long long>(b) * g * rep * d;
    k.kv_stride = static_cast<long long>(b) * nb * block;
    k.starts = starts;
    k.start_bias = 0;
    k.cache_len = cache_len;
    k.window = 0;
    k.sm_scale = sm_scale;
    k.softcap = 0.f;
    k.splits = splits;
    k.scratch = scratch;
    k.counters = counters;
    k.ks = ks;
    k.vs = vs;
    k.scale_stride = static_cast<long long>(b) * nb;
    k.nb = nb;
    k.block = block;
    return apex_kv::dispatch_int8(k, b * g, d, path,
                                  static_cast<cudaStream_t>(stream));
  }
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
