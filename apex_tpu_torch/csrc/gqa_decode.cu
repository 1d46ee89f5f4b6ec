// One-token GQA decode attention over the KV cache for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces apex_tpu/contrib/gqa_decode.py `_decode_kernel` (launched by
// `_decode_pallas` under `gqa_flash_decode`): q [b, g, rep, d] for the
// token at position length - 1 against the cache k/v [T, b, g, d], each
// batch row with its own live length (lengths [b] int32 on the device, as
// the JAX kernel runs once per serving slot under vmap); keys t < length
// are live (and, with a window, t >= length - window);
// optional tanh softcap; fp32 output [b, g, rep, d].
//
// Bound on the H100: bytes. The live K/V rows are 2 * length * b*g*d * 2
// bytes per layer: 1.2 MB at length 144 for TinyLlama's b*g*d = 2048
// (0.381 us at 3.35 TB/s with the queries and output), 16.8 MB at a full
// 2048-row slot (5.0 us).
//
// Design (kv_attention.cuh, flash-decoding): the rep query rows of a
// (b, g) cell (8 for TinyLlama, one window position) pad one 16-row mma
// tile, and the cell's live key range [max(length - window, 0), length)
// is cut into splits of whole 16-key steps, read from `lengths` on the
// device: the grid has S = 16 splits a cell at b*g = 32 cells on 132 SMs
// (from the shapes and the SM count), and a range uses one split for
// every 8 steps, up to S (1 at length 144, 16 at 2048). Within a block
// the 4 warps take one 16-key step each of every 64-key stage (K/V by
// cp.async, double-buffered), scores and P.V on the tensor cores
// (mma.m16n8k16; P as three bf16 terms, exact in fp32), each warp with its
// own online softmax; the warps merge in shared memory, the splits
// through fp32 scratch and a per-cell counter: the last split block to
// arrive merges the partials in index order, in the same launch.
//
// First design (flash_rows.cuh, which #22 keeps for fp32 queries and
// blocks that split a cell): one block per cell walking its tiles in
// sequence on 32 of the 132 SMs, fp32 FMAs with K/V widened in shared
// memory, two of its four warps idle at rep 8: 27.66 us at length 144
// (PERF.md section 6).
// Known limit: at length 144 the kernel moves 1.2 MB, so its time is the
// launch, one stage's load latency and the merge's round trip through L2,
// not bytes. The engine's int8 store still goes through #15's dequantize
// before this kernel, as the JAX engine's does (the body reads the int8
// store itself only in #22, through its Int8KV source).

#include "kv_attention.cuh"

extern "C" int apex_gqa_decode(const void* q, const void* k, const void* v,
                               float* out, int b, int g, int rep, int d,
                               int cache_len, const int* lengths, int window,
                               float sm_scale, float softcap, int dtype,
                               int splits, float* scratch, int* counters,
                               void* stream) {
  apex_kv::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.n_rows = rep;
  a.rep = rep;
  a.groups = g;
  a.pos_stride = static_cast<long long>(b) * g * rep * d;
  a.kv_stride = static_cast<long long>(b) * g * d;
  a.starts = lengths;
  a.start_bias = -1;  // the token sits at position length - 1
  a.cache_len = cache_len;
  a.window = window;
  a.sm_scale = sm_scale;
  a.softcap = softcap;
  a.splits = splits;
  a.scratch = scratch;
  a.counters = counters;
  return apex_kv::dispatch(a, b * g, d, dtype,
                           static_cast<cudaStream_t>(stream));
}
