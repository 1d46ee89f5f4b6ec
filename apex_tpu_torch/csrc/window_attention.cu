// Prefill-window attention over the KV cache for Hopper (sm_90a), bound
// to Python with ctypes.
//
// Replaces apex_tpu/kernels/fused_cc.py `_window_kernel` (launched by
// `_window_pallas` under `window_attention`): flash attention of a
// w-position chunk of queries, qg [w, b, g, rep, d], against the cache
// buffers k/v [T, b, g, d] whose rows [start, start + w) the chunk has
// just written, each batch row at its own start (starts [b] int32 on the
// device: the serving engine's slots sit at different fill levels);
// query row (i, j) at position start + i sees keys t <= start + i (and,
// with a window, start + i - t < window); optional tanh softcap; fp32
// output [w, b, g, rep, d].
//
// Bound on the H100: bytes. At `generate`'s prefill (qg [128, 8, 4, 8,
// 64] bf16, start 0) the work is 0.54 GFLOP on the tensor cores (0.55 us
// at 989 TFLOP/s) against 13.6 MB: the queries (4.2 MB), the live K/V
// rows (1.0 MB) and, above all, the fp32 output (8.4 MB): 4.07 us at
// 3.35 TB/s.
//
// Design (kv_attention.cuh): the TPU kernel holds all w*rep query rows
// of a (b, g) cell in VMEM and streams the cache tiles through them.
// Here a block takes 16 rows of a cell (2 window positions at rep 8, one
// mma tile) and its 4 warps split the keys; the grid is (b*g cells, row
// tiles, S splits of the live key range), S from the shapes and the SM
// count (1 at the prefill's 2048 blocks, 6 at a speculative verify's
// 96), each range using as many of them as its length warrants (one for
// every 8 steps of 16 keys). Scores and P.V run on the tensor cores
// (mma.m16n8k16, bf16 in, fp32 accumulate; P as three bf16 terms, exact
// in fp32), K/V arrive in shared memory by cp.async, double-buffered;
// the splits merge in the same launch. Any T works: the key loop
// zero-fills the ragged last step instead of needing a tile that divides
// T, so the JAX package's einsum fallback for such T has no counterpart
// here.
//
// First design (flash_rows.cuh, which #22 keeps for fp32 queries and
// blocks that split a cell): a grid of (b*g cells, row tiles of 16), each
// block walking its cell's K/V prefix in fp32 on the CUDA cores, every
// K/V element widened from a 2-byte scalar load: 74.71 us at the prefill
// shape (PERF.md section 6).
// Known limit: the output is fp32 in the JAX layout (8.4 MB of the 13.6 MB
// at the prefill), and each of a cell's 64 row tiles reads the cell's K/V
// prefix up to its own rows again (from L2 after the first).

#include "kv_attention.cuh"

extern "C" int apex_window_attention(const void* q, const void* k,
                                     const void* v, float* out, int w, int b,
                                     int g, int rep, int d, int cache_len,
                                     const int* starts, int window,
                                     float sm_scale, float softcap, int dtype,
                                     int splits, float* scratch, int* counters,
                                     void* stream) {
  apex_kv::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.n_rows = w * rep;
  a.rep = rep;
  a.groups = g;
  a.pos_stride = static_cast<long long>(b) * g * rep * d;
  a.kv_stride = static_cast<long long>(b) * g * d;
  a.starts = starts;
  a.start_bias = 0;
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
