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
// Bound on the H100: memory. The live K/V rows are 2 * length * b*g*d * 2
// bytes per layer, ~1.3 MB at length 160 for TinyLlama's b*g*d = 2048,
// under half a microsecond at 3.35 TB/s. What this design takes instead
// is latency: each block walks its ~length/64 tiles one after another
// (load, sync, score, sync), so the time grows with the live length at
// a fixed, small number of blocks (tens of microseconds on an H100 at
// length ~150, against a launch of a few).
//
// Design: one block per (b, g) cell whose rep query rows (8 for
// TinyLlama, one window position) share every K/V tile the block
// streams through shared memory, so each live cache row of the group is
// read from device memory once per step (flash_rows.cuh, with w = 1 and
// start = length - 1). Tiles start at max(length - window, 0) and stop
// at length: each row's dead tiles are skipped at its own length.
// Known limit: b*g = 32 blocks fill a quarter of the 132 SMs; splitting
// the key range across blocks (flash-decoding) and merging the partial
// softmaxes is left for a later change.

#include "flash_rows.cuh"

extern "C" int apex_gqa_decode(const void* q, const void* k, const void* v,
                               float* out, int b, int g, int rep, int d,
                               int cache_len, const int* lengths, int window,
                               float sm_scale, float softcap, int dtype,
                               void* stream) {
  apex_flash::CellArgs a;
  a.n_rows = rep;
  a.rep = rep;
  a.groups = g;
  a.pos_stride = static_cast<long long>(b) * g * rep * d;
  a.starts = lengths;
  a.start_bias = -1;  // the token sits at position length - 1
  a.cache_len = cache_len;
  a.window = window;
  a.sm_scale = sm_scale;
  a.softcap = softcap;
  return apex_flash::dispatch_attend(q, k, v, out, b * g, d, dtype, a,
                                     static_cast<cudaStream_t>(stream));
}
