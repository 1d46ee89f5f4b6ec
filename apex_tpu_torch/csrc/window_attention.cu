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
// Bound on the H100: at the path's shapes (a 128-token prompt at rep 8,
// d 64) the arithmetic is ~1 GFLOP per layer and the bytes are the
// queries, the live K/V rows and the fp32 output, a few MB: both bounds
// are microseconds, so the launch and the per-block tile loop dominate.
//
// Design: the TPU kernel holds all w*rep query rows of a (b, g) cell in
// VMEM (1024 x 64 fp32 accumulators for this prompt) and streams the
// cache tiles through them. That is too much state for one CUDA block,
// so the grid is (b*g cells, query-row tiles of 16): each block keeps 16
// rows (two window positions at rep 8) and loops over the cache tiles up
// to its own last live position only, with the online softmax in fp32
// (flash_rows.cuh). Any T works: the key loop masks the ragged last tile
// instead of needing a tile that divides T, so the JAX package's
// einsum fallback for such T has no counterpart here.

#include "flash_rows.cuh"

extern "C" int apex_window_attention(const void* q, const void* k,
                                     const void* v, float* out, int w, int b,
                                     int g, int rep, int d, int cache_len,
                                     const int* starts, int window,
                                     float sm_scale, float softcap, int dtype,
                                     void* stream) {
  apex_flash::CellArgs a;
  a.n_rows = w * rep;
  a.rep = rep;
  a.groups = g;
  a.pos_stride = static_cast<long long>(b) * g * rep * d;
  a.starts = starts;
  a.start_bias = 0;
  a.cache_len = cache_len;
  a.window = window;
  a.sm_scale = sm_scale;
  a.softcap = softcap;
  return apex_flash::dispatch_attend(q, k, v, out, b * g, d, dtype, a,
                                     static_cast<cudaStream_t>(stream));
}
