// Shared body of the two KV-cache attention kernels (window_attention.cu,
// gqa_decode.cu): flash attention of a few query rows of one
// (batch, kv-group) cell against that cell's slice of the cache.
//
// Layouts (all contiguous, the JAX package's):
//   q, out  [w, b, g, rep, d]   (decode: w = 1, i.e. [b, g, rep, d]); out fp32
//   k, v    [T, b, g, d]        the per-layer cache buffers
// A cell's query rows are numbered r = i * rep + j (window position i,
// head j of the group); row r sits at absolute position start + r / rep.
// Key t is visible to row r iff t <= pos(r) and, with a window,
// pos(r) - t < window. Masked scores are -1e30 (not -inf), as in the TPU
// kernels, and the softcap is cap * tanh(s / cap) after the scale.
//
// One block of kWarps warps takes kRows consecutive rows of a cell; each
// warp owns kRowsPerWarp of them. The block streams the cell's live key
// range [t_lo, t_hi] through shared memory in tiles of kTile keys, the K
// and V rows converted to fp32 once per tile and shared by every row of
// the block (all rep heads of a group read one copy of the group's K/V:
// the GQA saving of the TPU kernels). Per tile a lane scores kTile/32
// keys for each of its warp's rows, the warp keeps the online softmax
// (running max m, sum l) in fp32, and each lane accumulates d/32 output
// columns. Cache rows are loaded with consecutive threads on consecutive
// elements of a row, so a warp's load is one contiguous run of the
// 128-byte row even though rows of a cell lie b*g*d elements apart.
// Tiles past the last live position (and, with a window, before the
// first) are never read, so the work follows the live length, not T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace apex_flash {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct CellArgs {
  int n_rows;        // w * rep query rows in the cell
  int rep;           // query heads per kv group
  long long pos_stride;  // elements between window positions in q/out (b*g*rep*d)
  long long kv_stride;   // elements between cache rows (b*g*d)
  int start;         // absolute position of window position 0
  int cache_len;     // T
  int window;        // <= 0: no sliding window
  float sm_scale;
  float softcap;     // <= 0: no softcap
};

// kTile * (D + 1) floats of K and of V fit the 48 KB of static shared
// memory for D = 64 (kTile 64) and D = 128 (kTile 32).
template <int D>
struct Tile {
  static constexpr int kKeys = 4096 / D;
  static constexpr int kKeysPerLane = kKeys / 32;
  static constexpr int kColsPerLane = D / 32;
};

// Block body. q_cell/out_cell point at row 0 of the cell, k_cell/v_cell
// at cache row 0 of the cell; row0 is the block's first row.
template <typename T, int D>
__device__ __forceinline__ void attend_rows(const T* __restrict__ q_cell,
                                            const T* __restrict__ k_cell,
                                            const T* __restrict__ v_cell,
                                            float* __restrict__ out_cell,
                                            int row0, const CellArgs& a) {
  constexpr int kKeys = Tile<D>::kKeys;
  constexpr int kKPL = Tile<D>::kKeysPerLane;
  constexpr int kCPL = Tile<D>::kColsPerLane;
  __shared__ float q_s[kRows][D];
  __shared__ float k_s[kKeys][D + 1];
  __shared__ float v_s[kKeys][D + 1];
  __shared__ float p_s[kWarps][kRowsPerWarp][kKeys];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_end = min(row0 + kRows, a.n_rows);

  // live key range of the block's rows
  const int first_pos = a.start + row0 / a.rep;
  const int last_pos = a.start + (row_end - 1) / a.rep;
  const int t_hi = min(last_pos, a.cache_len - 1);
  const int t_lo = a.window > 0 ? max(first_pos - a.window + 1, 0) : 0;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < row_end) {
      const long long off = (row / a.rep) * a.pos_stride + (row % a.rep) * D + c;
      val = to_float(q_cell[off]) * a.sm_scale;
    }
    q_s[r][c] = val;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCPL];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
    qpos[rr] = a.start + (row0 + warp * kRowsPerWarp + rr) / a.rep;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) acc[rr][j] = 0.f;
  }

  for (int t0 = t_lo; t0 <= t_hi; t0 += kKeys) {
    __syncthreads();  // the previous tile (and q_s on entry) is complete
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int tt = idx / D, c = idx % D;
      const int t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t <= t_hi) {
        const long long off = t * a.kv_stride + c;
        kv = to_float(k_cell[off]);
        vv = to_float(v_cell[off]);
      }
      k_s[tt][c] = kv;
      v_s[tt][c] = vv;
    }
    __syncthreads();

    float s[kRowsPerWarp][kKPL];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int kk = 0; kk < kKPL; ++kk) s[rr][kk] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float kc[kKPL];
#pragma unroll
      for (int kk = 0; kk < kKPL; ++kk) kc[kk] = k_s[lane + 32 * kk][c];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float qc = q_s[warp * kRowsPerWarp + rr][c];
#pragma unroll
        for (int kk = 0; kk < kKPL; ++kk) s[rr][kk] = fmaf(qc, kc[kk], s[rr][kk]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      float tile_max = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kKPL; ++kk) {
        const int t = t0 + lane + 32 * kk;
        float x = s[rr][kk];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool masked = t > qpos[rr] || t > t_hi;
        if (a.window > 0) masked = masked || (qpos[rr] - t >= a.window);
        x = masked ? kNegInf : x;
        s[rr][kk] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[rr], warp_max(tile_max));
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKPL; ++kk) {
        const float p = expf(s[rr][kk] - m_new);
        p_s[warp][rr][lane + 32 * kk] = p;
        psum += p;
      }
      l[rr] = alpha * l[rr] + warp_sum(psum);
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < kCPL; ++j) acc[rr][j] *= alpha;
    }
    __syncwarp();

#pragma unroll 4
    for (int tt = 0; tt < kKeys; ++tt) {
      float vc[kCPL];
#pragma unroll
      for (int j = 0; j < kCPL; ++j) vc[j] = v_s[tt][lane + 32 * j];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float p = p_s[warp][rr][tt];
#pragma unroll
        for (int j = 0; j < kCPL; ++j) acc[rr][j] = fmaf(p, vc[j], acc[rr][j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= row_end) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    const long long base = (row / a.rep) * a.pos_stride + (row % a.rep) * D;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) out_cell[base + lane + 32 * j] = acc[rr][j] * inv;
  }
}

// One launch: grid (b*g cells, ceil(n_rows / kRows) row tiles).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ out, CellArgs a) {
  const long long cell = blockIdx.x;
  const long long q_off = cell * a.rep * D;
  const long long kv_off = cell * D;
  attend_rows<T, D>(q + q_off, k + kv_off, v + kv_off, out + q_off,
                    blockIdx.y * kRows, a);
}

template <typename T, int D>
int launch_attend(const void* q, const void* k, const void* v, float* out,
                  int cells, const CellArgs& a, cudaStream_t stream) {
  const dim3 grid(cells, (a.n_rows + kRows - 1) / kRows);
  attend_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, a);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 = float32, 1 = bfloat16; head dims 64 and 128.
inline int dispatch_attend(const void* q, const void* k, const void* v,
                           float* out, int cells, int d, int dtype,
                           const CellArgs& a, cudaStream_t stream) {
  if (cells <= 0 || a.n_rows <= 0) return 0;
  if (dtype == 0 && d == 64) return launch_attend<float, 64>(q, k, v, out, cells, a, stream);
  if (dtype == 0 && d == 128) return launch_attend<float, 128>(q, k, v, out, cells, a, stream);
  if (dtype == 1 && d == 64) return launch_attend<__nv_bfloat16, 64>(q, k, v, out, cells, a, stream);
  if (dtype == 1 && d == 128) return launch_attend<__nv_bfloat16, 128>(q, k, v, out, cells, a, stream);
  return -1;
}

}  // namespace apex_flash
