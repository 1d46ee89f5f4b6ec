// The first design of the int8-cache verify kernel #22 (spec_verify.cu's
// path 0: fp32 q, and cells whose lanes cross a block of the store): flash
// attention of a few query rows of one (batch, kv-group) cell against
// that cell's slice of the cache. The window and decode kernels (#21,
// #25) and #22's path 1 run the body of kv_attention.cuh instead (split
// over the keys, tensor cores; #22 through its Int8KV source there).
//
// Layouts (all contiguous, the JAX package's):
//   q, out  [w, b, g, rep, d]   (decode: w = 1, i.e. [b, g, rep, d]); out fp32
//   kq, vq  [T, b, nb, B] int8 with ks, vs [T, b, nb] fp32 block scales:
//                               the int8 serving store (Int8KV), whose
//                               lane l of a cache row holds the group
//                               l / d's column l % d
//   starts  [b] int32           each batch row's own offset
// A cell's query rows are numbered r = i * rep + j (window position i,
// head j of the group); row r sits at absolute position start + r / rep,
// where start = starts[batch row] + start_bias (the verify chunk's first
// position, bias 0), so the rows of one launch may sit at different fill
// levels.
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
#include <stdint.h>

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
  int groups;        // g: cells of one batch row
  long long pos_stride;  // elements between window positions in q/out (b*g*rep*d)
  const int* starts; // [b] per-row offsets on the device
  int start_bias;    // start = starts[row] + start_bias
  int cache_len;     // T
  int window;        // <= 0: no sliding window
  float sm_scale;
  float softcap;     // <= 0: no softcap
};

// K/V of one cell from the int8 serving store: codes [T, b, nb, B] and
// fp32 scales [T, b, nb], dequantized on the way into shared memory
// (kq * ks per block, the TPU kernel's in-VMEM widening), so the
// dequantized cache never exists in device memory.
struct Int8KV {
  const int8_t* kq;  // row 0 of the cell's batch row, lane 0
  const int8_t* vq;
  const float* ks;   // scale 0 of the cell's batch row
  const float* vs;
  long long stride;        // bytes between cache rows (b*nb*B)
  long long scale_stride;  // scales between cache rows (b*nb)
  int lane0;               // the cell's first lane: group * d
  int block;               // B
  __device__ __forceinline__ void load(long long t, int c, float* kv,
                                       float* vv) const {
    const int lane = lane0 + c;
    const long long s = t * scale_stride + lane / block;
    const long long off = t * stride + lane;
    *kv = static_cast<float>(kq[off]) * ks[s];
    *vv = static_cast<float>(vq[off]) * vs[s];
  }
};

// kTile * (D + 1) floats of K and of V fit the 48 KB of static shared
// memory for D = 64 (kTile 64) and D = 128 (kTile 32).
template <int D>
struct Tile {
  static constexpr int kKeys = 4096 / D;
  static constexpr int kKeysPerLane = kKeys / 32;
  static constexpr int kColsPerLane = D / 32;
};

// Block body. q_cell/out_cell point at row 0 of the cell, kv reads the
// cell's cache rows; row0 is the block's first row, start the absolute
// position of the cell's window position 0.
template <typename T, int D, typename KV>
__device__ __forceinline__ void attend_rows(const T* __restrict__ q_cell,
                                            const KV& kv_cell,
                                            float* __restrict__ out_cell,
                                            int row0, int start,
                                            const CellArgs& a) {
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
  const int first_pos = start + row0 / a.rep;
  const int last_pos = start + (row_end - 1) / a.rep;
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
    qpos[rr] = start + (row0 + warp * kRowsPerWarp + rr) / a.rep;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) acc[rr][j] = 0.f;
  }

  for (int t0 = t_lo; t0 <= t_hi; t0 += kKeys) {
    __syncthreads();  // the previous tile (and q_s on entry) is complete
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int tt = idx / D, c = idx % D;
      const int t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t <= t_hi) kv_cell.load(t, c, &kv, &vv);
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

}  // namespace apex_flash
