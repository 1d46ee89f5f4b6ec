// MLA latent-cache decode attention for one token step, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/contrib/mla_decode.py `_decode_kernel` (launched by
// `_decode_pallas` under `mla_flash_decode`): q_full [b, n, L] (the
// absorbed queries [q_lat | q_pe]) against the latent cache [T, b, L],
// whose rows c_t = [kv latent | k_pe] serve as keys and whose first lat
// columns serve as values; each batch row attends to its rows
// t < lengths[bi] (int32 [b] on the device). In fp32, as the TPU kernel:
//   q = float(q_full) * scale
//   s[h, t] = q[h] . c_t
//   ctx_lat[h] = softmax_t(s[h]) @ c[:, :lat]   -> out [b, n, lat] fp32
// with an online softmax over tiles of rows and acc / max(l, 1e-30).
//
// apex_mla_decode takes a path (contrib/mla_decode.py `mla_plan` picks
// it): 0 the first design (any dtype pair), 1 the tensor-core body (bf16
// q and cache), 2 and 3 planted faults of the tensor-core body for the
// card checks (the last live split dropped; the rope columns left out of
// the scores).
//
// Bound on the H100: bytes. At `bench.py mla_decode`'s step (b 8, 16
// heads, L 576, lat 512, 4129 live rows) the live cache is 38 MB, 11.5
// us at 3.35 TB/s; the products take 2*b*n*len*L as one bf16 term and
// 3*2*b*n*len*lat as three (p below), 2.26 GFLOP, 2.3 us at 989 TFLOP/s.
// (The first design does them as fp32 FMAs: 1.15 GFLOP, 17.2 us at 67
// TFLOP/s, so it was bound by operations.)
//
// Path 1, the tensor-core body (mma_mla_decode, flash-decoding as
// kv_attention.cuh's #21/#25 with one latent "KV head" per batch row;
// lat 512, DeepSeek's kv_lora_rank):
//  * Grid (S splits, b, head groups of 16); 8 warps a block. The 16 heads
//    of a group are one mma tile (M = 16), heads past n zero queries that
//    are never written. A batch row's live range [0, len) is cut into S'
//    = max(1, min(S, steps / min_steps)) parts of whole 16-key steps (len
//    read from `lengths` on the device: nothing reads a length on the
//    host), split s taking steps [s*steps/S', (s+1)*steps/S'); the blocks
//    of splits past S' leave at once. S and min_steps come from the plan
//    (`mla_plan`; `split_keys` is the same rule).
//  * Staging by the copy engine (cp.async.bulk, TMA's one-dimensional
//    form): Q [16][L + 8] bf16 stays in shared memory (36 k-steps of
//    register fragments would cost 144 registers a lane for one term),
//    and the split's cache rows stream through 2 stages of 64 rows, one
//    1152-byte copy a row issued by warp 0, each stage completing on its
//    own mbarrier; rows are padded by 16 bytes so that ldmatrix hits no
//    bank conflicts. Rows the copies do not fill (Q's past n, the last
//    stage's past the split's end) are zeroed first: P's zeros multiply
//    them. The values are the first lat columns of the same staged rows,
//    read transposed (ldmatrix.trans): the cache is read once and never
//    copied. A stage's copy is issued at the top of the stage before it,
//    after a barrier frees its slot, so it overlaps a whole stage of
//    products. (16-byte cp.async by every thread, the first version,
//    stalled the warps on issue: loads and products ran one after the
//    other; PERF.md section 6.)
//  * Scores. Warp w takes keys [8w, 8w + 8) of a stage: S = Q . C^T on
//    mma.sync.m16n8k16, bf16 in, fp32 accumulate, in four chains (k-step
//    mod 4) with the next group's fragments loaded before the current
//    group multiplies. The bf16 products are exact, so the unscaled query
//    is one term and the scale multiplies the fp32 sum, as
//    kv_attention.cuh does: this reorders the TPU kernel's (q * scale) . c
//    only in the last place.
//  * Softmax, online over the stages, one per block: each warp's row
//    maxima meet in shared memory (a barrier), every warp takes the same
//    running max, and p = exp2f((x - m) * log2 e). Keys past a row's
//    length weigh 0.
//  * P . C[:, :lat]. P is split into three bf16 terms (apex_kv::split3,
//    p = hi + mid + lo within 2^-27 p) written as bf16 planes to shared
//    memory (a barrier); warp w accumulates columns [64w, 64w + 64) of all
//    heads over every key of the stage, 32 fp32 accumulators a lane: a
//    16-key step loads all its fragments, then issues its 24 products
//    term by term, smallest first, so that each accumulator's three terms
//    lie 8 products apart. P in one bf16 term reads over ATTN_TOL
//    (kv_attention.cuh's note). Three barriers a stage.
//  * Merge in the same launch, a tree of fan-in 4 over the S' splits: a
//    node's partial (m, l and the unnormalized accumulator, fp32, 32 KB)
//    goes to the wrapper's scratch and bumps its group's counter with one
//    acquire-release atomic; the last of the group's members to arrive
//    reads the others' partials through the copy engine and merges the
//    members in index order (weights exp2((m_i - max m) * log2 e); its
//    own from registers) into the node one level up, and sets the counter
//    back to 0; the root's merger writes the output, an unsplit block
//    writes its own. Which block merges a node depends on the arrival
//    order; what it computes does not. (One block merging 16 partials
//    alone spent most of the launch reading them: an SM reads 20-40 GB/s.)
//    The counters are kernels/kv_attention.py's per-device tensor, which
//    #21 and #25 share: launches that share them must run in stream
//    order, as one stream's do (the 27 launches of a DeepSeek-V2-Lite step
//    run on one).
//  * Occupancy: 175,104 bytes of shared memory at L 576 and 125
//    registers a thread (no spills): one block of 8 warps an SM, so the
//    plan's S fills the 132 SMs once (S = 16 at b 8). 32-row stages with 4
//    warps (two blocks an SM) measured slower at both path shapes.
//
// Path 0, the first design (mla_partial_kernel + mla_merge_kernel):
// fp32 FMAs on the CUDA cores, split along the cache as flash-decoding.
// Each block takes one batch row, a group of up to 16 heads, and one
// chunk of the cache rows, the chunk sized on the host from the buffer
// length T so that the blocks fill two per SM (b 8: 32 chunks of 144
// rows of a 4608-row cache, 256 blocks). A block streams its chunk
// through shared memory in tiles of 16 rows, kept in the cache's dtype
// in two buffers (16-byte cp.async: one tile computes while the next
// arrives) and widened to fp32 as they are read. Three syncs a tile. It
// keeps the online softmax of its heads:
//   scores: the 576 columns are split over the 8 warps (72 each); a
//     lane holds 4 rows x 2 heads, so each load of 4 columns of a row or
//     a query feeds 8 or 16 FMAs (rows padded by 16 bytes, queries by 4
//     floats: a warp's loads fall on distinct banks); the 8 partial
//     dots of a score are summed in shared memory;
//   softmax: half a warp per head, lane = row; the running max and sum
//     stay in the lanes' registers;
//   p @ c: a thread adds 8 heads x 4 latent columns over the tile.
// Blocks whose chunk lies past a row's length exit at once; no block
// reads a row at or past its length. A second kernel merges the chunks'
// partial (max, sum, acc) of each (row, head) and divides, 512 threads a
// (row, head) so that many loads are in flight.
//
// Shared memory a block: queries [16][L + 4], partial dots [8][16 x 16],
// probabilities [16][16] and rescale factors [16], fp32, and two tiles
// [16][L + 16 bytes] in the cache's dtype: 83,776 bytes at L 576 with a
// bf16 cache, two blocks an SM (fp32 cache: 120,640, one).
// Registers: 64 accumulators a thread for p @ c (the tile's product and
// the running sum, 8 heads x 4 columns), 8 for the scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "kv_attention.cuh"  // apex_kv: mma, ldmatrix, split3, cp.async

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 16;        // heads of one block
constexpr int kTile = 16;         // cache rows of one tile
constexpr int kSlices = 8;        // column slices of the scores (warps)
constexpr int kHalfHeads = 8;     // heads of one thread in the product
constexpr int kColGroups = 128;   // 4 latent columns each: lat <= 512
constexpr int kMergeParts = 4;     // chunk quarters a merge block sums
constexpr int kMergeThreads = kMergeParts * kColGroups;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 16-byte asynchronous copies from device to shared memory
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// elements of one 16-byte chunk, and the padded row stride of a staged
// tile: one chunk of padding puts a warp's row loads on distinct banks
template <typename TC>
constexpr int kPer = 16 / sizeof(TC);
template <typename TC>
__host__ __device__ __forceinline__ int stage_stride(int L) {
  return L + kPer<TC>;
}

// cp.async the rows [t0, t0 + rows) of batch row bi into stage
// [rows][stage_stride(L)], in the cache's dtype
template <typename TC>
__device__ __forceinline__ void stage_tile(TC* stage, const TC* cache, int t0,
                                           int rows, int b, int bi, int L) {
  const int chunks = L / kPer<TC>, ss = stage_stride<TC>(L);
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, k = (i - r * chunks) * kPer<TC>;
    cp_async16(stage + r * ss + k,
               cache + (static_cast<size_t>(t0 + r) * b + bi) * L + k);
  }
  cp_async_commit();
}

__device__ __forceinline__ float half_max(float v) {  // over 16 lanes
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename TC>
size_t shared_bytes(int L) {
  return sizeof(float) * (static_cast<size_t>(kHeads) * (L + 4) +
                          kSlices * kTile * kHeads + kTile * kHeads +
                          kHeads) +
         2 * static_cast<size_t>(kTile) * stage_stride<TC>(L) * sizeof(TC);
}

// One (chunk, batch row, head group) cell: partial max m, sum l and
// unnormalized acc over the chunk's live rows, into acc_out [splits, b,
// n, lat] and ml_out [splits, b, n, 2] (m = -inf: no live row).
template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads, 2)
mla_partial_kernel(const TQ* __restrict__ q, const TC* __restrict__ cache,
                   const int* __restrict__ lengths, float* __restrict__ acc_out,
                   float* __restrict__ ml_out, int b, int n, int L, int lat,
                   int T, int chunk, float scale) {
  extern __shared__ float4 smem4[];
  const int cs = L + 4;  // row stride of the queries
  const int ss = stage_stride<TC>(L);  // row stride of a staged tile
  float* q_s = reinterpret_cast<float*>(smem4);
  float* part_s = q_s + kHeads * cs;          // [slice][head * 16 + row]
  float* p_s = part_s + kSlices * kTile * kHeads;  // [row][head]
  float* alpha_s = p_s + kTile * kHeads;
  // two tiles of rows in the cache's dtype: one computes while the next
  // arrives
  TC* stages = reinterpret_cast<TC*>(alpha_s + kHeads);

  const int split = blockIdx.x, bi = blockIdx.y, h0 = blockIdx.z * kHeads;
  const int nh = min(kHeads, n - h0);
  const int live = min(lengths[bi], T);
  const int t_begin = split * chunk;
  const int t_end = min(t_begin + chunk, live);
  const size_t cell = (static_cast<size_t>(split) * b + bi) * n + h0;
  float* ml = ml_out + cell * 2;
  if (t_begin >= t_end) {  // the chunk lies past this row's length
    for (int h = threadIdx.x; h < nh; h += kThreads) {
      ml[2 * h] = -INFINITY;
      ml[2 * h + 1] = 0.f;
    }
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L4 = L / 4;

  // the group's queries, widened to fp32 and scaled before the dot (as
  // the TPU kernel); heads past n read as zero and are never written
  for (int i = tid; i < kHeads * L4; i += kThreads) {
    const int h = i / L4, k = (i - h * L4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h < nh)
      v = load4(q + (static_cast<size_t>(bi) * n + h0 + h) * L + k);
    *reinterpret_cast<float4*>(q_s + h * cs + k) =
        make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
  }

  // scores: warp = column slice; lane = rows rq + 4i (i < 4), heads hp
  // and hp + 8
  const int rq = lane & 3, hp = lane >> 2;
  const int per = (L4 + kSlices - 1) / kSlices;
  const int k_lo = warp * per, k_hi = min(k_lo + per, L4);
  // softmax: head sh = tid / 16, row sr = tid % 16; its running max and
  // sum, the same in the 16 lanes of the head
  const int sh = tid >> 4, sr = tid & 15;
  float m_run = -INFINITY, l_run = 0.f;
  // p @ c: heads hh*8 .. hh*8+7, latent columns 4cg .. 4cg+3
  const int cg = tid % kColGroups, hh = tid / kColGroups;
  const bool has_cols = 4 * cg < lat;
  float acc[kHalfHeads][4];
#pragma unroll
  for (int j = 0; j < kHalfHeads; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  stage_tile(stages, cache, t_begin, min(kTile, t_end - t_begin), b, bi, L);
  for (int t0 = t_begin, j = 0; t0 < t_end; t0 += kTile, j ^= 1) {
    const int rows = min(kTile, t_end - t0);
    // this tile's rows arrived; every thread is past the last tile's
    // products, so the other buffer may take the next tile's rows
    cp_async_wait_all();
    __syncthreads();
    const TC* c_s = stages + j * kTile * ss;
    if (t0 + kTile < t_end)
      stage_tile(stages + (j ^ 1) * kTile * ss, cache, t0 + kTile,
                 min(kTile, t_end - t0 - kTile), b, bi, L);

    // partial dots over this warp's column slice (rows past the tile's
    // end compute on stale rows and are masked below)
    float d[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i][0] = d[i][1] = 0.f;
    for (int k4 = k_lo; k4 < k_hi; ++k4) {
      const int k = 4 * k4;
      const float4 x = *reinterpret_cast<const float4*>(q_s + hp * cs + k);
      const float4 y =
          *reinterpret_cast<const float4*>(q_s + (hp + 8) * cs + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 c = load4(c_s + (rq + 4 * i) * ss + k);
        d[i][0] = dot4(d[i][0], x, c);
        d[i][1] = dot4(d[i][1], y, c);
      }
    }
    float* part = part_s + warp * kTile * kHeads;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part[hp * kTile + rq + 4 * i] = d[i][0];
      part[(hp + 8) * kTile + rq + 4 * i] = d[i][1];
    }
    __syncthreads();

    // scores (rows past the tile's end -inf) and the online softmax,
    // fp32: the tile has a live row, so the max is finite
    float s = -INFINITY;
    if (sr < rows) {
      s = 0.f;
#pragma unroll
      for (int j = 0; j < kSlices; ++j) s += part_s[j * kTile * kHeads + tid];
    }
    const float m_new = fmaxf(m_run, half_max(s));
    const float p = expf(s - m_new);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + half_sum(p);
    m_run = m_new;
    p_s[sr * kHeads + sh] = p;
    if (sr == 0) alpha_s[sh] = alpha;
    __syncthreads();

    // acc = acc * alpha + p @ c[:, :lat] over the tile's rows
    if (has_cols) {
      float e[kHalfHeads][4];
#pragma unroll
      for (int j = 0; j < kHalfHeads; ++j)
        e[j][0] = e[j][1] = e[j][2] = e[j][3] = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float4 c = load4(c_s + r * ss + 4 * cg);
        const float4 p0 = *reinterpret_cast<const float4*>(
            p_s + r * kHeads + hh * kHalfHeads);
        const float4 p1 = *reinterpret_cast<const float4*>(
            p_s + r * kHeads + hh * kHalfHeads + 4);
        const float pr[kHalfHeads] = {p0.x, p0.y, p0.z, p0.w,
                                      p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int j = 0; j < kHalfHeads; ++j) {
          e[j][0] = fmaf(pr[j], c.x, e[j][0]);
          e[j][1] = fmaf(pr[j], c.y, e[j][1]);
          e[j][2] = fmaf(pr[j], c.z, e[j][2]);
          e[j][3] = fmaf(pr[j], c.w, e[j][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kHalfHeads; ++j) {
        const float a = alpha_s[hh * kHalfHeads + j];
#pragma unroll
        for (int f = 0; f < 4; ++f)  // no FMA contraction: mul, then add
          acc[j][f] = __fadd_rn(__fmul_rn(acc[j][f], a), e[j][f]);
      }
    }
  }

  if (has_cols) {
    float* out = acc_out + cell * lat;
#pragma unroll
    for (int j = 0; j < kHalfHeads; ++j) {
      const int h = hh * kHalfHeads + j;
      if (h < nh)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(h) * lat +
                                   4 * cg) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
  if (sr == 0 && sh < nh) {
    ml[2 * sh] = m_run;
    ml[2 * sh + 1] = l_run;
  }
}

// One (head, batch row): rescale each chunk's partials to the global max
// and divide: out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M),
// 1e-30). A chunk with m = -inf (no live row) has weight 0 and is
// skipped. The chunks' (m, l) and weights are staged in shared memory;
// a thread sums 4 latent columns over a quarter of the chunks (many
// independent loads in flight), and the quarters are added in order.
__global__ void __launch_bounds__(kMergeThreads)
mla_merge_kernel(const float* __restrict__ acc_in,
                 const float* __restrict__ ml_in, float* __restrict__ out,
                 int b, int n, int lat, int splits) {
  __shared__ float4 quarter_s[kMergeParts - 1][kColGroups];
  extern __shared__ float merge_s[];
  float* m_s = merge_s;
  float* l_s = m_s + splits;
  float* w_s = l_s + splits;
  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const size_t stride = static_cast<size_t>(b) * n;  // cells per split
  const size_t cell = static_cast<size_t>(bi) * n + h;
  for (int s = tid; s < splits; s += kMergeThreads) {
    m_s[s] = ml_in[(s * stride + cell) * 2];
    l_s[s] = ml_in[(s * stride + cell) * 2 + 1];
  }
  __syncthreads();
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, m_s[s]);
  for (int s = tid; s < splits; s += kMergeThreads)
    w_s[s] = m_s[s] == -INFINITY ? 0.f : expf(m_s[s] - m);
  __syncthreads();
  const int cg = tid % kColGroups, part = tid / kColGroups;
  const int c = 4 * cg;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < lat) {
#pragma unroll 4
    for (int s = part; s < splits; s += kMergeParts) {
      const float w = w_s[s];
      if (w == 0.f) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          acc_in + (s * stride + cell) * lat + c);
      a.x += v.x * w;
      a.y += v.y * w;
      a.z += v.z * w;
      a.w += v.w * w;
    }
  }
  if (part > 0) quarter_s[part - 1][cg] = a;
  __syncthreads();
  if (part > 0 || c >= lat) return;
  for (int q = 0; q < kMergeParts - 1; ++q) {
    const float4 v = quarter_s[q][cg];
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  float l = 0.f;
  for (int s = 0; s < splits; ++s)
    if (w_s[s] != 0.f) l += l_s[s] * w_s[s];
  const float denom = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(out + cell * lat + c) =
      make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
}

template <typename TQ, typename TC>
int launch(const void* q, const void* cache, const int* lengths, float* out,
           float* acc, float* ml, int b, int n, int L, int lat, int T,
           int chunk, int splits, float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes<TC>(L);
  cudaError_t err = cudaFuncSetAttribute(
      mla_partial_kernel<TQ, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, b, (n + kHeads - 1) / kHeads);
  mla_partial_kernel<TQ, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(cache), lengths, acc,
      ml, b, n, L, lat, T, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_merge_kernel<<<dim3(n, b), kMergeThreads,
                     3 * sizeof(float) * static_cast<size_t>(splits),
                     stream>>>(acc, ml, out, b, n, lat, splits);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- path 1: the tensor-core body

constexpr int kMmaMaxSplits = 64;  // S of the grid
constexpr int kLat = 512;          // latent columns (DeepSeek's kv_lora_rank)
constexpr int kMaxDevices = 64;
// dynamic shared memory a block may take: the H100's 232,448-byte opt-in
// limit less room for the static arrays
constexpr size_t kMaxDynamicShared = 232448 - 2048;

// launch paths of apex_mla_decode past the first design (0); 2 and 3 are
// planted faults of the tensor-core body, for the card checks only
constexpr int kPathTensor = 1;
constexpr int kDropLastSplit = 2;  // the last live split left out (unsplit:
                                   // the split's last stage)
constexpr int kNoRope = 3;         // scores over the first lat columns only

struct MmaArgs {
  const __nv_bfloat16* q;      // [b, n, L]
  const __nv_bfloat16* cache;  // [T, b, L]
  const int* lengths;          // [b]
  float* out;                  // [b, n, kLat]
  float* acc;     // S > 1: [b * groups * S][16 * kLat] partial accumulators
  float* ml;      // S > 1: [b * groups * S][16][2] partial (max, sum)
  int* counters;  // S > 1: [b * groups] int32, zero between launches
  int b, n, L, T;
  int splits;     // S, the grid's splits of a (batch row, head group)
  int min_steps;  // 16-key steps a split takes at least
  int path;
  float scale;
};

// bf16 elements between staged rows (Q and cache): 16 bytes of padding
__host__ __device__ constexpr int mma_ld(int L) { return L + 8; }

// ------------------------------------------------- bulk copies (TMA)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   apex_kv::smem_addr(bar)),
               "r"(count));
}

// the issuing thread's arrival, expecting ``bytes`` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   apex_kv::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = apex_kv::smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ``bytes`` (a multiple of 16) global -> shared by the copy engine,
// completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(apex_kv::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(apex_kv::smem_addr(bar))
      : "memory");
}

// ------------------------------------------- path 1: the tensor-core body

// the body's shape: 8 warps, stages of 64 cache rows (8 a warp for the
// scores), 2 stages (about 150 KB at L 576); a warp's P . C columns are
// 64 (8 n-tiles of 8)
constexpr int kWarps = 8;
constexpr int kThreads1 = 32 * kWarps;
constexpr int kKeys = 8 * kWarps;
constexpr int kStages = 2;
constexpr int kNd = kLat / 8 / kWarps;
constexpr int kPld = kKeys + 8;  // row stride of a P plane
// counters of a (batch row, head group): the tree's groups, level by
// level (16 + 4 + 1 at S = 64)
constexpr int kCountersPerCell = 32;

// Q [16][L + 8], the ring [stages][keys][L + 8] and the three P planes
// [3][16][keys + 8], all bf16 (contrib/mla_decode.py mirrors this)
inline size_t mma_shared_bytes(int L) {
  return 2 * (static_cast<size_t>(16 + kStages * kKeys) * mma_ld(L) +
              3 * 16 * kPld);
}

// One (split, batch row, head group) cell of the tensor-core body; see
// the note at the top of the file.
__global__ void __launch_bounds__(kThreads1)
mma_mla_decode(const __grid_constant__ MmaArgs a) {
  using bf16 = __nv_bfloat16;
  using apex_kv::kLog2e;
  constexpr int kThreads = kThreads1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[kWarps][16];
  __shared__ float red_l[kWarps][16];
  __shared__ __align__(8) uint64_t bars[kStages + 1 + 3];
  __shared__ int last_block;
  uint64_t* bar_q = bars + kStages;
  uint64_t* bar_m = bar_q + 1;
  const int L = a.L, ld = mma_ld(L);
  const uint32_t row_bytes = 2 * L;
  bf16* q_s = reinterpret_cast<bf16*>(smem);       // [16][ld]
  bf16* ring = q_s + 16 * ld;                      // [kStages][kKeys][ld]
  bf16* p_s = ring + kStages * kKeys * ld;         // [hi, mid, lo][16][kPld]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int split = blockIdx.x, bi = blockIdx.y, h0 = blockIdx.z * 16;
  const int nh = min(16, a.n - h0);

  // the row's live range in 16-key steps, cut into S parts (block-uniform:
  // the blocks past S leave before any barrier)
  const int live = min(a.lengths[bi], a.T);
  const int steps = (live + 15) / 16;
  const int S = max(1, min(a.splits, steps / a.min_steps));
  if (split >= S) return;
  const int j0 = static_cast<int>(static_cast<long long>(steps) * split / S);
  const int j1 =
      static_cast<int>(static_cast<long long>(steps) * (split + 1) / S);
  const int t0 = 16 * j0;
  const int key_end = min(16 * j1, live);  // the split's keys: [t0, key_end)
  int n_stages = (key_end - t0 + kKeys - 1) / kKeys;
  if (a.path == kDropLastSplit && S == 1 && n_stages > 1) --n_stages;

  // The copy engine fills Q's rows and each stage's live rows; rows it
  // does not fill must hold finite values, as P's zeros multiply them:
  // Q's rows past n and the last stage's rows past the split's end are
  // zeroed here (a slot an earlier stage used holds that stage's rows).
  if (tid == 0) {
    for (int i = 0; i < kStages + 1 + 3; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const int last = n_stages - 1;
    const int tail = last >= 0 ? t0 + last * kKeys : 0;
    const int r_live = last >= 0 ? min(kKeys, key_end - tail) : kKeys;
    bf16* slot = ring + (last >= 0 ? last % kStages : 0) * kKeys * ld;
    const int q_words = (16 - nh) * ld / 8, s_words = (kKeys - r_live) * ld / 8;
    for (int i = tid; i < q_words + s_words; i += kThreads) {
      bf16* p = i < q_words ? q_s + nh * ld + 8 * i
                            : slot + r_live * ld + 8 * (i - q_words);
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set and the zeros written

  const size_t row_stride = static_cast<size_t>(a.b) * L;
  const bf16* cache_b = a.cache + static_cast<size_t>(bi) * L;
  // warp 0 issues a stage: lane 0 expects its bytes, the lanes copy rows
  auto issue_stage = [&](int st) {
    const int slot = st % kStages;
    const int base = t0 + st * kKeys;
    const int rows = min(kKeys, key_end - base);
    if (lane == 0) mbar_expect(bars + slot, rows * row_bytes);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_copy(ring + (slot * kKeys + r) * ld,
                cache_b + static_cast<size_t>(base + r) * row_stride,
                row_bytes, bars + slot);
  };
  if (warp == 0) {
    const bf16* qg = a.q + (static_cast<size_t>(bi) * a.n + h0) * L;
    if (lane == 0) mbar_expect(bar_q, nh * row_bytes);
    __syncwarp();
    for (int r = lane; r < nh; r += 32)
      bulk_copy(q_s + r * ld, qg + static_cast<size_t>(r) * L, row_bytes,
                bar_q);
    for (int st = 0; st < kStages - 1 && st < n_stages; ++st) issue_stage(st);
  }

  const int c0 = warp * (kLat / kWarps);  // the warp's latent columns
  const int groups = (a.path == kNoRope ? kLat : L) / 64;  // 4 k-steps each
  // online softmax state of the lane's rows gq and gq + 8 (the running max
  // is the same in every warp; the sum is the lane's share of its warp's
  // keys)
  float m_run[2] = {apex_kv::kNegInf, apex_kv::kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[kNd][4];
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  // ldmatrix rows of the lane: A fragments (Q, P) as rows 0-15 x 16
  // columns; the warp's 8 keys' B fragments x (dims +0, +8, +16, +24); C's
  // transposed B fragments (keys 0-7, 8-15) x (cols +0, +8)
  const int m4 = lane >> 3;
  const int a_off = (lane & 15) * ld + (lane >> 4) * 8;
  const int p_off = (lane & 15) * kPld + (lane >> 4) * 8;
  const int k_off = (warp * 8 + (lane & 7)) * ld + m4 * 8;
  const int v_off = (((m4 & 1) << 3) + (lane & 7)) * ld + ((m4 >> 1) << 3) + c0;

  mbar_wait(bar_q, 0);  // Q landed (waited even with no stage: no copy
                        // may outlive the block)
  for (int st = 0; st < n_stages; ++st) {
    // every warp is done with stage st - 1's slot, which warp 0 refills
    // now, a whole stage of work ahead of its use
    __syncthreads();
    if (warp == 0 && st + kStages - 1 < n_stages) issue_stage(st + kStages - 1);
    mbar_wait(bars + st % kStages, (st / kStages) & 1);  // stage st landed
    const bf16* cs = ring + (st % kStages) * kKeys * ld;
    const int key0 = t0 + st * kKeys + warp * 8;

    // the warp's scores over its 8 keys, unscaled: four chains (k-step
    // mod 4), a group's fragments loaded while the group before multiplies
    float ch[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) ch[c][i] = 0.f;
    const bf16* ks = cs + k_off;
    const bf16* qs = q_s + a_off;
    auto load = [&](uint32_t (&f)[6][4], int g) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        apex_kv::ldmatrix_x4(f[u], qs + (4 * g + u) * 16);
      apex_kv::ldmatrix_x4(f[4], ks + 4 * g * 16);
      apex_kv::ldmatrix_x4(f[5], ks + (4 * g + 2) * 16);
    };
    auto multiply = [&](const uint32_t (&f)[6][4]) {
      apex_kv::mma_bf16(ch[0], f[0], f[4][0], f[4][1]);
      apex_kv::mma_bf16(ch[1], f[1], f[4][2], f[4][3]);
      apex_kv::mma_bf16(ch[2], f[2], f[5][0], f[5][1]);
      apex_kv::mma_bf16(ch[3], f[3], f[5][2], f[5][3]);
    };
    {
      uint32_t fa[6][4], fb[6][4];
      load(fa, 0);
      for (int g = 0; g < groups; g += 2) {
        if (g + 1 < groups) load(fb, g + 1);
        multiply(fa);
        if (g + 1 < groups) {
          if (g + 2 < groups) load(fa, g + 2);
          multiply(fb);
        }
      }
    }

    // the scale on the fp32 sum; keys past the split's end weigh 0
    float s[4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + 2 * tq + (i & 1);
      const float x = (ch[0][i] + ch[1][i]) + (ch[2][i] + ch[3][i]);
      s[i] = key < key_end ? x * a.scale : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(apex_kv::kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(apex_kv::kFull, mx[h], 2));
    }
    if (tq == 0) {
      red_m[warp][gq] = mx[0];
      red_m[warp][gq + 8] = mx[1];
    }
    __syncthreads();  // every warp's row maxima of the stage

    // the block's running max (the stage has a live key: it is finite),
    // p = exp2((x - m) log2 e) as three bf16 planes, the rescale
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gq + 8 * h;
      float m = red_m[0][r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_m[w][r]);
      const float m_new = fmaxf(m_run[h], m);
      alpha[h] = exp2f((m_run[h] - m_new) * kLog2e);
      m_run[h] = m_new;
      const float p0 = exp2f((s[2 * h] - m_new) * kLog2e);
      const float p1 = exp2f((s[2 * h + 1] - m_new) * kLog2e);
      l_run[h] = alpha[h] * l_run[h] + (p0 + p1);
      uint32_t hi, mid, lo;
      apex_kv::split_bf16(p0, p1, hi, mid, lo);
      bf16* pr = p_s + r * kPld + warp * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(pr) = hi;
      *reinterpret_cast<uint32_t*>(pr + 16 * kPld) = mid;
      *reinterpret_cast<uint32_t*>(pr + 32 * kPld) = lo;
    }
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
    __syncthreads();  // the P planes of every key of the stage

    // acc += P . C[:, c0 : c0 + kLat / kWarps] over the stage, smallest
    // term first: a step's fragments, then its products term by term
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      uint32_t pt[3][4], v[kNd / 2][4];
      apex_kv::ldmatrix_x4(pt[0], p_s + 32 * kPld + p_off + j * 16);
      apex_kv::ldmatrix_x4(pt[1], p_s + 16 * kPld + p_off + j * 16);
      apex_kv::ldmatrix_x4(pt[2], p_s + p_off + j * 16);
      const bf16* vs = cs + j * 16 * ld + v_off;
#pragma unroll
      for (int dc = 0; dc < kNd / 2; ++dc)
        apex_kv::ldmatrix_x4_trans(v[dc], vs + dc * 16);
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int dc = 0; dc < kNd / 2; ++dc) {
          apex_kv::mma_bf16(acc[2 * dc], pt[t], v[dc][0], v[dc][1]);
          apex_kv::mma_bf16(acc[2 * dc + 1], pt[t], v[dc][2], v[dc][3]);
        }
    }
  }

  // the row sums: the quad's shares, then the warps' in index order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(apex_kv::kFull, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(apex_kv::kFull, l_run[h], 2);
  }
  if (tq == 0) {
    red_l[warp][gq] = l_run[0];
    red_l[warp][gq + 8] = l_run[1];
  }
  __syncthreads();  // and every warp is done with the ring
  float l_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gq + 8 * h;
    l_row[h] = red_l[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l_row[h] += red_l[w][r];
  }

  float* out_g = a.out + (static_cast<size_t>(bi) * a.n + h0) * kLat + c0 +
                 2 * tq;
  auto write_out = [&](const float (&o)[kNd][4], const float (&l)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gq + 8 * h;
      if (r >= nh) continue;
      const float d = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd)
        *reinterpret_cast<float2*>(out_g + r * kLat + 8 * nd) =
            make_float2(o[nd][2 * h] / d, o[nd][2 * h + 1] / d);
    }
  };
  if (S == 1) {
    write_out(acc, l_row);
    return;
  }

  // S > 1: a tree of fan-in 4 over the splits. A node's partial (m, l and
  // the unnormalized accumulator in fragment order, float4 nd * kThreads
  // + tid of a 32 KB slot) goes to scratch and its group's counter moves;
  // the last of the group's members to arrive merges them in index order
  // (its own from registers) into the group's node one level up, and the
  // root's merger writes the output. Which block merges a node depends on
  // the arrival order; what it computes does not.
  constexpr int kSlot = kNd * kThreads;  // float4 a slot: 16 x kLat fp32
  constexpr uint32_t kSlotBytes = 16 * kSlot;
  const int cell = bi * gridDim.z + blockIdx.z;
  float4* const scratch =
      reinterpret_cast<float4*>(a.acc) + static_cast<size_t>(cell) * 2 * a.splits * kSlot;
  float2* const ml_g = reinterpret_cast<float2*>(a.ml) +
                       static_cast<size_t>(cell) * 2 * a.splits * 16;
  int* const ctr = a.counters + cell * kCountersPerCell;
  float4* buf = reinterpret_cast<float4*>(ring);  // [3][kSlot]: the ring is free
  float2* ml_s = reinterpret_cast<float2*>(q_s);  // [4][16]: Q is done
  float* w_s = reinterpret_cast<float*>(ml_s + 4 * 16);  // [4][16]
  float* top_s = w_s + 4 * 16;                     // [16] merged max
  float* sum_s = top_s + 16;                       // [16] merged sum
  float m_d[2] = {m_run[0], m_run[1]};
  if (a.path == kDropLastSplit && split == S - 1) {  // it weighs nothing
    m_d[0] = m_d[1] = apex_kv::kNegInf;
    l_row[0] = l_row[1] = 0.f;
  }
  int node = split, width = S, level_slot = 0, level_ctr = 0, phases = 0;
  while (width > 1) {
    const int first = node & ~3, members = min(4, width - first);
    if (members > 1) {
      {
        float4* pa = scratch + static_cast<size_t>(level_slot + node) * kSlot + tid;
#pragma unroll
        for (int nd = 0; nd < kNd; ++nd)
          __stcg(pa + nd * kThreads,
                 make_float4(acc[nd][0], acc[nd][1], acc[nd][2], acc[nd][3]));
        if (warp == 0 && tq == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            __stcg(ml_g + (level_slot + node) * 16 + gq + 8 * h,
                   make_float2(m_d[h], l_row[h]));
        }
      }
      __syncthreads();  // the node's partial is written
      if (tid == 0) {
        // release: the partial is visible device-wide before the count
        // moves; acquire: the last member sees every other one's
        int* c = ctr + level_ctr + (node >> 2);
        const int prev = apex_kv::atomic_add_acq_rel(c, 1);
        last_block = prev == members - 1;
        if (last_block) atomicExch(c, 0);
      }
      __syncthreads();
      if (!last_block) return;
      // the other members' partials through the copy engine into the free
      // ring, their (m, l) at once; then weights exp2((m_i - M) log2 e)
      // and the merged sum, one thread a row
      if (tid == 0) {
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int i = 0, k = 0; i < members; ++i) {
          if (first + i == node) continue;
          mbar_expect(bar_m + k, kSlotBytes);
          bulk_copy(buf + k * kSlot,
                    scratch + static_cast<size_t>(level_slot + first + i) * kSlot,
                    kSlotBytes, bar_m + k);
          ++k;
        }
      }
      if (tid < 16 * members)
        ml_s[tid] = __ldcg(ml_g + (level_slot + first) * 16 + tid);
      __syncthreads();
      if (tid < 16) {
        float mx = apex_kv::kNegInf;
        for (int i = 0; i < members; ++i) mx = fmaxf(mx, ml_s[i * 16 + tid].x);
        float l = 0.f;
        for (int i = 0; i < members; ++i) {
          const float w = exp2f((ml_s[i * 16 + tid].x - mx) * kLog2e);
          w_s[i * 16 + tid] = w;
          l += w * ml_s[i * 16 + tid].y;
        }
        top_s[tid] = mx;
        sum_s[tid] = l;
      }
      __syncthreads();
      float o[kNd][4];
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[nd][j] = 0.f;
      for (int i = 0, k = 0; i < members; ++i) {
        const float wa = w_s[i * 16 + gq], wb = w_s[i * 16 + gq + 8];
        if (first + i == node) {
#pragma unroll
          for (int nd = 0; nd < kNd; ++nd) {
            o[nd][0] = fmaf(wa, acc[nd][0], o[nd][0]);
            o[nd][1] = fmaf(wa, acc[nd][1], o[nd][1]);
            o[nd][2] = fmaf(wb, acc[nd][2], o[nd][2]);
            o[nd][3] = fmaf(wb, acc[nd][3], o[nd][3]);
          }
          continue;
        }
        mbar_wait(bar_m + k, (phases >> k) & 1);  // member i landed
        phases ^= 1 << k;
        const float4* x4 = buf + k * kSlot + tid;
#pragma unroll
        for (int nd = 0; nd < kNd; ++nd) {
          const float4 x = x4[nd * kThreads];
          o[nd][0] = fmaf(wa, x.x, o[nd][0]);
          o[nd][1] = fmaf(wa, x.y, o[nd][1]);
          o[nd][2] = fmaf(wb, x.z, o[nd][2]);
          o[nd][3] = fmaf(wb, x.w, o[nd][3]);
        }
        ++k;
      }
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nd][j] = o[nd][j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_d[h] = top_s[gq + 8 * h];
        l_row[h] = sum_s[gq + 8 * h];
      }
      __syncthreads();  // the ring, ml_s and the weights are read
    }
    node >>= 2;
    level_slot += width;
    level_ctr += (width + 3) >> 2;
    width = (width + 3) >> 2;
  }
  write_out(acc, l_row);
}

// The opt-in shared memory is raised once a device to the largest size
// launched there (read by the host only).
int launch_mma(const MmaArgs& a, cudaStream_t stream) {
  static size_t configured[kMaxDevices] = {};
  const size_t smem = mma_shared_bytes(a.L);
  if (smem > kMaxDynamicShared) return -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(mma_mla_decode,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = smem;
  }
  const dim3 grid(a.splits, a.b, (a.n + 15) / 16);
  mma_mla_decode<<<grid, kThreads1, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (dtype q_dtype: 0 fp32, 1 bf16) [b, n, L]; cache (c_dtype) [T, b, L];
// lengths int32 [b]; out fp32 [b, n, lat]. path 0, the first design:
// scratch acc fp32 [splits, b, n, lat] and ml fp32 [splits, b, n, 2];
// chunk rows a block (a multiple of 16), splits = ceil(T / chunk);
// requires L % 8 == 0, lat % 4 == 0, 0 < lat <= min(L, 512), L <= 1024;
// counters and min_steps are not read. Paths 1-3, the tensor-core body
// (2 and 3 planted faults): bf16 q and cache, L % 64 == 0, lat == 512 <=
// L, splits (the grid's S) 1..64,
// min_steps >= 1; with splits > 1 scratch acc fp32 [b * ceil(n / 16) * 2 *
// splits, 16, 512] and ml fp32 [., 16, 2] (the merge tree's nodes) and
// counters int32 [b * ceil(n / 16) * 32], zero (and left zero); chunk is
// not read.
// Every path: q and cache on 16-byte boundaries. Returns 0, a CUDA
// error, or -1 for arguments the path has no instance for.
extern "C" int apex_mla_decode(const void* q, const void* cache,
                               const int* lengths, float* out, float* acc,
                               float* ml, int* counters, int b, int n, int L,
                               int lat, int T, int chunk, int splits,
                               int min_steps, float scale,
                               int q_dtype, int c_dtype, int path,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path != 0) {
    if (path < kPathTensor || path > kNoRope || q_dtype != 1 ||
        c_dtype != 1 || L % 64 || lat != kLat || L < lat || splits < 1 ||
        splits > kMmaMaxSplits || min_steps < 1 ||
        (splits > 1 && (acc == nullptr || ml == nullptr ||
                        counters == nullptr)) ||
        b > 65535 || (n + 15) / 16 > 65535)
      return -1;
    if (b <= 0 || n <= 0 || T <= 0) return 0;
    const MmaArgs args{static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(cache),
                       lengths, out, acc, ml, counters, b, n, L, T,
                       splits, min_steps, path, scale};
    return launch_mma(args, s);
  }
  if (L % 8 || lat % 4 || lat <= 0 || lat > L || lat > 4 * kColGroups ||
      L > 1024 || chunk <= 0 || chunk % kTile || splits <= 0 ||
      static_cast<long long>(chunk) * splits < T)
    return -1;
  if (b <= 0 || n <= 0 || T <= 0) return 0;
  if (q_dtype == 0 && c_dtype == 0)
    return launch<float, float>(q, cache, lengths, out, acc, ml, b, n, L, lat,
                                T, chunk, splits, scale, s);
  if (q_dtype == 0 && c_dtype == 1)
    return launch<float, __nv_bfloat16>(q, cache, lengths, out, acc, ml, b, n,
                                        L, lat, T, chunk, splits, scale, s);
  if (q_dtype == 1 && c_dtype == 0)
    return launch<__nv_bfloat16, float>(q, cache, lengths, out, acc, ml, b, n,
                                        L, lat, T, chunk, splits, scale, s);
  if (q_dtype == 1 && c_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, cache, lengths, out, acc,
                                                ml, b, n, L, lat, T, chunk,
                                                splits, scale, s);
  return -1;
}
