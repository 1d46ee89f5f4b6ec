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
// Bound on the H100: operations. At the model's decode step (b 8, 16
// heads, L 576, lat 512, ~4130 live rows) the live cache is 38 MB, 11.4
// us at 3.35 TB/s, and the two products take 2*b*n*len*(L + lat) = 1.15
// GFLOP, 17.2 us at the 67 TFLOP/s of fp32 outside the tensor cores. p
// stays fp32, as in the TPU kernel, so the tensor cores are not used.
//
// Design (split along the cache, as flash-decoding): the TPU grid is
// (b, tiles) with every head of a batch row in one cell; on 132 SMs that
// is 8 blocks. Here each block takes one batch row, a group of up to 16
// heads, and one chunk of the cache rows, the chunk sized on the host so
// that the blocks fill two per SM (b 8: 32 chunks of 144 rows of a
// 4608-row cache, 256 blocks). A block streams its chunk through shared
// memory in tiles of 16 rows, kept in the cache's dtype in two buffers
// (16-byte cp.async: one tile computes while the next arrives) and
// widened to fp32 as they are read. Three syncs a tile. It keeps the
// online softmax of its heads:
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

}  // namespace

// q (dtype q_dtype: 0 fp32, 1 bf16) [b, n, L]; cache (c_dtype) [T, b, L];
// lengths int32 [b]; out fp32 [b, n, lat]; scratch acc fp32 [splits, b,
// n, lat] and ml fp32 [splits, b, n, 2]; chunk rows a block (a multiple
// of 16), splits = ceil(T / chunk). Requires L % 8 == 0, lat % 4 == 0,
// 0 < lat <= min(L, 512), L <= 1024, q and cache on 16-byte boundaries.
// Returns 0, a CUDA error, or -1 for arguments the kernel has no instance
// for.
extern "C" int apex_mla_decode(const void* q, const void* cache,
                               const int* lengths, float* out, float* acc,
                               float* ml, int b, int n, int L, int lat, int T,
                               int chunk, int splits, float scale,
                               int q_dtype, int c_dtype, void* stream) {
  if (L % 8 || lat % 4 || lat <= 0 || lat > L || lat > 4 * kColGroups ||
      L > 1024 || chunk <= 0 || chunk % kTile || splits <= 0 ||
      static_cast<long long>(chunk) * splits < T)
    return -1;
  if (b <= 0 || n <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
