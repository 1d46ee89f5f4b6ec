// The GEMM of the fused row-parallel projection + all-reduce, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/kernels/fused_cc.py `_mm_kernel` (#20), launched by
// `_matmul` under `matmul_reduce_from`, `matmul_reduce_scatter` and
// `all_gather_matmul`:
//   out[m, n] = sum_k x[m, k] * w[k, n]
// accumulated in fp32 and written in the result type of x and w (fp32
// unless both are bf16). x is [M, K] with rows lda elements apart; w is
// [K, N] with rows ldw elements apart, so a column slice w[:, a:b] (each
// column tile of matmul_reduce_from) is read in place, without a copy.
// The TPU kernel pads M to a multiple of 8; here every load and store is
// guarded, which gives the same values.
//
// Exactness: each output is a sum over k of fp32 products, __fmaf_rn a
// step; bf16 inputs are widened exactly. No TF32 and no tensor cores: the
// products stay fp32-exact, as on the CPU reference. With S splits of K,
// split s sums its contiguous K range in increasing k, and the S fp32
// partials are added in split order: the result depends on the shape and
// the plan alone, never on timing, and a bf16 output is the round to
// nearest of the same fp32 sum as an fp32 output on the widened inputs
// (the plan does not read the dtype).
//
// Bound on the H100: operations. On mesh2d's fused step at GPT-2 345M
// width (batch 8 x 1024 rows) the attention tile [8192, 1024] x [1024,
// 256] is 4.29 GFLOP, 64 us at the 67 TFLOP/s of fp32 outside the tensor
// cores, and the MLP tile [8192, 4096] x [4096, 256] 17.2 GFLOP, 256 us;
// either moves under 150 MB, 45 us at 3.35 TB/s.
//
// Design. The first design (one 128 x 64 tile of 128 threads for every
// shape, all of K in one block, two buffers staged through registers, a
// K step of 16) ran at 0.50 of its bound at GPT-2's tiles and left 131
// SMs idle at tp_dp's [128, k] x [k, 64] (a grid of one block). Now:
//  - A launch plan from (M, N, K) and the SM count alone
//    (kernels/fused_cc.py `plan`, passed in as bm, bn, splits): the
//    largest of 128 x 128, 128 x 64 and 64 x 64 whose tiles fill a wave
//    (one a SM) runs unsplit; else 64 x 64 tiles split K in S (<= 16, one
//    K step each at least) near two blocks an SM. GPT-2's tiles: 128 x
//    64, S = 1 (256 blocks; split-K measured slower there); tp_dp's: 64 x
//    64 with S = 16 (K 1024) or 8 (K 256).
//  - One launch: grid (N tiles, M tiles, S). With S > 1 each block
//    writes its fp32 partial tile to scratch and bumps its tile's int32
//    counter (acquire-release); the last to arrive adds the S partials in
//    split order, writes the result type and sets the counter back to 0.
//  - 256 threads a block as 4 x 2 warps, a warp as 4 x 8 lanes; a thread
//    keeps a TM x TN register tile (8 x 8, 8 x 4 or 4 x 4): rows r, r + 4,
//    ... of its warp tile, columns c*4 .. c*4 + 3 (and 32 + c*4 ..).
//  - kStages = 4 shared-memory stages of a kBK = 32 K step, filled with
//    cp.async.cg (16 bytes, L2 only) and waited on with cp.async.wait_group;
//    one __syncthreads a step. x's tile is kept as [BM][kBK + pad] (the
//    copy cannot transpose), w's as [kBK][BN]; bf16 operands are staged as
//    bf16 and widened on the shared-memory read. Reads: a thread takes four
//    K values of each of its rows (16 or 8 bytes) and 16 (or 8) bytes of
//    each column group; the lanes of a phase read one row (a broadcast) or
//    adjacent rows, which the pad puts on distinct banks, and 8 adjacent
//    16-byte column groups: no bank conflicts (on an H100 80GB HBM3 a
//    16-byte read measured no cheaper with broadcasts than without).
//  - A K step wholly inside x and w, rows 16-byte aligned, copies with
//    no guards from two base addresses (few registers live across the K
//    loop); a chunk that is ragged (the K or N edge), or whose row does
//    not start on a 16-byte boundary (lda, ldw or the base pointer), takes
//    a guarded element path into the same stage; rows past M read zeros.
//  - Registers: no floor of two blocks an SM, so 128 x 128 runs one
//    block of 8 x 8 tiles an SM unspilled and 128 x 64 (102 registers)
//    two; capped at 128 registers the 8 x 8 tile spilled and ran slower.
//    Tiles, stages (2-4), K steps (16-64) and read widths measured within
//    a few percent of each other at GPT-2's MLP tile on an H100 80GB
//    HBM3, where the kernel runs at 0.6 of its fp32 bound (chip_smoke.py;
//    PERF.md).
// Shared memory: 104 KB a block at 128 x 64 fp32, 136 KB at 128 x 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;        // K step
constexpr int kStages = 4;     // shared-memory stages in flight
constexpr int kMaxSplits = 16;
constexpr int kMergeGroup = 8;  // partials loaded together in the merge

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// old = *p; *p += v, acquire-release at device scope
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Four K values of one x row in shared memory, widened.
__device__ __forceinline__ float4 lds_a4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds_a4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float part(const float4& v, int h) {
  return h == 0 ? v.x : h == 1 ? v.y : h == 2 ? v.z : v.w;
}

// Four adjacent w columns of one K row in shared memory, widened.
__device__ __forceinline__ float4 lds_b4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds_b4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <typename TX, typename TW, int BM, int BN>
struct Tile {
  static constexpr int kPadA = 16 / static_cast<int>(sizeof(TX));
  static constexpr int kPitchA = kBK + kPadA;  // x's tile row, elements
  static constexpr int kCX = 16 / static_cast<int>(sizeof(TX));  // a chunk
  static constexpr int kCW = 16 / static_cast<int>(sizeof(TW));
  static constexpr int kStageA = BM * kPitchA;  // elements
  static constexpr int kStageB = kBK * BN;
  static constexpr int kBytesA = kStageA * static_cast<int>(sizeof(TX));
  static constexpr int kBytesB = kStageB * static_cast<int>(sizeof(TW));
  static constexpr int kSmem = kStages * (kBytesA + kBytesB);
  // 4 x 2 warps, each of 4 x 8 lanes over a (BM / 4) x (BN / 2) tile
  static constexpr int kThreads = 256;
  static constexpr int kTM = BM / 16;  // a thread's rows
  static constexpr int kTN = BN / 16;  // a thread's columns
  static_assert(kTM == 4 || kTM == 8, "BM 64 or 128");
  static_assert(kTN == 4 || kTN == 8, "BN 64 or 128");
  static_assert((BM * kBK / kCX) % kThreads == 0, "whole x chunks a thread");
  static_assert((kBK * BN / kCW) % kThreads == 0, "whole w chunks a thread");
};

// One K step's tiles into stage buffers `as` (x rows m0.., [BM][pitch])
// and `bs` (w rows k0.., [kBK][BN]): 16-byte cp.async chunks where the
// chunk is whole and aligned, else guarded elements (zeros outside
// [0, M) x [k0, k_end) and past N).
template <typename TX, typename TW, int BM, int BN>
__device__ __forceinline__ void load_stage(
    TX* __restrict__ as, TW* __restrict__ bs, const TX* __restrict__ x,
    const TW* __restrict__ w, int M, int N, int k0, int k_end, long long lda,
    long long ldw, int m0, int n0, bool vec_x, bool vec_w) {
  using T = Tile<TX, TW, BM, BN>;
  const int t = static_cast<int>(threadIdx.x);
  constexpr int kRowChunksA = kBK / T::kCX;
#pragma unroll
  for (int i = 0; i < BM * kBK / T::kCX / T::kThreads; ++i) {
    const int q = t + i * T::kThreads;
    const int r = q / kRowChunksA;
    const int kc = (q % kRowChunksA) * T::kCX;
    TX* dst = as + r * T::kPitchA + kc;
    const int gr = m0 + r;
    const int gk = k0 + kc;
    const TX* src = x + static_cast<long long>(gr) * lda + gk;
    if (vec_x && gr < M && gk + T::kCX <= k_end) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < T::kCX; ++e)
        dst[e] = gr < M && gk + e < k_end ? src[e] : TX(0.f);
    }
  }
  constexpr int kRowChunksB = BN / T::kCW;
#pragma unroll
  for (int i = 0; i < kBK * BN / T::kCW / T::kThreads; ++i) {
    const int q = t + i * T::kThreads;
    const int r = q / kRowChunksB;
    const int nc = (q % kRowChunksB) * T::kCW;
    TW* dst = bs + r * BN + nc;
    const int gk = k0 + r;
    const int gn = n0 + nc;
    const TW* src = w + static_cast<long long>(gk) * ldw + gn;
    if (vec_w && gk < k_end && gn + T::kCW <= N) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < T::kCW; ++e)
        dst[e] = gk < k_end && gn + e < N ? src[e] : TW(0.f);
    }
  }
}

// load_stage for a K step that lies wholly inside x and w, rows 16-byte
// aligned (most steps of most tiles): cp.async only, no guards. A thread
// copies the same chunks as load_stage's, a fixed number of rows apart,
// from `xa` and `wb` (x and w at the thread's first chunk at k = 0), so
// few addresses stay live across the K loop.
template <typename TX, typename TW, int BM, int BN>
__device__ __forceinline__ void load_stage_whole(
    TX* __restrict__ as, TW* __restrict__ bs, const TX* __restrict__ xa,
    const TW* __restrict__ wb, int k0, long long lda, long long ldw) {
  using T = Tile<TX, TW, BM, BN>;
  const int t = static_cast<int>(threadIdx.x);
  constexpr int kRowChunksA = kBK / T::kCX;
  constexpr int kRowsA = T::kThreads / kRowChunksA;  // rows between chunks
  TX* da = as + (t / kRowChunksA) * T::kPitchA + (t % kRowChunksA) * T::kCX;
  const TX* sa = xa + k0;
#pragma unroll
  for (int i = 0; i < BM / kRowsA; ++i)
    cp_async16(da + i * kRowsA * T::kPitchA, sa + i * kRowsA * lda);
  constexpr int kRowChunksB = BN / T::kCW;
  constexpr int kRowsB = T::kThreads / kRowChunksB;
  TW* db = bs + (t / kRowChunksB) * BN + (t % kRowChunksB) * T::kCW;
  const TW* sb = wb + static_cast<long long>(k0) * ldw;
#pragma unroll
  for (int i = 0; i < kBK / kRowsB; ++i)
    cp_async16(db + i * kRowsB * BN, sb + i * kRowsB * ldw);
}

// A block computes the BM x BN output tile (blockIdx.y, blockIdx.x) over
// split blockIdx.z of gridDim.z (see the header note). scratch and
// counters: S > 1 only.
template <typename TX, typename TW, typename TO, int BM, int BN>
__global__ void __launch_bounds__(Tile<TX, TW, BM, BN>::kThreads)
    matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  TO* __restrict__ out, int M, int N, int K, long long lda,
                  long long ldw, bool vec_x, bool vec_w, bool vec_out,
                  float* __restrict__ scratch, int* __restrict__ counters) {
  using T = Tile<TX, TW, BM, BN>;
  constexpr int TM = T::kTM;
  constexpr int TN = T::kTN;
  extern __shared__ __align__(16) unsigned char smem[];
  TX* as0 = reinterpret_cast<TX*>(smem);
  TW* bs0 = reinterpret_cast<TW*>(smem + kStages * T::kBytesA);

  const int t = static_cast<int>(threadIdx.x);
  const int warp = t / 32;
  const int lane = t % 32;
  const int r = lane / 8;  // the lane's row in its warp: rows r + 4i
  const int c = lane % 8;  // its column group: columns c*4 (+ 32)
  const int wm0 = (warp / 2) * (BM / 4);  // the warp tile's first row
  const int wn0 = (warp % 2) * (BN / 2);  // and first column
  const int m0 = static_cast<int>(blockIdx.y) * BM;
  const int n0 = static_cast<int>(blockIdx.x) * BN;

  // this split's K range: whole steps, cut at s * steps / S
  const int S = static_cast<int>(gridDim.z);
  const int split = static_cast<int>(blockIdx.z);
  const int steps_all = (K + kBK - 1) / kBK;
  const int j0 = static_cast<int>(static_cast<long long>(steps_all) * split / S);
  const int j1 =
      static_cast<int>(static_cast<long long>(steps_all) * (split + 1) / S);
  const int k_lo = j0 * kBK;
  const int k_end = min(K, j1 * kBK);
  const int steps = j1 - j0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // a whole tile: its rows and columns inside x and w, rows aligned
  const bool whole = vec_x && vec_w && m0 + BM <= M && n0 + BN <= N;
  const TX* xa = x + static_cast<long long>(m0 + t / (kBK / T::kCX)) * lda +
                 (t % (kBK / T::kCX)) * T::kCX;
  const TW* wb = w + static_cast<long long>(t / (BN / T::kCW)) * ldw + n0 +
                 (t % (BN / T::kCW)) * T::kCW;
  auto load = [&](int stage, int k0) {
    if (whole && k0 + kBK <= k_end)
      load_stage_whole<TX, TW, BM, BN>(as0 + stage * T::kStageA,
                                       bs0 + stage * T::kStageB, xa, wb, k0,
                                       lda, ldw);
    else
      load_stage<TX, TW, BM, BN>(as0 + stage * T::kStageA,
                                 bs0 + stage * T::kStageB, x, w, M, N, k0,
                                 k_end, lda, ldw, m0, n0, vec_x, vec_w);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, k_lo + s * kBK);
    cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this thread's copies of the step
    __syncthreads();  // everyone's; and the step before is done with its stage
    {
      const int ahead = step + kStages - 1;
      if (ahead < steps) load(ahead % kStages, k_lo + ahead * kBK);
      cp_async_commit();
    }
    const int st = step % kStages;
    const TX* a_base = as0 + st * T::kStageA + (wm0 + r) * T::kPitchA;
    const TW* b_base = bs0 + st * T::kStageB + wn0 + c * 4;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = lds_a4(a_base + 4 * i * T::kPitchA + kk);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = lds_b4(b_base + (kk + h) * BN + g * 32);
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(part(a[i], h), b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight at exit

  if (S == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + wm0 + r + 4 * i;
      if (row >= M) continue;
      TO* orow = out + static_cast<long long>(row) * N;
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int col = n0 + wn0 + g * 32 + c * 4;
        if constexpr (sizeof(TO) == 4) {
          if (vec_out && col + 4 <= N) {
            *reinterpret_cast<float4*>(orow + col) =
                make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                            acc[i][4 * g + 2], acc[i][4 * g + 3]);
            continue;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) put(orow + col + j, acc[i][4 * g + j]);
      }
    }
    return;
  }

  // S > 1: this split's fp32 partial tile, [BM][BN], into its slot
  const int tile_id = static_cast<int>(blockIdx.y * gridDim.x + blockIdx.x);
  float* slot0 = scratch + static_cast<long long>(tile_id) * S * BM * BN;
  {
    float* mine = slot0 + static_cast<long long>(split) * BM * BN;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float* prow = mine + (wm0 + r + 4 * i) * BN + wn0 + c * 4;
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        __stcg(reinterpret_cast<float4*>(prow + g * 32),
               make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                           acc[i][4 * g + 2], acc[i][4 * g + 3]));
    }
  }
  __shared__ bool last_block;
  __syncthreads();  // the block's partial is written
  if (t == 0) {
    // release: the partial is visible device-wide before the count moves;
    // acquire: the last block sees every other split's partial
    const int prev = atomic_add_acq_rel(counters + tile_id, 1);
    last_block = prev == S - 1;
    if (last_block) atomicExch(counters + tile_id, 0);
  }
  __syncthreads();
  if (!last_block) return;

  // the last block: each output element adds splits 0..S-1 in index
  // order; kMergeGroup partials loaded together (one L2 round trip a
  // group), from L2 (ld.cg: the other blocks' partials are not in this
  // SM's L1)
  for (int idx = t * 4; idx < BM * BN; idx += T::kThreads * 4) {
    const int lr = idx / BN;
    const int lc = idx % BN;
    const int row = m0 + lr;
    if (row >= M) break;  // idx grows with the row
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < S; s0 += kMergeGroup) {
      float4 p[kMergeGroup];
#pragma unroll
      for (int u = 0; u < kMergeGroup; ++u)
        if (s0 + u < S)
          p[u] = __ldcg(reinterpret_cast<const float4*>(
              slot0 + static_cast<long long>(s0 + u) * BM * BN + idx));
#pragma unroll
      for (int u = 0; u < kMergeGroup; ++u) {
        if (s0 + u < S) {
          if (s0 + u == 0) {
            sum = p[u];
          } else {
            sum.x = __fadd_rn(sum.x, p[u].x);
            sum.y = __fadd_rn(sum.y, p[u].y);
            sum.z = __fadd_rn(sum.z, p[u].z);
            sum.w = __fadd_rn(sum.w, p[u].w);
          }
        }
      }
    }
    const int col = n0 + lc;
    TO* o = out + static_cast<long long>(row) * N + col;
    if constexpr (sizeof(TO) == 4) {
      if (vec_out && col + 4 <= N) {
        *reinterpret_cast<float4*>(o) = sum;
        continue;
      }
    }
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) put(o + j, v[j]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TX, typename TW, typename TO, int BM, int BN>
int launch(const void* x, const void* w, void* out, int m, int n, int k,
           long long lda, long long ldw, int splits, float* scratch,
           int* counters, cudaStream_t s) {
  using T = Tile<TX, TW, BM, BN>;
  // elements in 16 bytes: the cp.async chunks need rows that many apart
  const bool vec_x = lda % T::kCX == 0 && aligned16(x);
  const bool vec_w = ldw % T::kCW == 0 && aligned16(w);
  const bool vec_out = sizeof(TO) == 4 && n % 4 == 0 && aligned16(out);
  auto kernel = matmul_kernel<TX, TW, TO, BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  kernel<<<grid, T::kThreads, T::kSmem, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), m, n, k, lda, ldw, vec_x, vec_w, vec_out,
      scratch, counters);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, typename TO>
int launch_tile(int bm, int bn, const void* x, const void* w, void* out,
                int m, int n, int k, long long lda, long long ldw, int splits,
                float* scratch, int* counters, cudaStream_t s) {
  if (bm == 128 && bn == 128)
    return launch<TX, TW, TO, 128, 128>(x, w, out, m, n, k, lda, ldw, splits,
                                        scratch, counters, s);
  if (bm == 128 && bn == 64)
    return launch<TX, TW, TO, 128, 64>(x, w, out, m, n, k, lda, ldw, splits,
                                       scratch, counters, s);
  if (bm == 64 && bn == 64)
    return launch<TX, TW, TO, 64, 64>(x, w, out, m, n, k, lda, ldw, splits,
                                      scratch, counters, s);
  return -1;
}

}  // namespace

// dtype codes: 0 fp32, 1 bf16; out is fp32 unless both x and w are bf16.
// The launch plan (kernels/fused_cc.py `plan`): a bm x bn block tile
// (128 x 128, 128 x 64 or 64 x 64) and `splits` splits of K (1 ..
// kMaxSplits, at most one a K step of 32). With splits > 1, `scratch`
// holds tiles x splits x bm x bn fp32 and `counters` tiles int32, all 0
// (left 0 after the launch); with splits = 1 neither is read (null).
// Returns the CUDA error of the launch (0 on success); -1 for arguments
// the kernel does not take.
extern "C" int apex_tp_matmul(const void* x, const void* w, void* out, int m,
                              int n, int k, long long lda, long long ldw,
                              int x_dtype, int w_dtype, int bm, int bn,
                              int splits, float* scratch, int* counters,
                              void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0) return -1;
  if ((m + bm - 1) / bm > 65535) return -1;
  if (splits < 1 || splits > kMaxSplits || splits > (k + kBK - 1) / kBK)
    return -1;
  if (splits > 1 && (scratch == nullptr || counters == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return launch_tile<float, float, float>(bm, bn, x, w, out, m, n, k, lda,
                                            ldw, splits, scratch, counters, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_tile<bf16, float, float>(bm, bn, x, w, out, m, n, k, lda,
                                           ldw, splits, scratch, counters, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_tile<float, bf16, float>(bm, bn, x, w, out, m, n, k, lda,
                                           ldw, splits, scratch, counters, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_tile<bf16, bf16, bf16>(bm, bn, x, w, out, m, n, k, lda, ldw,
                                         splits, scratch, counters, s);
  return -1;
}
