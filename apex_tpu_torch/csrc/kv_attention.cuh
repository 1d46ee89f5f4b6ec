// Shared body of the KV-cache attention kernels #21 (window_attention.cu:
// the prefill and speculative-verify window), #25 (gqa_decode.cu: the
// one-token decode) and #22's path 1 (spec_verify.cu: the verify window
// over the int8 serving store): flash attention of the query rows of one
// (batch, kv-group) cell against that cell's live slice of the cache,
// split over the SMs along the keys and merged in the same launch. The
// kernel takes its K/V through a source type: DenseKV (#21, #25: the
// bf16 or fp32 cache as it is) or Int8KV (#22: codes and block scales,
// below its definition).
//
// Layouts (all contiguous, the JAX package's):
//   q, out  [w, b, g, rep, d]   (decode: w = 1, i.e. [b, g, rep, d]); out fp32
//   k, v    [T, b, g, d]        the per-layer cache buffers
//   starts  [b] int32           each batch row's own offset, on the device
// A cell's query rows are numbered r = i * rep + j (window position i,
// head j of the group); row r sits at absolute position start + r / rep,
// where start = starts[batch row] + start_bias (window: the chunk's first
// position, bias 0; decode: the live length, bias -1), so the rows of one
// launch may sit at different fill levels. Key t is visible to row r iff
// t <= pos(r) and, with a window, pos(r) - t < window. Masked scores are
// -1e30 (not -inf) in the TPU kernels and the plain versions and weigh
// exactly 0 there; here they are -inf, which weighs 0 without a flag. The
// softcap is cap * tanh(s / cap) after the scale.
//
// Grid (b*g cells, row tiles of 16, S splits); 4 warps a block.
//  * Row tiles. A block takes 16 consecutive rows of a cell, one mma tile
//    (M = 16): a decode cell's 8 rows at rep 8 (rows 8-15 are zero queries,
//    never written), two window positions of a prefill. Its 4 warps share
//    the rows and split the keys. Every launch shape takes the same tile,
//    so a row's result depends only on its own key range: a decode step
//    and a prefill of the same context compute a row alike, as the first
//    design did (32-row tiles were faster at the 1024-row prefill, but
//    summed a row in another order than the decode did; PERF.md section 6).
//    The tile's live key range [t_lo, t_hi] runs from the window start of
//    its first row (0 without a window) to the position of its last row,
//    read from `starts` on the device: nothing reads a length on the host,
//    so a call is one launch and can be captured in a CUDA graph.
//  * Splits. The grid's S comes from the shapes and the SM count alone
//    (`kv_attention.plan`). A range of n 16-key steps uses S' = max(1,
//    min(S, n / kMinSplitSteps)) of them, split s taking steps
//    [s*n/S', (s+1)*n/S') (`kv_attention.split_keys` is the same rule), so
//    the work follows the live length, not T: a long decode range runs as
//    up to 16 blocks a cell, a short one unsplit, and the unused blocks
//    leave at once.
//  * Keys. A split streams its steps through shared memory in stages of 4
//    steps (64 keys), K and V rows kept in the input type and copied with
//    cp.async, 16 bytes a thread, into a ring of kStages stages (the next
//    stage's copy overlaps this one's arithmetic; deeper rings measured no
//    faster and cost occupancy); rows are padded by 16 bytes so that
//    ldmatrix reads them without bank conflicts, and rows past the split's
//    last key are zero-filled. Warp w takes step w of every stage. A warp
//    is bound by the latency of its chain of products, softmax and
//    shuffles, so the 4 warps of a block are 4 independent chains over
//    one tile. Where every key of a warp's step is visible to all its
//    rows (the bulk of a long range), no mask is computed.
//  * bf16 arithmetic on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
//    accumulate), not wgmma: a decode cell has 8 query rows and wgmma
//    takes 64. Scores: Q fragments are loaded into registers once, K
//    fragments come from ldmatrix; the bf16 products are exact and summed
//    in fp32, and sm_scale multiplies the fp32 sum, as the plain version's
//    einsum(...) * sm_scale does (q is never rounded after scaling: at d
//    128, 1/sqrt(128) is not a power of two). Decode's padded tile keeps
//    the scores' accumulator fragment equal to P's operand fragment for
//    P.V, with no shuffle; the transposed form (S^T = K.Q^T, keys as M)
//    would need P^T re-laid out across the quad.
//  * P.V exact in fp32: P is split into three bf16 terms (hi = bf16(p),
//    mid = bf16(p - hi), lo = bf16(p - hi - mid); p - hi - mid - lo <=
//    2^-27 p) and each is multiplied with V (read transposed by
//    ldmatrix.trans) into the fp32 accumulator, smallest term first. The
//    softmax's exponentials are exp2f((x - m) * log2 e), the hardware's
//    base-2 exponential. (Equally accurate choices here -- expf, the order
//    hi, mid, lo -- reorder near-tied logits of the 22-layer serving model
//    differently, and chip_smoke.py's serve phases hold greedy streams to
//    a top-2 rule that some of them fail: PERF.md section 6.) P rounded
//    once to bf16 is off by up to 2^-9 p and reads over ATTN_TOL = 1e-4
//    against the plain version at the decode path's shape; hi + lo alone
//    leaves up to 2^-18 p, ten times the plain version's own fp32 error at
//    the prefill (tests/test_torch_kv_attention_split.py).
//  * fp32 inputs (the kernel checks' d 64 cases and any fp32 caller) take
//    the same grid, split and merge with fp32 FMAs in the same fragment
//    layout, Q staged in shared memory; no TF32.
//  * Merge in the same launch. The 4 warps' (m, l, acc) merge in shared
//    memory. With one split the block writes the output. Otherwise it
//    writes its partial (m, l, unnormalized acc) to fp32 scratch and bumps
//    the (cell, tile) counter with one acquire-release atomic; the last of
//    the S' blocks to arrive merges splits 0..S'-1 in index order (so the
//    result does not depend on which block came last), writes the output
//    and sets the counter back to 0 for the next launch. The counters are
//    one int32 tensor per device that the wrapper zeroes once; the scratch
//    is the wrapper's torch.empty. Launches that share the counters must
//    run in stream order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: the header is compiled into one library per kernel,
// and a static local of a template with external linkage would be one GNU
// unique object across every library loaded in the process.
namespace apex_kv {
namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;        // query rows of a block: one mma tile
constexpr int kStep = 16;        // keys of one mma step, one warp's
constexpr int kStageKeys = kStep * kWarps;  // one stage: a step a warp
constexpr int kStages = 2;       // shared-memory stages in flight
constexpr int kMaxSplits = 16;
// A split takes at least this many steps: a range of n steps uses
// max(1, min(S, n / kMinSplitSteps)) of the grid's S splits. Merging splits
// costs a few L2 round trips, about two stages' worth on the H100, so a
// short range runs unsplit (8 beat 12 and 16 there: PERF.md section 6).
constexpr int kMinSplitSteps = 8;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  int n_rows;            // w * rep query rows in a cell
  int rep;               // query heads per kv group
  int groups;            // g: cells of one batch row
  long long pos_stride;  // elements between window positions in q/out (b*g*rep*d)
  long long kv_stride;   // elements between cache rows (b*g*d)
  const int* starts;     // [b] per-row offsets on the device
  int start_bias;        // start = starts[row] + start_bias
  int cache_len;         // T
  int window;            // <= 0: no sliding window
  float sm_scale;
  float softcap;         // <= 0: no softcap
  int splits;            // S, 1 .. kMaxSplits
  float* scratch;        // S > 1: [cells*tiles*S, 16, d] acc, then [., 16, 2] (m, l)
  int* counters;         // S > 1: [cells*tiles] int32, zero between launches
  // the int8 store (Int8KV): k, v are codes [T, b, nb, B] and kv_stride
  // is in bytes (b*nb*B); the rest is unused by the dense caches
  const float* ks;       // [T, b, nb] fp32 block scales of k
  const float* vs;       // and of v
  long long scale_stride;  // scales between cache rows (b*nb)
  int nb;                // blocks of a store row
  int block;             // B lanes a block
};

// planted faults of the int8 body (#22's paths 2 and 3; kNeighbourScale
// is Int8KV's kSwapScales)
constexpr int kNoFault = 0;
constexpr int kDropLastSplit = 1;  // the last live split left out of the merge

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4 bytes global -> shared; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p (fp32) -> three bf16 terms, p = hi + mid + lo to within 2^-27 p: each
// term is the bf16 rounding of what the terms before it left, and each
// difference is exact in fp32
__device__ __forceinline__ void split3(float p, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(p);
  const float r = p - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// p0, p1 (fp32, consecutive keys) -> the bf16 pairs of their three terms
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  __nv_bfloat16 h0, m0, l0, h1, m1, l1;
  split3(p0, h0, m0, l0);
  split3(p1, h1, m1, l1);
  hi = pack_bf16(h0, h1);
  mid = pack_bf16(m0, m1);
  lo = pack_bf16(l0, l1);
}

// four int8 codes (bytes 0-3 of w) -> the bf16 pairs (c0, c1) and (c2,
// c3), exactly: c + 128 set into the mantissa of 2^23, less 2^23 + 128,
// is c in fp32, whose upper half is its bf16 (|c| <= 128 has 8
// significant bits)
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // c + 128 in each byte
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// ------------------------------------------------- shared-memory layout

// Src: the K/V source (DenseKV or Int8KV below), which sets a stage's bytes
template <typename Src>
struct Layout {
  static constexpr int D = Src::kD;
  static constexpr int kKVBytes = kStages * Src::kStageBytes;
  static constexpr int kAccLd = D + 4;           // fp32 rows: partials, fp32 Q
  // after the key loop the stages hold the warps' partials and the merge's
  // per-row weights
  static constexpr int kMergeFloats =
      kWarps * kRows * kAccLd + 2 * kWarps * kRows + kRows * kWarps + 2 * kRows;
  static constexpr int kUnionBytes =
      kKVBytes > 4 * kMergeFloats ? kKVBytes : 4 * kMergeFloats;
  static constexpr int kQBytes =
      sizeof(typename Src::Query) == 4 ? 4 * kRows * kAccLd : 0;
  static constexpr int kBytes = kUnionBytes + kQBytes;
};

// ------------------------------------------------------- warp products
//
// Fragments of mma.m16n8k16 for lane = 4 * gq + tq: scores s[nt][i] of the
// 16 rows x the warp's 16 keys hold row gq + 8 * (i >> 1), key 8 * nt + 2 *
// tq + (i & 1); the accumulator acc[nd][i] holds the same rows at dims 8 *
// nd + 2 * tq + (i & 1). Both specializations keep that layout.

template <typename T, int D>
struct WarpOps;

// bf16: tensor cores
template <int D>
struct WarpOps<__nv_bfloat16, D> {
  static constexpr int kLd = D + 8;
  uint32_t qf[D / 16][4];  // Q's A fragments, one per 16 dims

  // rows ra, rb (= ra + 8) of the cell; zero at or past row_end
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q_cell, int ra,
                                         int rb, int row_end, const Args& a,
                                         int tq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? rb : ra;
      const __nv_bfloat16* p =
          q_cell + (row / a.rep) * a.pos_stride + (row % a.rep) * D + 2 * tq;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t lo = 0, hi = 0;
        if (row < row_end) {
          lo = *reinterpret_cast<const uint32_t*>(p + kc * 16);
          hi = *reinterpret_cast<const uint32_t*>(p + kc * 16 + 8);
        }
        qf[kc][h] = lo;
        qf[kc][2 + h] = hi;
      }
    }
  }

  // s = Q . K^T for the warp's 16 keys (ks: its first key in shared)
  __device__ __forceinline__ void scores(const __nv_bfloat16* ks,
                                         float (&s)[2][4], int lane) const {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    // matrices: keys 0-7 dims +0, keys 0-7 dims +8, keys 8-15 dims +0,
    // keys 8-15 dims +8
    const int m = lane >> 3;
    const __nv_bfloat16* row =
        ks + (((m >> 1) << 3) + (lane & 7)) * kLd + ((m & 1) << 3);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b[4];
      ldmatrix_x4(b, row + kc * 16);
      mma_bf16(s[0], qf[kc], b[0], b[1]);
      mma_bf16(s[1], qf[kc], b[2], b[3]);
    }
  }

  // acc += P . V for the warp's 16 keys, P as bf16 hi + mid + lo
  __device__ __forceinline__ void pv(const __nv_bfloat16* vs,
                                     const float (&p)[2][4],
                                     float (&acc)[D / 8][4], int lane) const {
    // A fragments: (g, keys 2t), (g+8, 2t), (g, 8+2t), (g+8, 8+2t)
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split_bf16(p[f >> 1][2 * (f & 1)], p[f >> 1][2 * (f & 1) + 1], hi[f],
                 mid[f], lo[f]);
    // matrices (transposed): keys 0-7 dims +0, keys 8-15 dims +0,
    // keys 0-7 dims +8, keys 8-15 dims +8
    const int m = lane >> 3;
    const __nv_bfloat16* row =
        vs + (((m & 1) << 3) + (lane & 7)) * kLd + ((m >> 1) << 3);
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + dc * 16);
      // smallest term first
      mma_bf16(acc[2 * dc], lo, b[0], b[1]);
      mma_bf16(acc[2 * dc + 1], lo, b[2], b[3]);
      mma_bf16(acc[2 * dc], mid, b[0], b[1]);
      mma_bf16(acc[2 * dc + 1], mid, b[2], b[3]);
      mma_bf16(acc[2 * dc], hi, b[0], b[1]);
      mma_bf16(acc[2 * dc + 1], hi, b[2], b[3]);
    }
  }
};

// fp32: FMAs in the same fragment layout, Q rows from shared memory
template <int D>
struct WarpOps<float, D> {
  static constexpr int kLd = D + 4;
  const float* qa;  // the lane's two query rows, staged in shared memory
  const float* qb;

  __device__ __forceinline__ void scores(const float* ks, float (&s)[2][4],
                                         int lane) const {
    const int tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qa + c);
      const float4 y = *reinterpret_cast<const float4*>(qb + c);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (8 * nt + 2 * tq + e) * kLd + c);
          float& u = s[nt][e];
          float& w = s[nt][2 + e];
          u = fmaf(x.x, kv.x, u); u = fmaf(x.y, kv.y, u);
          u = fmaf(x.z, kv.z, u); u = fmaf(x.w, kv.w, u);
          w = fmaf(y.x, kv.x, w); w = fmaf(y.y, kv.y, w);
          w = fmaf(y.z, kv.z, w); w = fmaf(y.w, kv.w, w);
        }
    }
  }

  __device__ __forceinline__ void pv(const float* vs, const float (&p)[2][4],
                                     float (&acc)[D / 8][4], int lane) const {
    const int tq = lane & 3;
    const int quad = lane & ~3;
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      // key kk's probabilities for the lane's rows sit in quad lane (kk % 8) / 2
      const int src = quad | ((kk & 7) >> 1);
      const float pa = __shfl_sync(kFull, p[kk >> 3][kk & 1], src);
      const float pb = __shfl_sync(kFull, p[kk >> 3][2 + (kk & 1)], src);
      const float* vrow = vs + kk * kLd + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float2 x = *reinterpret_cast<const float2*>(vrow + 8 * nd);
        acc[nd][0] = fmaf(pa, x.x, acc[nd][0]);
        acc[nd][1] = fmaf(pa, x.y, acc[nd][1]);
        acc[nd][2] = fmaf(pb, x.x, acc[nd][2]);
        acc[nd][3] = fmaf(pb, x.y, acc[nd][3]);
      }
    }
  }
};

// ------------------------------------------------------- K/V sources
//
// A source knows where a cell's cache rows lie, how a stage of them lands
// in shared memory (load), where a warp's 16-key step of a landed stage
// is (k_step, v_step), which key a score column holds (key_col) and where
// an accumulator element's dim is (store_acc). Ops are its warp products.

// k, v [T, b, g, d] of the query type (#21, #25): a stage holds K and V
// rows as they are, padded by 16 bytes for ldmatrix
template <typename T, int D>
struct DenseKV {
  using Query = T;
  using Ops = WarpOps<T, D>;
  static constexpr int kD = D;
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));  // K/V row
  static constexpr int kTile = kStageKeys * kLd;  // one of K, V in one stage
  static constexpr int kStageBytes = 2 * kTile * static_cast<int>(sizeof(T));
  const T* k;
  const T* v;
  long long stride;  // elements between cache rows

  __device__ __forceinline__ DenseKV(const Args& a, int cell)
      : k(static_cast<const T*>(a.k) + static_cast<long long>(cell) * D),
        v(static_cast<const T*>(a.v) + static_cast<long long>(cell) * D),
        stride(a.kv_stride) {}

  // keys [base, base + kStageKeys) into `stage`, cp.async 16 bytes a
  // thread; rows from key_end on are zero-filled, never copied
  __device__ __forceinline__ void load(unsigned char* stage, int base,
                                       int key_end, int tid) const {
    T* ks = reinterpret_cast<T*>(stage);
    T* vs = ks + kTile;
    constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
    constexpr int kPerRow = D / kChunk;
    for (int idx = tid; idx < kStageKeys * kPerRow; idx += kThreads) {
      const int kk = idx / kPerRow;
      const int c = (idx % kPerRow) * kChunk;
      const int key = base + kk;
      const int bytes = key < key_end ? 16 : 0;
      const long long off =
          static_cast<long long>(min(key, key_end - 1)) * stride + c;
      cp_async16(ks + kk * kLd + c, k + off, bytes);
      cp_async16(vs + kk * kLd + c, v + off, bytes);
    }
  }

  static __device__ __forceinline__ const T* k_step(const unsigned char* stage,
                                                    int warp) {
    return reinterpret_cast<const T*>(stage) + warp * kStep * kLd;
  }
  static __device__ __forceinline__ const T* v_step(const unsigned char* stage,
                                                    int warp) {
    return k_step(stage, warp) + kTile;
  }
  // the key (from the step's first) of score column 8 * nt + 2 * tq + e
  static __device__ __forceinline__ int key_col(int nt, int tq, int e) {
    return 8 * nt + 2 * tq + e;
  }
  // acc[nd][2h + e] is row gq + 8h, dim 8 * nd + 2 * tq + e
  static __device__ __forceinline__ void store_acc(float* pa, int ld,
                                                   const float (&acc)[D / 8][4],
                                                   int gq, int tq) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(pa + (gq + 8 * h) * ld + 8 * nd + 2 * tq) =
            make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
  }
};

// The int8 serving store (#22): codes [T, b, nb, B] with fp32 block scales
// [T, b, nb]. Cell (batch row bi, group gi) reads the d codes at lanes
// gi * d of each row, which lie in one block (B % d == 0), and that
// block's scale: the stage holds 64 rows of d code bytes for K and for V
// (16-byte chunks swizzled within a row, so that the fragment loads below
// hit distinct banks) and the rows' 64 + 64 scales. Codes (|c| <= 127)
// are exact in bf16, so the products see no rounded dequantized value:
// scores are (q . c) * ks in fp32 and P.V takes p * vs in fp32, split into
// three bf16 terms, times the codes. kSwapScales plants a fault: each key
// row's score takes its neighbour row's K scale.
template <int D, bool kSwapScales>
struct Int8KV {
  using Query = __nv_bfloat16;
  static constexpr int kD = D;
  static constexpr int kCodes = kStageKeys * D;  // bytes of K (or V) codes
  static constexpr int kChunks = D / 16;         // 16-byte chunks of a row
  static constexpr int kStageBytes = 2 * kCodes + 2 * kStageKeys * 4;
  struct Step {  // a warp's 16 rows of a landed stage
    const uint8_t* codes;
    const float* scales;
  };
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  long long stride;        // bytes between cache rows
  long long scale_stride;  // scales between cache rows

  __device__ __forceinline__ Int8KV(const Args& a, int cell) {
    const int bi = cell / a.groups;
    const int gi = cell % a.groups;
    const long long lane0 =
        static_cast<long long>(bi) * a.nb * a.block + gi * D;
    const long long s0 = static_cast<long long>(bi) * a.nb + gi * D / a.block;
    k = static_cast<const int8_t*>(a.k) + lane0;
    v = static_cast<const int8_t*>(a.v) + lane0;
    ks = a.ks + s0;
    vs = a.vs + s0;
    stride = a.kv_stride;
    scale_stride = a.scale_stride;
  }

  // the slot of 16-byte chunk c in stage row r: rows 8 apart share a
  // bank pattern, and within 8 rows the reads below take distinct banks
  static __device__ __forceinline__ int slot(int r, int c) {
    return D == 64 ? c ^ ((r >> 1) & 2) : c ^ (r & 7);
  }
  // the step's row (0-15) whose key score column 8 * nt + j holds: the
  // pairs (2m, 2m + 1) keep their rows, swapped where m is odd, so that
  // a quad's fragment rows alternate between bank halves
  static __device__ __forceinline__ int row_of(int j) {
    return j ^ ((j >> 1) & 1);
  }
  static __device__ __forceinline__ int key_col(int nt, int tq, int e) {
    return 8 * nt + row_of(2 * tq + e);
  }

  __device__ __forceinline__ void load(unsigned char* stage, int base,
                                       int key_end, int tid) const {
    int8_t* kc = reinterpret_cast<int8_t*>(stage);
    int8_t* vc = kc + kCodes;
    float* kss = reinterpret_cast<float*>(stage + 2 * kCodes);
    float* vss = kss + kStageKeys;
    for (int idx = tid; idx < kStageKeys * kChunks; idx += kThreads) {
      const int kk = idx / kChunks;
      const int c = idx % kChunks;
      const int key = base + kk;
      const int bytes = key < key_end ? 16 : 0;
      const long long off =
          static_cast<long long>(min(key, key_end - 1)) * stride + c * 16;
      const int dst = kk * D + slot(kk, c) * 16;
      cp_async16(kc + dst, k + off, bytes);
      cp_async16(vc + dst, v + off, bytes);
    }
    for (int kk = tid; kk < kStageKeys; kk += kThreads) {
      const int key = base + kk;
      const int bytes = key < key_end ? 4 : 0;
      const long long off =
          static_cast<long long>(min(key, key_end - 1)) * scale_stride;
      cp_async4(kss + kk, ks + off, bytes);
      cp_async4(vss + kk, vs + off, bytes);
    }
  }

  static __device__ __forceinline__ Step k_step(const unsigned char* stage,
                                                int warp) {
    return {stage + warp * kStep * D,
            reinterpret_cast<const float*>(stage + 2 * kCodes) + warp * kStep};
  }
  static __device__ __forceinline__ Step v_step(const unsigned char* stage,
                                                int warp) {
    return {stage + kCodes + warp * kStep * D,
            reinterpret_cast<const float*>(stage + 2 * kCodes) + kStageKeys +
                warp * kStep};
  }

  // the scales of the rows behind columns 2 * tq and 2 * tq + 1 of the
  // 8 at `sc` (rows row_of(2tq), row_of(2tq + 1): the pair, swapped for
  // odd tq)
  static __device__ __forceinline__ void pair_scales(const float* sc, int tq,
                                                     float& lo, float& hi) {
    const float2 x = *reinterpret_cast<const float2*>(sc + 2 * tq);
    lo = (tq & 1) ? x.y : x.x;
    hi = (tq & 1) ? x.x : x.y;
  }

  // acc[nd][2h + e] is row gq + 8h, dim (2 * tq + e) * D/8 + nd
  static __device__ __forceinline__ void store_acc(float* pa, int ld,
                                                   const float (&acc)[D / 8][4],
                                                   int gq, int tq) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* dst = pa + (gq + 8 * h) * ld + (2 * tq + e) * (D / 8);
#pragma unroll
        for (int m = 0; m < D / 32; ++m)
          *reinterpret_cast<float4*>(dst + 4 * m) =
              make_float4(acc[4 * m][2 * h + e], acc[4 * m + 1][2 * h + e],
                          acc[4 * m + 2][2 * h + e], acc[4 * m + 3][2 * h + e]);
      }
  }

  // The warp products. The reduction dims and keys of a tile may be taken
  // in any order that A and B fragments share: lane (gq, tq) takes the
  // dims [tq * D/4, (tq + 1) * D/4) of Q and of K, 4 a k-chunk (chunk kc:
  // dims tq * D/4 + 4 kc + {0, 1} at k 2tq, 2tq + 1 and + {2, 3} at k 2tq +
  // 8, 2tq + 9), so that a K row's share is one or two 16-byte reads; P.V's
  // output columns are dims n * D/8 + nd of tile nd, so that a V row's
  // share is D/8 contiguous bytes.
  struct Ops {
    uint32_t qf[D / 16][4];

    __device__ __forceinline__ void load_q(const __nv_bfloat16* q_cell, int ra,
                                           int rb, int row_end, const Args& a,
                                           int tq) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? rb : ra;
        const __nv_bfloat16* p = q_cell + (row / a.rep) * a.pos_stride +
                                 (row % a.rep) * D + tq * (D / 4);
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint2 w = make_uint2(0u, 0u);
          if (row < row_end) w = *reinterpret_cast<const uint2*>(p + 4 * kc);
          qf[kc][h] = w.x;
          qf[kc][2 + h] = w.y;
        }
      }
    }

    // s = (Q . C^T) * ks for the warp's 16 keys
    __device__ __forceinline__ void scores(const Step& st, float (&s)[2][4],
                                           int lane) const {
      const int gq = lane >> 2;
      const int tq = lane & 3;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = 8 * nt + row_of(gq);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              st.codes + r * D + slot(r, tq * (D / 64) + ch) * 16);
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t b0, b1;
            i8x4_to_bf16x2(ws[j], b0, b1);
            mma_bf16(s[nt], qf[4 * ch + j], b0, b1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float lo, hi;
        pair_scales(st.scales + 8 * nt, tq, lo, hi);
        if (kSwapScales) {
          const float t = lo;
          lo = hi;
          hi = t;
        }
        s[nt][0] *= lo;
        s[nt][1] *= hi;
        s[nt][2] *= lo;
        s[nt][3] *= hi;
      }
    }

    // acc += (P * vs) . C for the warp's 16 keys, P * vs as bf16 hi + mid
    // + lo
    __device__ __forceinline__ void pv(const Step& st, const float (&p)[2][4],
                                       float (&acc)[D / 8][4], int lane) const {
      const int gq = lane >> 2;
      const int tq = lane & 3;
      float pq[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float lo, hi;
        pair_scales(st.scales + 8 * nt, tq, lo, hi);
        pq[nt][0] = p[nt][0] * lo;
        pq[nt][1] = p[nt][1] * hi;
        pq[nt][2] = p[nt][2] * lo;
        pq[nt][3] = p[nt][3] * hi;
      }
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16(pq[f >> 1][2 * (f & 1)], pq[f >> 1][2 * (f & 1) + 1], hi[f],
                   mid[f], lo[f]);
      // B fragments: the lane's D/8 dims gq * D/8 + nd of the rows behind
      // k = 2tq, 2tq + 1 (b0) and 2tq + 8, 2tq + 9 (b1)
      const int rows[4] = {row_of(2 * tq), row_of(2 * tq + 1),
                           8 + row_of(2 * tq), 8 + row_of(2 * tq + 1)};
      constexpr int W = D / 32;  // words of the lane's D/8 bytes a row
      uint32_t w[4][W];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint8_t* row = st.codes + rows[r] * D;
        if constexpr (D == 64) {
          const uint2 x = *reinterpret_cast<const uint2*>(
              row + slot(rows[r], gq >> 1) * 16 + (gq & 1) * 8);
          w[r][0] = x.x;
          w[r][1] = x.y;
        } else {
          const uint4 x =
              *reinterpret_cast<const uint4*>(row + slot(rows[r], gq) * 16);
          w[r][0] = x.x;
          w[r][1] = x.y;
          w[r][2] = x.z;
          w[r][3] = x.w;
        }
      }
#pragma unroll
      for (int m = 0; m < W; ++m) {
        uint32_t b0[4], b1[4];  // tiles nd = 4m .. 4m + 3
        i8x4_to_bf16x2(__byte_perm(w[0][m], w[1][m], 0x5140), b0[0], b0[1]);
        i8x4_to_bf16x2(__byte_perm(w[0][m], w[1][m], 0x7362), b0[2], b0[3]);
        i8x4_to_bf16x2(__byte_perm(w[2][m], w[3][m], 0x5140), b1[0], b1[1]);
        i8x4_to_bf16x2(__byte_perm(w[2][m], w[3][m], 0x7362), b1[2], b1[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // smallest term first
          mma_bf16(acc[4 * m + j], lo, b0[j], b1[j]);
          mma_bf16(acc[4 * m + j], mid, b0[j], b1[j]);
          mma_bf16(acc[4 * m + j], hi, b0[j], b1[j]);
        }
      }
    }
  };
};

// ----------------------------------------------------------------- kernel

template <typename Src, int kFault>
__global__ void __launch_bounds__(kThreads) kv_attention_kernel(Args a) {
  using T = typename Src::Query;
  constexpr int D = Src::kD;
  using L = Layout<Src>;
  constexpr int C4 = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  unsigned char* stages = smem;  // [kStages][Src::kStageBytes]
  float* part_acc = reinterpret_cast<float*>(smem);  // after the key loop
  float* part_m = part_acc + kWarps * kRows * L::kAccLd;
  float* part_l = part_m + kWarps * kRows;
  float* coef = part_l + kWarps * kRows;  // [kRows][kWarps]
  float* row_m = coef + kRows * kWarps;
  float* row_l = row_m + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int cell = blockIdx.x;
  const int tile = blockIdx.y;
  const int split = blockIdx.z;

  const int row0 = tile * kRows;
  const int row_end = min(row0 + kRows, a.n_rows);
  const long long q_off = static_cast<long long>(cell) * a.rep * D;
  const T* q_cell = static_cast<const T*>(a.q) + q_off;
  const int ra = row0 + gq;
  const int rb = ra + 8;

  // Q before the offset read, so that its loads do not wait for it
  typename Src::Ops ops;
  if constexpr (sizeof(T) == 2) {
    ops.load_q(q_cell, ra, rb, row_end, a, tq);
  } else {
    float* q_s = reinterpret_cast<float*>(smem + L::kUnionBytes);
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      const int row = row0 + r;
      q_s[r * L::kAccLd + c] =
          row < row_end
              ? q_cell[(row / a.rep) * a.pos_stride + (row % a.rep) * D + c]
              : 0.f;
    }
    ops.qa = q_s + gq * L::kAccLd;
    ops.qb = ops.qa + 8 * L::kAccLd;
  }

  // the tile's live key range, cut into S parts of whole steps
  const int start = a.starts[cell / a.groups] + a.start_bias;
  const int pos_lo = start + row0 / a.rep;          // first real row's
  const int pos_hi = start + (row_end - 1) / a.rep;  // last real row's
  const int t_hi = min(pos_hi, a.cache_len - 1);
  const int t_lo = a.window > 0 ? max(pos_lo - a.window + 1, 0) : 0;
  const int steps = t_hi >= t_lo ? (t_hi - t_lo) / kStep + 1 : 0;
  // the splits this range uses; the others leave at once (block-uniform,
  // before any barrier) and the counter waits for these S alone
  const int S = max(1, min(a.splits, steps / kMinSplitSteps));
  if (split >= S) return;
  const int j0 = static_cast<int>(static_cast<long long>(steps) * split / S);
  const int j1 =
      static_cast<int>(static_cast<long long>(steps) * (split + 1) / S);
  const int n_stages = (j1 - j0 + kWarps - 1) / kWarps;
  const int qpos[2] = {start + ra / a.rep, start + rb / a.rep};

  const Src src(a, cell);
  // the split's keys end before key_end; the stage's rows from there on
  // are zero-filled (finite zeros, weighed 0), never copied
  const int key_end = min(t_lo + kStep * j1, t_hi + 1);
  auto load_stage = [&](int st) {
    src.load(stages + (st % kStages) * Src::kStageBytes,
             t_lo + kStep * (j0 + st * kWarps), key_end, tid);
  };

  // the first kStages - 1 stages in flight (a group each, empty past the
  // last stage, so that the waits below count alike)
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) load_stage(st);
    cp_async_commit();
  }

  // online softmax state of the lane's two rows
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage st landed
    // stage st (and the fp32 Q rows) visible to all, and every warp is
    // done with stage st - 1, whose buffer the next load refills
    __syncthreads();
    if (st + kStages - 1 < n_stages) load_stage(st + kStages - 1);
    cp_async_commit();
    const int step = j0 + st * kWarps + warp;  // the warp's step
    if (step < j1) {
      const unsigned char* stage = stages + (st % kStages) * Src::kStageBytes;
      const int key0 = t_lo + kStep * step;
      float s[2][4];
      ops.scores(Src::k_step(stage, warp), s, lane);
      // no mask where every key of the step is visible to every row
      const bool open = key0 + kStep <= key_end && key0 + kStep - 1 <= pos_lo &&
                        (a.window <= 0 || pos_hi - key0 < a.window);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e;
            float x = s[nt][i] * a.sm_scale;
            if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
            if (!open) {
              const int key = key0 + Src::key_col(nt, tq, e);
              bool mk = key > qpos[h] || key >= key_end;
              if (a.window > 0) mk = mk || (qpos[h] - key >= a.window);
              if (mk) x = -INFINITY;
            }
            s[nt][i] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = exp2f((m[h] - m_new) * kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f((s[nt][2 * h + e] - m_new) * kLog2e);
            s[nt][2 * h + e] = p;
            sum += p;
          }
        l[h] = alpha * l[h] + sum;  // the lane's share; the quad's summed below
        m[h] = m_new;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          acc[nd][2 * h] *= alpha;
          acc[nd][2 * h + 1] *= alpha;
        }
      }
      ops.pv(Src::v_step(stage, warp), s, acc, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages the partials reuse

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }

  // the warps' partials over the (now free) stages
  {
    float* pa = part_acc + warp * kRows * L::kAccLd;
    Src::store_acc(pa, L::kAccLd, acc, gq, tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (tq == 0) {
        part_m[warp * kRows + gq + 8 * h] = m[h];
        part_l[warp * kRows + gq + 8 * h] = l[h];
      }
    }
  }
  __syncthreads();

  // merge the 4 warps in index order: weights exp(m_w - M)
  const int n_real = row_end - row0;
  for (int r = tid; r < n_real; r += kThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part_m[w * kRows + r]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(part_m[w * kRows + r] - mx);
      coef[r * kWarps + w] = e;
      sum += e * part_l[w * kRows + r];
    }
    row_m[r] = mx;
    row_l[r] = sum;
  }
  __syncthreads();

  float* out_cell = a.out + q_off;
  auto out_row = [&](int r) {
    const int row = row0 + r;
    return out_cell + (row / a.rep) * a.pos_stride + (row % a.rep) * D;
  };
  auto block_acc = [&](int r, int c) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = coef[r * kWarps + w];
      const float4 x = *reinterpret_cast<const float4*>(
          part_acc + (w * kRows + r) * L::kAccLd + c);
      o.x += e * x.x; o.y += e * x.y; o.z += e * x.z; o.w += e * x.w;
    }
    return o;
  };

  if (S == 1) {
    for (int idx = tid; idx < n_real * C4; idx += kThreads) {
      const int r = idx / C4;
      const int c = (idx % C4) * 4;
      const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
      float4 o = block_acc(r, c);
      o.x *= inv; o.y *= inv; o.z *= inv; o.w *= inv;
      *reinterpret_cast<float4*>(out_row(r) + c) = o;
    }
    return;
  }

  // S > 1: this split's partial to scratch; the last of the S blocks to
  // arrive merges them
  const long long tile_id = static_cast<long long>(cell) * gridDim.y + tile;
  // scratch slots follow the grid's splits (gridDim.z), S of them used
  const long long slots =
      static_cast<long long>(gridDim.x) * gridDim.y * gridDim.z;
  float* acc_scr = a.scratch;                     // [slots][16][D]
  float* ml_scr = a.scratch + slots * kRows * D;  // [slots][16][2]
  const long long slot0 = tile_id * gridDim.z;
  {
    const long long slot = slot0 + split;
    for (int idx = tid; idx < n_real * C4; idx += kThreads) {
      const int r = idx / C4;
      const int c = (idx % C4) * 4;
      *reinterpret_cast<float4*>(acc_scr + (slot * kRows + r) * D + c) =
          block_acc(r, c);
    }
    for (int r = tid; r < n_real; r += kThreads) {
      ml_scr[(slot * kRows + r) * 2] = row_m[r];
      ml_scr[(slot * kRows + r) * 2 + 1] = row_l[r];
    }
  }
  __syncthreads();  // the block's partial is written
  if (tid == 0) {
    // release: the partial is visible device-wide before the count moves;
    // acquire: the last block sees every other split's partial
    const int prev = atomic_add_acq_rel(a.counters + tile_id, 1);
    last_block = prev == S - 1;
    if (last_block) atomicExch(a.counters + tile_id, 0);
  }
  __syncthreads();
  if (!last_block) return;

  // the last block: each output element merges splits 0..S-1 in index
  // order, online (a running max, sum and accumulator rescaled as each
  // split joins). The partial sums and (m, l) of kMergeGroup splits are
  // loaded together (unrolled and predicated), so the merge costs one L2
  // round trip per group and element pass, with a bounded register count
  // (all kMaxSplits at once doubled the kernel's registers); L2 reads
  // (ld.cg), as the other blocks' partials are not in this SM's L1.
  constexpr int kMergeGroup = 8;
  const int merged = kFault == kDropLastSplit ? S - 1 : S;
  for (int idx = tid; idx < n_real * C4; idx += kThreads) {
    const int r = idx / C4;
    const int c = (idx % C4) * 4;
    float mx = kNegInf;
    float sum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < merged; s0 += kMergeGroup) {
      float ms[kMergeGroup], ls[kMergeGroup];
      float4 x[kMergeGroup];
#pragma unroll
      for (int u = 0; u < kMergeGroup; ++u) {
        if (s0 + u < merged) {
          const long long row = (slot0 + s0 + u) * kRows + r;
          ms[u] = __ldcg(ml_scr + row * 2);
          ls[u] = __ldcg(ml_scr + row * 2 + 1);
          x[u] = __ldcg(reinterpret_cast<const float4*>(acc_scr + row * D + c));
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeGroup; ++u) {
        if (s0 + u < merged) {
          const float m_new = fmaxf(mx, ms[u]);
          const float keep = expf(mx - m_new);
          const float e = expf(ms[u] - m_new);
          sum = keep * sum + e * ls[u];
          o.x = keep * o.x + e * x[u].x;
          o.y = keep * o.y + e * x[u].y;
          o.z = keep * o.z + e * x[u].z;
          o.w = keep * o.w + e * x[u].w;
          mx = m_new;
        }
      }
    }
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    o.x *= inv; o.y *= inv; o.z *= inv; o.w *= inv;
    *reinterpret_cast<float4*>(out_row(r) + c) = o;
  }
}

// ----------------------------------------------------------------- launch

template <typename Src, int kFault>
int launch(const Args& a, int cells, cudaStream_t stream) {
  using L = Layout<Src>;
  const int tiles = (a.n_rows + kRows - 1) / kRows;
  if (L::kBytes > 48 * 1024) {  // above the default: opt in, once a device
    static unsigned configured = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 32 || !((configured >> dev) & 1u)) {
      e = cudaFuncSetAttribute(kv_attention_kernel<Src, kFault>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < 32) configured |= 1u << dev;
    }
  }
  kv_attention_kernel<Src, kFault>
      <<<dim3(cells, tiles, a.splits), kThreads, L::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 = float32, 1 = bfloat16; head dims 64 and 128; splits
// 1 .. kMaxSplits (above 1 with scratch and counters). Returns the
// launch's cudaError_t, or -1 for arguments it has no instance for.
inline int dispatch(const Args& a, int cells, int d, int dtype,
                    cudaStream_t stream) {
  if (cells <= 0 || a.n_rows <= 0) return 0;
  if (a.splits < 1 || a.splits > kMaxSplits) return -1;
  if (a.splits > 1 && (a.scratch == nullptr || a.counters == nullptr)) return -1;
  if (dtype == 0 && d == 64) return launch<DenseKV<float, 64>, kNoFault>(a, cells, stream);
  if (dtype == 0 && d == 128) return launch<DenseKV<float, 128>, kNoFault>(a, cells, stream);
  if (dtype == 1 && d == 64) return launch<DenseKV<__nv_bfloat16, 64>, kNoFault>(a, cells, stream);
  if (dtype == 1 && d == 128) return launch<DenseKV<__nv_bfloat16, 128>, kNoFault>(a, cells, stream);
  return -1;
}

template <int D>
int launch_int8(const Args& a, int cells, int path, cudaStream_t stream) {
  if (path == 1) return launch<Int8KV<D, false>, kNoFault>(a, cells, stream);
  if (path == 2) return launch<Int8KV<D, false>, kDropLastSplit>(a, cells, stream);
  if (path == 3) return launch<Int8KV<D, true>, kNoFault>(a, cells, stream);
  return -1;
}

// #22's body over the int8 store: bf16 q (16-byte aligned), head dims 64
// and 128, B % d == 0 (a cell's lanes in one block), codes on 16-byte
// boundaries with rows of a multiple of 16 bytes; splits as dispatch's;
// path 1 the body, 2 and 3 its planted faults (the last live split left
// out of the merge; each key's score on its neighbour row's scale).
// Returns the launch's cudaError_t, or -1 for arguments it has no
// instance for.
inline int dispatch_int8(const Args& a, int cells, int d, int path,
                         cudaStream_t stream) {
  if (cells <= 0 || a.n_rows <= 0) return 0;
  if (a.splits < 1 || a.splits > kMaxSplits) return -1;
  if (a.splits > 1 && (a.scratch == nullptr || a.counters == nullptr)) return -1;
  if (a.block <= 0 || a.block % d ||
      (static_cast<long long>(a.nb) * a.block) % 16 ||
      reinterpret_cast<uintptr_t>(a.q) % 16 ||
      reinterpret_cast<uintptr_t>(a.k) % 16 ||
      reinterpret_cast<uintptr_t>(a.v) % 16)
    return -1;
  if (d == 64) return launch_int8<64>(a, cells, path, stream);
  if (d == 128) return launch_int8<128>(a, cells, path, stream);
  return -1;
}

}  // namespace
}  // namespace apex_kv
