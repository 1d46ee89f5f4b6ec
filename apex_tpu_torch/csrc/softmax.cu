// Scaled, scaled-masked and causal softmax forward and softmax backward
// for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces apex_tpu/kernels/softmax.py `_fwd_kernel` (launched by
// `scaled_softmax`), `_masked_fwd_kernel` (`scaled_masked_softmax`),
// `_causal_fwd_kernel` (`scaled_upper_triang_masked_softmax`) and
// `_bwd_kernel` (the backward of all three, through `_bwd_rows`):
//   scaled:   y = softmax(x * scale) over each row of x [rows, sk].
//   masked:   x [b, n, sq, sk] with a 1-byte mask read through a
//             [b, n, sq, sk] view with strides (0 where it broadcasts:
//             a [b, 1, sq, sk] mask serves every head and is never
//             materialised at the scores' shape); mask != 0 means
//             masked out. The same kernel with no mask is `scaled`.
//   causal:   x [B, sq, sk] -> y in x's dtype; for row r, i = r % sq and
//             key j is masked when j > i + (sk - sq).
//   In fp32, for every forward: x*scale, masked keys set to -10000 (not
//   -inf), subtract the row max, exp, masked keys set to 0, divide by the
//   row sum. A row with every key masked is 0 / 0 = NaN, as in the TPU
//   kernel and its oracle.
//   backward: dx = scale * y * (dy - sum(dy * y)) over each row, y, dy
//             and dx in one dtype, arithmetic in fp32.
//
// Bound on the H100: memory. Each element takes a handful of flops, far
// below the ~295 flops per byte where the tensor cores would become the
// limit. At the TinyLlama training step's causal shape (B = 2*32, sq = sk
// = 1024, fp32) the forward moves 403 MB (it reads only the unmasked
// lower triangle and writes the whole row: >= 120.2 us at 3.35 TB/s) and
// the backward 768 MB (reads y and dy, writes dx: >= 229 us). At BERT-
// large's masked shape ([64, 16, 128, 128] fp32 scores, a [64, 1, 128,
// 128] bool mask) the forward moves 134 MB of scores and 1 MB of mask
// (>= 40.4 us).
//
// Design of the scaled and masked forward (#8, #9; one body, templated
// on the mask). A row of up to 2^kRegMaxLog2 = 1024 keys lives in the
// registers of one group of lanes, with no shared memory and no block
// barrier: the row length is padded to a power of two, KEYS (template
// buckets 1 to 1024, as Apex's scaled_masked_softmax_warp_forward), and
// cut into vectors of VEC keys (16 bytes: 4 fp32 or 8 bf16; 1 on the
// scalar path). A row takes LANES = min(32, KEYS / VEC) lanes, so a short
// row shares its warp with others in groups of 2^k lanes and no lane is
// idle (BERT's 128 fp32 keys: one float4 a lane, a row a warp; in bf16
// 16 lanes a row). Lane l of a row holds vectors l, l + LANES, ...: each
// step of the group reads LANES * 16 contiguous bytes. The row max and
// sum are xor-butterflies of __shfl_xor_sync within the group (log2
// LANES steps each). Blocks are 4 warps; a row is ~0.5 KB, so an SM keeps
// 64 rows in flight with no per-row barrier or staging. Keys past sk
// (the padding) hold -inf for the exp and stay out of the max, so they
// add exactly 0 to the sum. Scores are read, and probabilities written,
// with streaming hints (ld.global.cs / st.global.cs: the 67 MB of each
// must not push the 1 MB mask, which every head re-reads, out of L2);
// the mask's VEC flags a lane are one 4- or 8-byte load where the row's
// flags start on that boundary (checked per row, so a mask view at an
// odd offset reads bytes, while the scores keep 16-byte accesses), else
// single bytes. The 16-byte path needs sk a multiple of VEC and x, y on
// 16-byte boundaries; the wrapper's plan (kernels/softmax.py `plan`)
// picks it from the shapes and data_ptr() % 16 and passes it as `path`,
// which the launcher checks. Otherwise the scalar path runs with the
// same lanes (sk = 357, offset views). Rows longer than 1024 keys (up to
// 16384) take the first design's body, one block of 256 threads a row
// staging its scaled scores in shared memory (masked_fwd_kernel). Each
// lane sums its own keys in order, then the butterfly adds the partials:
// only this order of the row sum differs from the TPU kernel's, whose
// arithmetic is kept with _rn intrinsics (x*scale, masked keys -10000
// in the max and -inf in the exp, expf(v - max), e / sum; no fast
// math). A masked key is written as 0 / sum = 0; a row with every key
// masked is 0 / 0 = NaN, as in the oracle.
//
// Design of the causal forward (#10): the same register body and launch
// plan (`plan`: VECTOR, SCALAR, or the block path past 1024 keys) in a
// sibling kernel, warp_causal_fwd, on the same load, store and butterfly
// helpers. Row r's live keys are a prefix, j < live = i + (sk - sq) + 1
// (clamped to [0, sk]), so a lane reads only the vectors that hold a live
// key: the dead tail, about half the scores at sq = sk, is never read,
// and the one vector on the diagonal is read whole and masked key by
// key. The max starts at -10000 when the row has a dead key (the
// oracle's masked value enters it); the lane skips the exp of dead
// vectors (exactly 0, so its partial sum is unchanged bit for bit); every
// vector of the row is written, each dead key as one quotient 0 / sum
// taken once a row (0, or NaN for a row with no live key). At the path
// shape that is 8 float4 a lane, 4 warps a block, a row a warp, no
// barrier. The first design, one block of 256 threads a row staging the
// live scores in shared memory with four block barriers
// (causal_fwd_kernel), stays as path 0 and serves rows of 1025 to 16384
// keys. At the path shape it reaches 0.81 of the bound above, 1.6x the
// first design (PERF.md).
//
// Design of the backward (#11): the same register rows and launch plan
// (`plan`) in a third sibling, warp_softmax_bwd. A lane group reads its
// row of y and of dy once each with 16-byte streaming loads (one key on
// the scalar path) into registers, t = sum(dy * y) is each lane's
// partial over its own keys in order (each product and add rounded,
// _rn), then group_sum's butterfly, and dx = (scale * y) * (dy - t) is
// written once with streaming stores. Padding keys past sk hold 0 for y
// and dy and add exactly 0. At BERT's 128 fp32 keys that is one float4
// of each a lane, a row a warp, 4 warps a block, no barrier. Every key is
// read, the dead keys of a causal row too: a non-finite dy on a key whose
// y is 0 gives JAX's NaN. The first design (bwd_kernel, one block of 256
// threads a row: dy * y summed in a strided loop, a block sum through
// shared memory, then y and dy read again from L1/L2 for dx; at 128 keys
// half its threads hold none) stays as path 0. The plan keeps it past
// 768 keys (kernels/softmax.py BWD_REG_MAX_KEYS): at 1024 fp32 keys, 4 a
// thread, it ran 0.4 % ahead of the register path on an H100, both at
// ~0.92 of the bound; at 128 to 768 keys the register path ran 1.16x to
// 2.1x faster (PERF.md). The C function takes the register path up to
// 1024 keys, for that comparison.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRegMaxLog2 = 10;  // the register path: sk <= 1024
constexpr int kWarps = 4;        // warps of a register-path block
constexpr float kMaskValue = -10000.f;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
  __syncthreads();  // `partial` may be reused by a following call
  return total;
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float total = partial[0];
  for (int i = 1; i < kThreads / 32; ++i) total = fmaxf(total, partial[i]);
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
causal_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int sq, int sk,
                  float scale) {
  extern __shared__ float row[];
  const size_t r = blockIdx.x;
  const int i = static_cast<int>(r % sq);
  // keys j <= i + (sk - sq) are live
  const int live = min(sk, max(0, i + (sk - sq) + 1));
  const T* xr = x + r * sk;
  T* yr = y + r * sk;
  float mx = -__int_as_float(0x7f800000);  // -inf
  for (int j = threadIdx.x; j < live; j += kThreads) {
    const float v = __fmul_rn(to_float(xr[j]), scale);
    row[j] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_max(mx);
  if (live < sk) mx = fmaxf(mx, kMaskValue);
  float sum = 0.f;
  for (int j = threadIdx.x; j < live; j += kThreads) {
    const float e = expf(__fsub_rn(row[j], mx));
    row[j] = e;
    sum += e;
  }
  sum = block_sum(sum);
  for (int j = threadIdx.x; j < sk; j += kThreads)
    yr[j] = from_float<T>(__fdiv_rn(j < live ? row[j] : 0.f, sum));
}

// mask: null (no mask) or 1-byte flags read at
// mask[bi*msb + ni*msn + i*msq + j] for row r = (bi*n + ni)*sq + i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_fwd_kernel(const T* __restrict__ x, const unsigned char* __restrict__ mask,
                  T* __restrict__ y, int n, int sq, int sk, long long msb,
                  long long msn, long long msq, float scale) {
  extern __shared__ float row[];
  const size_t r = blockIdx.x;
  const T* xr = x + r * sk;
  T* yr = y + r * sk;
  const unsigned char* mr = nullptr;
  if (mask != nullptr) {
    const long long i = static_cast<long long>(r % sq);
    const long long bn = static_cast<long long>(r / sq);
    mr = mask + (bn / n) * msb + (bn % n) * msn + i * msq;
  }
  const float neg_inf = -__int_as_float(0x7f800000);
  float mx = neg_inf;
  for (int j = threadIdx.x; j < sk; j += kThreads) {
    const float v = __fmul_rn(to_float(xr[j]), scale);
    const bool out = mr != nullptr && mr[j] != 0;
    row[j] = out ? neg_inf : v;
    mx = fmaxf(mx, out ? kMaskValue : v);
  }
  mx = block_max(mx);
  float sum = 0.f;
  for (int j = threadIdx.x; j < sk; j += kThreads) {
    const float e = expf(__fsub_rn(row[j], mx));
    row[j] = e;
    sum += e;
  }
  sum = block_sum(sum);
  for (int j = threadIdx.x; j < sk; j += kThreads)
    yr[j] = from_float<T>(__fdiv_rn(row[j], sum));
}

// Register-path accesses: N consecutive values at p (N = 1 or 16 bytes).
// Scores are read once and probabilities written once: streaming hints.
template <int N>
__device__ __forceinline__ void load_scores(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    static_assert(N == 1, "fp32: 1 or 4 keys an access");
    v[0] = __ldcs(p);
  }
}

// bf16 -> fp32 is exact: the 16 bits become the top half of the float.
template <int N>
__device__ __forceinline__ void load_scores(const __nv_bfloat16* p, float* v) {
  if constexpr (N == 8) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    static_assert(N == 1, "bf16: 1 or 8 keys an access");
    v[0] = __uint_as_float(
        static_cast<unsigned>(__ldcs(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_probs(float* p, const float* v) {
  if constexpr (N == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int N>
__device__ __forceinline__ void store_probs(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 8) {
    uint4 t;
    t.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    t.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    t.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    t.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), t);
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(bf16_bits(v[0])));
  }
}

// N mask flags at p (non-zero: masked out), read through the read-only
// cache (a broadcast mask is re-read by every head): one N-byte load when
// `whole` (p on an N-byte boundary), else N byte loads.
template <int N>
__device__ __forceinline__ void load_flags(const unsigned char* p, bool whole,
                                           bool* out) {
  if constexpr (N == 4 || N == 8) {
    if (whole) {
      unsigned w[N / 4];
      if constexpr (N == 4) {
        w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
      } else {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = t.x;
        w[1] = t.y;
      }
#pragma unroll
      for (int e = 0; e < N; ++e)
        out[e] = ((w[e / 4] >> (8 * (e % 4))) & 0xffu) != 0;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = __ldg(p + e) != 0;
}

// The row max and sum over a group of kLanes lanes (a power of two <= 32,
// aligned in the warp): xor butterflies, every lane of the group ends with
// the same value. group_sum stops before the step of offset kStop (a
// planted fault passes 1: the last step skipped).
template <int kLanes>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int kLanes, int kStop = 0>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > kStop; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The register path: rows of sk <= 2^kLog2Keys keys, each held by a group
// of kLanes lanes (see the header note). kVector: 16-byte accesses (sk a
// multiple of the vector, x and y 16-byte aligned), else one key an
// access. kHasMask false: no mask is read (the scaled softmax, #8). The
// mask arguments are as masked_fwd_kernel's.
template <typename T, int kLog2Keys, bool kVector, bool kHasMask>
__global__ void __launch_bounds__(kWarps * 32)
warp_softmax_fwd(const T* __restrict__ x, const unsigned char* __restrict__ mask,
                 T* __restrict__ y, long long rows, int n, int sq, int sk,
                 long long msb, long long msn, long long msq, float scale) {
  constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kKeys = 1 << kLog2Keys;
  static_assert(kKeys >= kVec, "a row holds at least one vector");
  constexpr int kVecs = kKeys / kVec;
  constexpr int kLanes = kVecs < 32 ? kVecs : 32;
  constexpr int kIters = kVecs / kLanes;
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  if (row0 >= rows) return;  // the whole warp: no shuffle is left waiting
  const long long r = row0 + lane / kLanes;
  const bool live_row = r < rows;  // a warp's last group may hold no row
  const T* xr = x + r * sk;
  T* yr = y + r * sk;
  const unsigned char* mr = nullptr;
  bool whole_flags = false;
  if constexpr (kHasMask) {
    const long long i = r % sq;
    const long long bn = r / sq;
    mr = mask + (bn / n) * msb + (bn % n) * msn + i * msq;
    whole_flags = (reinterpret_cast<uintptr_t>(mr) % kVec) == 0;
  }
  const float neg_inf = -__int_as_float(0x7f800000);
  float v[kIters][kVec];
  float mx = neg_inf;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * kLanes + sub) * kVec;  // the vector's first key
    if (live_row && j < sk) {
      load_scores<kVec>(xr + j, v[it]);
      bool out[kVec];
      if constexpr (kHasMask) load_flags<kVec>(mr + j, whole_flags, out);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float s = __fmul_rn(v[it][e], scale);
        if constexpr (kHasMask) {
          v[it][e] = out[e] ? neg_inf : s;
          mx = fmaxf(mx, out[e] ? kMaskValue : s);
        } else {
          v[it][e] = s;
          mx = fmaxf(mx, s);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[it][e] = neg_inf;
    }
  }
  mx = group_max<kLanes>(mx);
  float sum = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      v[it][e] = expf(__fsub_rn(v[it][e], mx));
      sum = __fadd_rn(sum, v[it][e]);
    }
  }
  sum = group_sum<kLanes>(sum);
  if (!live_row) return;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * kLanes + sub) * kVec;
    if (j < sk) {
      float p[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) p[e] = __fdiv_rn(v[it][e], sum);
      store_probs<kVec>(yr + j, p);
    }
  }
}

// Planted faults of the causal register path (launch paths 3 and 4; no
// caller passes them): the diagonal key dropped (live one short), the
// row sum's last butterfly step skipped.
constexpr int kNoFault = 0;
constexpr int kDropDiagonal = 1;
constexpr int kShortSum = 2;

// The causal forward's register path (#10): rows of sk <= 2^kLog2Keys
// keys as warp_softmax_fwd holds them, key j of row r live when j < live
// = clamp(r % sq + (sk - sq) + 1, 0, sk). A lane reads only the vectors
// that hold a live key: a wholly dead vector is never read and holds -inf
// (exp gives exactly 0, which the lane does not add: the sum is the same
// bit for bit); the one vector that straddles the diagonal is read whole
// and masked per key. The max starts at -10000 when the row has a dead
// key (the oracle's masked value enters its max). Every vector of the row
// is written with 16-byte streaming stores (one key on the scalar path);
// a dead key is 0 / sum, 0, or NaN for a row with no live key (0 / 0).
template <typename T, int kLog2Keys, bool kVector, int kFault>
__global__ void __launch_bounds__(kWarps * 32)
warp_causal_fwd(const T* __restrict__ x, T* __restrict__ y, long long rows,
                int sq, int sk, float scale) {
  constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kKeys = 1 << kLog2Keys;
  static_assert(kKeys >= kVec, "a row holds at least one vector");
  constexpr int kVecs = kKeys / kVec;
  constexpr int kLanes = kVecs < 32 ? kVecs : 32;
  constexpr int kIters = kVecs / kLanes;
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  if (row0 >= rows) return;  // the whole warp: no shuffle is left waiting
  const long long r = row0 + lane / kLanes;
  const bool live_row = r < rows;  // a warp's last group may hold no row
  const T* xr = x + r * sk;
  T* yr = y + r * sk;
  int live = 0;
  if (live_row) {
    const int i = static_cast<int>(r % sq);
    live = min(sk, max(0, i + (sk - sq) + 1 - (kFault == kDropDiagonal)));
  }
  const float neg_inf = -__int_as_float(0x7f800000);
  float v[kIters][kVec];
  float mx = live < sk ? kMaskValue : neg_inf;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * kLanes + sub) * kVec;  // the vector's first key
    if (j < live) {
      load_scores<kVec>(xr + j, v[it]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[it][e] = j + e < live ? __fmul_rn(v[it][e], scale) : neg_inf;
        mx = fmaxf(mx, v[it][e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[it][e] = neg_inf;
    }
  }
  mx = group_max<kLanes>(mx);
  float sum = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    if ((it * kLanes + sub) * kVec < live) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[it][e] = expf(__fsub_rn(v[it][e], mx));
        sum = __fadd_rn(sum, v[it][e]);
      }
    }
  }
  sum = group_sum<kLanes, kFault == kShortSum ? 1 : 0>(sum);
  if (!live_row) return;
  const float dead = __fdiv_rn(0.f, sum);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * kLanes + sub) * kVec;
    if (j < sk) {
      float p[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        p[e] = j < live ? __fdiv_rn(v[it][e], sum) : dead;
      store_probs<kVec>(yr + j, p);
    }
  }
}

// Planted faults of the backward's register path (launch paths 3 and 4;
// no caller passes them): the butterfly's last step skipped; dy read one
// key ahead (key by key, past the row's end on the last key).
constexpr int kBwdShortSum = 1;
constexpr int kBwdDyAhead = 2;
constexpr int kBwdFaultLog2 = 7;  // the faults' rows: BERT's 128 keys

// The backward's register path (#11): rows of sk <= 2^kLog2Keys keys as
// warp_softmax_fwd holds them, y and dy read once each into registers;
// dx = (scale * y) * (dy - t), t = sum(dy * y) over the row (lane
// partials in order, then the group's butterfly). Keys past sk hold 0.
template <typename T, int kLog2Keys, bool kVector, int kFault>
__global__ void __launch_bounds__(kWarps * 32)
warp_softmax_bwd(const T* __restrict__ y, const T* __restrict__ dy,
                 T* __restrict__ dx, long long rows, int sk, float scale) {
  constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kKeys = 1 << kLog2Keys;
  static_assert(kKeys >= kVec, "a row holds at least one vector");
  constexpr int kVecs = kKeys / kVec;
  constexpr int kLanes = kVecs < 32 ? kVecs : 32;
  constexpr int kIters = kVecs / kLanes;
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  if (row0 >= rows) return;  // the whole warp: no shuffle is left waiting
  const long long r = row0 + lane / kLanes;
  const bool live_row = r < rows;  // a warp's last group may hold no row
  const T* yr = y + r * sk;
  const T* dyr = dy + r * sk;
  T* dxr = dx + r * sk;
  float yv[kIters][kVec], gv[kIters][kVec];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * kLanes + sub) * kVec;  // the vector's first key
    if (live_row && j < sk) {
      load_scores<kVec>(yr + j, yv[it]);
      if constexpr (kFault == kBwdDyAhead) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) gv[it][e] = to_float(dyr[j + e + 1]);
      } else {
        load_scores<kVec>(dyr + j, gv[it]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) yv[it][e] = gv[it][e] = 0.f;
    }
  }
  float t = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      t = __fadd_rn(t, __fmul_rn(gv[it][e], yv[it][e]));
  }
  t = group_sum<kLanes, kFault == kBwdShortSum ? 1 : 0>(t);
  if (!live_row) return;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = (it * kLanes + sub) * kVec;
    if (j < sk) {
      float d[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = __fmul_rn(__fmul_rn(scale, yv[it][e]),
                         __fsub_rn(gv[it][e], t));
      store_probs<kVec>(dxr + j, d);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
           T* __restrict__ dx, int sk, float scale) {
  const size_t r = blockIdx.x;
  const T* yr = y + r * sk;
  const T* dyr = dy + r * sk;
  T* dxr = dx + r * sk;
  float t = 0.f;
  for (int j = threadIdx.x; j < sk; j += kThreads)
    t += to_float(dyr[j]) * to_float(yr[j]);
  t = block_sum(t);
  for (int j = threadIdx.x; j < sk; j += kThreads) {
    const float yv = to_float(yr[j]);
    dxr[j] = from_float<T>(
        __fmul_rn(__fmul_rn(scale, yv), __fsub_rn(to_float(dyr[j]), t)));
  }
}

template <typename T>
int launch_fwd(const void* x, void* y, long long rows, int sq, int sk,
               float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(sk) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        causal_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  causal_fwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kLog2Keys, bool kVector, int kFault>
int launch_causal_rows(const void* x, void* y, long long rows, int sq, int sk,
                       float scale, cudaStream_t stream) {
  constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kVecs = (1 << kLog2Keys) / kVec;
  constexpr long long kRowsPerBlock = kWarps * (kVecs < 32 ? 32 / kVecs : 1);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  warp_causal_fwd<T, kLog2Keys, kVector, kFault>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), rows, sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

// The causal register path's instance for rows padded to 2^log2 keys.
template <typename T, bool kVector, int kLog2 = 0>
int dispatch_causal_rows(int log2, const void* x, void* y, long long rows,
                         int sq, int sk, float scale, cudaStream_t stream) {
  if constexpr (kLog2 > kRegMaxLog2) {
    return -1;
  } else {
    constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
    if constexpr ((1 << kLog2) >= kVec) {
      if (log2 == kLog2)
        return launch_causal_rows<T, kLog2, kVector, kNoFault>(
            x, y, rows, sq, sk, scale, stream);
    }
    return dispatch_causal_rows<T, kVector, kLog2 + 1>(log2, x, y, rows, sq,
                                                       sk, scale, stream);
  }
}

// path: 0 = one block a row (causal_fwd_kernel, the first design, any sk),
// 1 = the register path with one key an access, 2 = the register path
// with 16-byte accesses, 3 and 4 = path 2 with a planted fault (the
// diagonal key dropped; the row sum's last butterfly step skipped), for
// rows of 513 to 1024 keys only. -1 where the arguments do not fit the
// path.
template <typename T>
int launch_causal_path(int path, const void* x, void* y, long long rows,
                       int sq, int sk, float scale, cudaStream_t stream) {
  if (path == 0) return launch_fwd<T>(x, y, rows, sq, sk, scale, stream);
  if (path < 1 || path > 4) return -1;
  int log2 = 0;
  while ((1 << log2) < sk) ++log2;
  if (log2 > kRegMaxLog2) return -1;
  if (path != 1) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if (sk % kVec != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0)
      return -1;
  }
  if (path == 1)
    return dispatch_causal_rows<T, false>(log2, x, y, rows, sq, sk, scale,
                                          stream);
  if (path == 2)
    return dispatch_causal_rows<T, true>(log2, x, y, rows, sq, sk, scale,
                                         stream);
  if (log2 != kRegMaxLog2) return -1;
  if (path == 3)
    return launch_causal_rows<T, kRegMaxLog2, true, kDropDiagonal>(
        x, y, rows, sq, sk, scale, stream);
  return launch_causal_rows<T, kRegMaxLog2, true, kShortSum>(
      x, y, rows, sq, sk, scale, stream);
}

template <typename T>
int launch_masked(const void* x, const void* mask, void* y, long long rows,
                  int n, int sq, int sk, long long msb, long long msn,
                  long long msq, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(sk) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_fwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(mask),
      static_cast<T*>(y), n, sq, sk, msb, msn, msq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kLog2Keys, bool kVector, bool kHasMask>
int launch_warp_rows(const void* x, const void* mask, void* y, long long rows,
                     int n, int sq, int sk, long long msb, long long msn,
                     long long msq, float scale, cudaStream_t stream) {
  constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kVecs = (1 << kLog2Keys) / kVec;
  constexpr long long kRowsPerBlock = kWarps * (kVecs < 32 ? 32 / kVecs : 1);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  warp_softmax_fwd<T, kLog2Keys, kVector, kHasMask>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const unsigned char*>(mask),
          static_cast<T*>(y), rows, n, sq, sk, msb, msn, msq, scale);
  return static_cast<int>(cudaGetLastError());
}

// The register path's instance for rows padded to 2^log2 keys.
template <typename T, bool kVector, bool kHasMask, int kLog2 = 0>
int dispatch_warp_rows(int log2, const void* x, const void* mask, void* y,
                       long long rows, int n, int sq, int sk, long long msb,
                       long long msn, long long msq, float scale,
                       cudaStream_t stream) {
  if constexpr (kLog2 > kRegMaxLog2) {
    return -1;
  } else {
    constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
    if constexpr ((1 << kLog2) >= kVec) {
      if (log2 == kLog2)
        return launch_warp_rows<T, kLog2, kVector, kHasMask>(
            x, mask, y, rows, n, sq, sk, msb, msn, msq, scale, stream);
    }
    return dispatch_warp_rows<T, kVector, kHasMask, kLog2 + 1>(
        log2, x, mask, y, rows, n, sq, sk, msb, msn, msq, scale, stream);
  }
}

// path: 0 = one block a row (masked_fwd_kernel, any sk), 1 = the register
// path with one key an access, 2 = the register path with 16-byte
// accesses. -1 where the arguments do not fit the path.
template <typename T>
int launch_masked_path(int path, const void* x, const void* mask, void* y,
                       long long rows, int n, int sq, int sk, long long msb,
                       long long msn, long long msq, float scale,
                       cudaStream_t stream) {
  if (path == 0)
    return launch_masked<T>(x, mask, y, rows, n, sq, sk, msb, msn, msq, scale,
                            stream);
  if (path != 1 && path != 2) return -1;
  int log2 = 0;
  while ((1 << log2) < sk) ++log2;
  if (log2 > kRegMaxLog2) return -1;
  if (path == 2) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if (sk % kVec != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0)
      return -1;
    if (mask == nullptr)
      return dispatch_warp_rows<T, true, false>(log2, x, mask, y, rows, n, sq,
                                                sk, msb, msn, msq, scale, stream);
    return dispatch_warp_rows<T, true, true>(log2, x, mask, y, rows, n, sq, sk,
                                             msb, msn, msq, scale, stream);
  }
  if (mask == nullptr)
    return dispatch_warp_rows<T, false, false>(log2, x, mask, y, rows, n, sq, sk,
                                               msb, msn, msq, scale, stream);
  return dispatch_warp_rows<T, false, true>(log2, x, mask, y, rows, n, sq, sk,
                                            msb, msn, msq, scale, stream);
}

template <typename T>
int launch_bwd(const void* y, const void* dy, void* dx, long long rows,
               int sk, float scale, cudaStream_t stream) {
  bwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy),
      static_cast<T*>(dx), sk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kLog2Keys, bool kVector, int kFault>
int launch_bwd_rows(const void* y, const void* dy, void* dx, long long rows,
                    int sk, float scale, cudaStream_t stream) {
  constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kVecs = (1 << kLog2Keys) / kVec;
  constexpr long long kRowsPerBlock = kWarps * (kVecs < 32 ? 32 / kVecs : 1);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  warp_softmax_bwd<T, kLog2Keys, kVector, kFault>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
          static_cast<const T*>(y), static_cast<const T*>(dy),
          static_cast<T*>(dx), rows, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward's register path instance for rows padded to 2^log2 keys.
template <typename T, bool kVector, int kLog2 = 0>
int dispatch_bwd_rows(int log2, const void* y, const void* dy, void* dx,
                      long long rows, int sk, float scale,
                      cudaStream_t stream) {
  if constexpr (kLog2 > kRegMaxLog2) {
    return -1;
  } else {
    constexpr int kVec = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
    if constexpr ((1 << kLog2) >= kVec) {
      if (log2 == kLog2)
        return launch_bwd_rows<T, kLog2, kVector, kNoFault>(
            y, dy, dx, rows, sk, scale, stream);
    }
    return dispatch_bwd_rows<T, kVector, kLog2 + 1>(log2, y, dy, dx, rows, sk,
                                                    scale, stream);
  }
}

// path: 0 = one block a row (bwd_kernel, the first design, any sk), 1 =
// the register path with one key an access, 2 = the register path with
// 16-byte accesses (y, dy and dx on 16-byte boundaries), 3 and 4 = path
// 2 with a planted fault (the butterfly's last step skipped; dy read one
// key ahead), for rows of 65 to 128 keys only. -1 where the arguments do
// not fit the path.
template <typename T>
int launch_bwd_path(int path, const void* y, const void* dy, void* dx,
                    long long rows, int sk, float scale,
                    cudaStream_t stream) {
  if (path == 0) return launch_bwd<T>(y, dy, dx, rows, sk, scale, stream);
  if (path < 1 || path > 4) return -1;
  int log2 = 0;
  while ((1 << log2) < sk) ++log2;
  if (log2 > kRegMaxLog2) return -1;
  if (path != 1) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if (sk % kVec != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dx) % 16 != 0)
      return -1;
  }
  if (path == 1)
    return dispatch_bwd_rows<T, false>(log2, y, dy, dx, rows, sk, scale,
                                       stream);
  if (path == 2)
    return dispatch_bwd_rows<T, true>(log2, y, dy, dx, rows, sk, scale,
                                      stream);
  if (log2 != kBwdFaultLog2) return -1;
  if (path == 3)
    return launch_bwd_rows<T, kBwdFaultLog2, true, kBwdShortSum>(
        y, dy, dx, rows, sk, scale, stream);
  return launch_bwd_rows<T, kBwdFaultLog2, true, kBwdDyAhead>(
      y, dy, dx, rows, sk, scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each returns the CUDA error of
// the launch (0 on success); -1 for a dtype the kernel does not take.

// y [rows, sk] = causal softmax of x [rows, sk], rows = B * sq. path: as
// launch_causal_path (kernels/softmax.py `plan` picks 0, 1 or 2).
extern "C" int apex_causal_softmax_fwd(const void* x, void* y, long long rows,
                                       int sq, int sk, float scale,
                                       int dtype, int path, void* stream) {
  if (rows <= 0) return 0;
  if (sq < 1 || sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_causal_path<float>(path, x, y, rows, sq, sk, scale, s);
  if (dtype == 1)
    return launch_causal_path<__nv_bfloat16>(path, x, y, rows, sq, sk, scale,
                                             s);
  return -1;
}

// y [rows, sk] = softmax of x [rows, sk] * scale with the keys the mask
// flags set to -10000, rows = b * n * sq; mask null: no key is masked
// (n, sq and the strides are not read). path: as launch_masked_path
// (kernels/softmax.py `plan` picks it).
extern "C" int apex_masked_softmax_fwd(const void* x, const void* mask,
                                       void* y, long long rows, int n, int sq,
                                       int sk, long long msb, long long msn,
                                       long long msq, float scale, int dtype,
                                       int path, void* stream) {
  if (rows <= 0) return 0;
  if (sk < 1 || (mask != nullptr && (n < 1 || sq < 1))) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_masked_path<float>(path, x, mask, y, rows, n, sq, sk, msb,
                                     msn, msq, scale, s);
  if (dtype == 1)
    return launch_masked_path<__nv_bfloat16>(path, x, mask, y, rows, n, sq, sk,
                                             msb, msn, msq, scale, s);
  return -1;
}

// dx [rows, sk] = scale * y * (dy - rowsum(dy * y)). path: as
// launch_bwd_path (kernels/softmax.py `plan` picks 0, 1 or 2).
extern "C" int apex_softmax_bwd(const void* y, const void* dy, void* dx,
                                long long rows, int sk, float scale,
                                int dtype, int path, void* stream) {
  if (rows <= 0) return 0;
  if (sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_path<float>(path, y, dy, dx, rows, sk, scale, s);
  if (dtype == 1)
    return launch_bwd_path<__nv_bfloat16>(path, y, dy, dx, rows, sk, scale,
                                          s);
  return -1;
}
