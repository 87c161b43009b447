// Shared pieces of the attention kernels (flash_attention_{fwd,bwd}.cu,
// dilated_attention_{fwd,bwd}.cu, alibi_attention_{fwd,bwd}.cu): tile
// geometry, the forward's shared-memory plan, dtype conversion, the
// online-softmax update of a group of query rows, the 2-D ALiBi score term,
// and the LongNet branch geometry.
//
// A block owns kBlockQ query rows. Their softmax state lives in shared
// memory (running max m, running sum l, fp32 accumulator acc[row][d]) so
// that any subset of the rows can be updated against any key tile: the
// dilated kernel updates a different subset of rows for every branch.
// One warp updates kRowsPerWarp rows against one key tile at a time, so
// that every k and v element it reads from shared memory serves four rows:
// for q.k the lanes split the keys, for p.V they split the (row, head
// dimension) pairs, 8 lanes per row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace mt {

constexpr float kNegInf = -1e9f;          // NEG_INF of the Python side
constexpr float kMaskThreshold = -5e8f;   // a key with bias <= NEG_INF/2 is masked
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 64;               // query rows per block
constexpr int kBlockK = 64;               // keys per shared-memory tile
constexpr int kKeysPerLane = kBlockK / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kLanesPerRow = 32 / kRowsPerWarp;
constexpr int kPStride = kBlockK + 1;     // p rows of a warp on distinct banks

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory plan, in floats, for a padded head dimension DP (a multiple
// of 16, so each of a row's 8 p.V lanes owns an even number of dimensions).
// q and k rows are padded by 4 floats: float4 reads of k[lane + 32c][...]
// then fall on distinct banks within each 8-lane phase.
template <int DP>
struct Plan {
  static constexpr int QS = DP + 4;
  static constexpr int KS = DP + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kBlockQ * QS;
  static constexpr int v_off = k_off + kBlockK * KS;
  static constexpr int acc_off = v_off + kBlockK * DP;
  static constexpr int p_off = acc_off + kBlockQ * DP;
  static constexpr int m_off = p_off + kWarps * kRowsPerWarp * kPStride;
  static constexpr int l_off = m_off + kBlockQ;
  static constexpr int bias_off = l_off + kBlockQ;
  static constexpr int floats = bias_off + kBlockK;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int DP>
struct Tiles {
  float* q;     // [kBlockQ][QS], pre-multiplied by the softmax scale
  float* k;     // [kBlockK][KS]
  float* v;     // [kBlockK][DP]
  float* acc;   // [kBlockQ][DP]
  float* p;     // [kWarps][kRowsPerWarp][kPStride]
  float* m;     // [kBlockQ]
  float* l;     // [kBlockQ]
  float* bias;  // [kBlockK] additive key bias; <= kMaskThreshold masks the key

  __device__ explicit Tiles(float* s)
      : q(s + Plan<DP>::q_off), k(s + Plan<DP>::k_off), v(s + Plan<DP>::v_off),
        acc(s + Plan<DP>::acc_off), p(s + Plan<DP>::p_off), m(s + Plan<DP>::m_off),
        l(s + Plan<DP>::l_off), bias(s + Plan<DP>::bias_off) {}

  // Zero the accumulator, start every row's max at NEG_INF and sum at 0.
  __device__ void init_state() {
    for (int i = threadIdx.x; i < kBlockQ * DP; i += kThreads) acc[i] = 0.f;
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
  }
};

// Load `n` rows of a (.., D) tensor into a padded fp32 tile, scaled by
// `scale`; row i starts at base + row_offset(i). Padding columns and rows
// past n are zero.
template <int DP, int ROWS, int STRIDE, typename T, typename RowOffset>
__device__ __forceinline__ void load_rows(float* dst, const T* base, int n, int D, float scale,
                                          RowOffset row_offset) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, d = i - r * DP;
    float x = 0.f;
    if (r < n && d < D) x = to_float<T>(base[row_offset(r) + d]) * scale;
    dst[r * STRIDE + d] = x;
  }
}

// The score of a (query row, key) pair of the current tiles may carry one
// more additive term than the key bias: term(row, j), with both indices
// local to their tiles. Plain attention has none.
struct NoTerm {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// The 2-D ALiBi term of the TITAN attention (alibi_attention_{fwd,bwd}.cu):
//   -slope * ||c_i - c_j||_2 * (1 - cls_i) * (1 - cls_j).
// qc and kc are [3][64] planes in shared memory: row, column, and the factor
// of the pair's weight that the side owns (slope * (1 - cls) for the
// queries, 1 - cls for the keys). The distance is taken directly, not as
// |c_i|^2 + |c_j|^2 - 2 c_i.c_j: no cancellation for any coordinates.
struct AlibiTerm {
  const float* qc;
  const float* kc;
  __device__ __forceinline__ float operator()(int qi, int kj) const {
    const float dy = qc[qi] - kc[kj];
    const float dx = qc[kBlockQ + qi] - kc[kBlockK + kj];
    return -(qc[2 * kBlockQ + qi] * kc[2 * kBlockK + kj]) * sqrtf(dy * dy + dx * dx);
  }
};

// Load the coordinate planes of `n` tokens starting at token t0 of a
// (N, 3) [row, col, is_cls] array; the third plane is w * (1 - is_cls).
// Rows past n get coordinates 0 and weight 0.
__device__ __forceinline__ void load_coords(float* plane, const float* coords, int t0, int n,
                                            float w) {
  static_assert(kBlockQ == kBlockK, "one plane stride serves either side");
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    const float* c = coords + static_cast<size_t>(t0 + i) * 3;
    plane[i] = i < n ? c[0] : 0.f;
    plane[kBlockQ + i] = i < n ? c[1] : 0.f;
    plane[2 * kBlockQ + i] = i < n ? w * (1.f - c[2]) : 0.f;
  }
}

// Fold keys [0, nk) of the current tile into the query rows
// row0 + stride * i, i < nr <= kRowsPerWarp: the flash-attention
// online-softmax update, executed by one warp.
// A masked key gets exactly zero weight even when the whole tile is masked:
// its score is -inf, while the running max never drops below NEG_INF.
template <int DP, typename Term = NoTerm>
__device__ __forceinline__ void fold_rows(const Tiles<DP>& t, int row0, int stride, int nr,
                                          int nk, int warp, int lane, Term term = Term()) {
  constexpr int QS = Plan<DP>::QS, KS = Plan<DP>::KS;
  constexpr int R = kRowsPerWarp;
  int rows[R];
#pragma unroll
  for (int i = 0; i < R; ++i) rows[i] = row0 + stride * (i < nr ? i : 0);

  // scores: lane owns keys lane + 32c for every row
  float s[R][kKeysPerLane];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) s[i][c] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < DP / 4; ++d4) {
    float4 kv[kKeysPerLane];
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c)
      kv[c] = reinterpret_cast<const float4*>(t.k + (lane + 32 * c) * KS)[d4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 qa = reinterpret_cast<const float4*>(t.q + rows[i] * QS)[d4];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        s[i][c] = fmaf(qa.x, kv[c].x, s[i][c]);
        s[i][c] = fmaf(qa.y, kv[c].y, s[i][c]);
        s[i][c] = fmaf(qa.z, kv[c].z, s[i][c]);
        s[i][c] = fmaf(qa.w, kv[c].w, s[i][c]);
      }
    }
  }

  float* p = t.p + warp * R * kPStride;
  float corr[R], psum[R], m_new[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = lane + 32 * c;
      s[i][c] = (j < nk && t.bias[j] > kMaskThreshold) ? s[i][c] + t.bias[j] + term(rows[i], j)
                                                       : -INFINITY;
      tmax = fmaxf(tmax, s[i][c]);
    }
    const float m_old = t.m[rows[i]];
    m_new[i] = fmaxf(m_old, warp_max(tmax));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const float e = __expf(s[i][c] - m_new[i]);  // exp(-inf) == 0 for masked keys
      p[i * kPStride + lane + 32 * c] = e;
      sum += e;
    }
    psum[i] = warp_sum(sum);
    corr[i] = __expf(m_old - m_new[i]);
  }
  __syncwarp();

  // p.V: lane owns row lane / 8 and dimensions [(lane % 8) * ND, + ND)
  constexpr int ND = DP / kLanesPerRow;
  const int i = lane / kLanesPerRow;
  const int d0 = (lane % kLanesPerRow) * ND;
  if (i < nr) {
    float c = corr[0];
#pragma unroll
    for (int r = 1; r < R; ++r) c = i == r ? corr[r] : c;
    float* acc = t.acc + (row0 + stride * i) * DP + d0;
    float a[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) a[e] = acc[e] * c;
    const float* pi = p + i * kPStride;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float pj = pi[j];
      const float2* v2 = reinterpret_cast<const float2*>(t.v + j * DP + d0);
#pragma unroll
      for (int e = 0; e < ND / 2; ++e) {
        const float2 vv = v2[e];
        a[2 * e] = fmaf(pj, vv.x, a[2 * e]);
        a[2 * e + 1] = fmaf(pj, vv.y, a[2 * e + 1]);
      }
    }
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[e] = a[e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        t.m[rows[r]] = m_new[r];
        t.l[rows[r]] = t.l[rows[r]] * corr[r] + psum[r];
      }
    }
  }
  __syncwarp();
}

// LongNet branches (segment length w, dilation ratio r), passed by value.
constexpr int kMaxBranches = 8;

struct Branches {
  int n;
  int seg[kMaxBranches];
  int ratio[kMaxBranches];
};

__device__ __forceinline__ int ceil_div_nonneg(int a, int b) { return a <= 0 ? 0 : (a + b - 1) / b; }

// Head group of head h in a branch of ratio r: heads are padded to a
// multiple of r and split into r groups of round_up(H, r) / r heads.
__device__ __forceinline__ int head_group(int h, int H, int r) { return h / ((H + r - 1) / r); }

// Branch geometry, shared by the forward and both backward kernels. With
// sl = min(w, L), segment s covers positions [s*sl, min((s+1)*sl, L)); a
// position at segment offset o takes part in head group g's attention iff
// o % r == g, and it meets exactly the positions of its segment in the same
// residue class. The relation is symmetric, so a block that owns the
// positions [p0, p0 + n) finds its partners the same way whether it owns
// queries or keys. For every segment with own positions taking part, calls
//   f(row0, n_rows, first, n_partners):
// the own rows are row0 + r*i (i < n_rows) relative to p0, and the
// segment's partners are the positions first + r*j (j < n_partners).
template <typename F>
__device__ __forceinline__ void for_each_segment(int p0, int n, int L, int sl, int r, int g, F f) {
  for (int seg = p0 / sl; seg <= (p0 + n - 1) / sl; ++seg) {
    const int s0 = seg * sl, s1 = min(s0 + sl, L);
    const int u_lo = ceil_div_nonneg(max(p0, s0) - s0 - g, r);
    const int u_hi = ceil_div_nonneg(min(p0 + n, s1) - s0 - g, r);
    if (u_hi <= u_lo) continue;
    f(s0 + g + r * u_lo - p0, u_hi - u_lo, s0 + g, ceil_div_nonneg(s1 - s0 - g, r));
  }
}

// Smallest padded head dimension with a compiled kernel, or -1.
inline int padded_head_dim(int D) {
  if (D < 1) return -1;
  if (D <= 16) return 16;
  if (D <= 32) return 32;
  if (D <= 48) return 48;
  if (D <= 64) return 64;
  if (D <= 128) return 128;
  return -1;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mt
