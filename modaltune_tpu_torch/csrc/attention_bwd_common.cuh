// Shared pieces of the two backward attention kernels (flash_attention_bwd.cu,
// dilated_attention_bwd.cu): the shared-memory plan and the gradient update
// of a group of "own" rows against a tile of "other" rows.
//
// Both backwards run as two kernels that need no atomics: a dq kernel whose
// block owns 64 query rows and streams their keys, and a dk/dv kernel whose
// block owns 64 key rows and streams their queries. For a query row i and a
// key j, with w_i the row's weight in the branch mix (1 for plain attention)
// and lse_i, delta_i = rowsum(dO_i * o_i) from the forward:
//   P_ij  = exp(q_i.k_j * scale + bias_j - lse_i)     (0 for a masked key)
//   dS_ij = P_ij * (w_i * dmix_i.v_j - delta_i)
//   dq_i += dS_ij k_j * scale,  dk_j += dS_ij q_i * scale,  dv_j += P_ij w_i dmix_i
// A row whose keys are all masked (lse <= NEG_INF/2) is loaded with
// +|NEG_INF/2| in lse's place, so its P underflows to 0; exp never sees a
// large positive argument.
//
// Inner products run on CUDA cores in fp32, with the forward's layout: a warp
// updates four own rows against a 64-row other tile, lanes over the other
// rows for the two dot products (q.k and dmix.v), then lanes over (own row,
// head dimension) to accumulate.
#pragma once

#include "attention_common.cuh"

namespace mt {

// Shared-memory plan in floats. a1/a2: own rows (q*scale and dmix for dq;
// k and v for dk/dv); b1/b2: other rows (k and v; q*scale and dmix);
// acc1 (dq or dv) and, for dk/dv (DUAL), acc2 (dk); buf1/buf2: a warp's
// P or dS for four rows; lse/w/delta: per query row of the tile that holds
// queries; bias: per key row of the tile that holds keys.
template <int DP, bool DUAL>
struct BwdPlan {
  static constexpr int S = DP + 4;  // row stride: float4 reads on distinct banks
  static constexpr int a1_off = 0;
  static constexpr int a2_off = a1_off + kBlockQ * S;
  static constexpr int b1_off = a2_off + kBlockQ * S;
  static constexpr int b2_off = b1_off + kBlockK * S;
  static constexpr int acc1_off = b2_off + kBlockK * S;
  static constexpr int acc2_off = acc1_off + kBlockQ * DP;
  static constexpr int buf1_off = acc2_off + (DUAL ? kBlockQ * DP : 0);
  static constexpr int buf2_off = buf1_off + kWarps * kRowsPerWarp * kPStride;
  static constexpr int lse_off = buf2_off + (DUAL ? kWarps * kRowsPerWarp * kPStride : 0);
  static constexpr int w_off = lse_off + kBlockK;
  static constexpr int delta_off = w_off + kBlockK;
  static constexpr int bias_off = delta_off + kBlockK;
  static constexpr int floats = bias_off + kBlockK;
  static constexpr size_t bytes = sizeof(float) * floats;
  static_assert(kBlockQ == kBlockK, "per-row arrays serve either side");
  static_assert(bytes <= 232448, "over the H100's shared memory per block");
};

template <int DP, bool DUAL>
struct BwdTiles {
  using P = BwdPlan<DP, DUAL>;
  float *a1, *a2, *b1, *b2, *acc1, *acc2, *buf1, *buf2, *lse, *w, *delta, *bias;

  __device__ explicit BwdTiles(float* s)
      : a1(s + P::a1_off), a2(s + P::a2_off), b1(s + P::b1_off), b2(s + P::b2_off),
        acc1(s + P::acc1_off), acc2(s + P::acc2_off), buf1(s + P::buf1_off),
        buf2(s + P::buf2_off), lse(s + P::lse_off), w(s + P::w_off), delta(s + P::delta_off),
        bias(s + P::bias_off) {}

  __device__ void zero_acc() {
    for (int i = threadIdx.x; i < kBlockQ * DP * (DUAL ? 2 : 1); i += kThreads) acc1[i] = 0.f;
  }
};

// lse as the backward uses it: +|NEG_INF/2| for a row without a valid key.
__device__ __forceinline__ float lse_for_bwd(float lse) {
  return lse > kMaskThreshold ? lse : -kMaskThreshold;
}

// One warp: own rows row0 + stride * i (i < nr <= kRowsPerWarp) against the
// other rows [0, no) of the current tile. KEYS_OWN = false: the own rows are
// queries, acc1 += dS k. KEYS_OWN = true: the own rows are keys,
// acc1 += P w dmix (dv) and acc2 += dS q*scale (dk).
// `term(query, key)` is one more additive term of the score (see NoTerm).
template <int DP, bool KEYS_OWN, typename Term = NoTerm>
__device__ __forceinline__ void bwd_fold(const BwdTiles<DP, KEYS_OWN>& t, int row0, int stride,
                                         int nr, int no, int warp, int lane,
                                         Term term = Term()) {
  constexpr int S = BwdPlan<DP, KEYS_OWN>::S;
  constexpr int R = kRowsPerWarp;
  constexpr int C = kKeysPerLane;
  int rows[R];
#pragma unroll
  for (int i = 0; i < R; ++i) rows[i] = row0 + stride * (i < nr ? i : 0);

  // x = a1.b1 (the score before bias), y = a2.b2 (dmix.v); lane owns other
  // rows lane + 32c
  float x[R][C], y[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) x[i][c] = y[i][c] = 0.f;
#pragma unroll 2
  for (int d4 = 0; d4 < DP / 4; ++d4) {
    float4 b1v[C], b2v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      b1v[c] = reinterpret_cast<const float4*>(t.b1 + (lane + 32 * c) * S)[d4];
      b2v[c] = reinterpret_cast<const float4*>(t.b2 + (lane + 32 * c) * S)[d4];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 a1v = reinterpret_cast<const float4*>(t.a1 + rows[i] * S)[d4];
      const float4 a2v = reinterpret_cast<const float4*>(t.a2 + rows[i] * S)[d4];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        x[i][c] = fmaf(a1v.x, b1v[c].x, x[i][c]);
        x[i][c] = fmaf(a1v.y, b1v[c].y, x[i][c]);
        x[i][c] = fmaf(a1v.z, b1v[c].z, x[i][c]);
        x[i][c] = fmaf(a1v.w, b1v[c].w, x[i][c]);
        y[i][c] = fmaf(a2v.x, b2v[c].x, y[i][c]);
        y[i][c] = fmaf(a2v.y, b2v[c].y, y[i][c]);
        y[i][c] = fmaf(a2v.z, b2v[c].z, y[i][c]);
        y[i][c] = fmaf(a2v.w, b2v[c].w, y[i][c]);
      }
    }
  }

  float* buf1 = t.buf1 + warp * R * kPStride;
  float* buf2 = t.buf2 + warp * R * kPStride;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = rows[i];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      float p = 0.f, ds = 0.f;
      if (j < no) {
        const int qi = KEYS_OWN ? j : r;  // the query of the pair
        const int kj = KEYS_OWN ? r : j;  // the key of the pair
        if (t.bias[kj] > kMaskThreshold)
          p = __expf(x[i][c] + t.bias[kj] + term(qi, kj) - t.lse[qi]);
        ds = p * (t.w[qi] * y[i][c] - t.delta[qi]);
        if (KEYS_OWN) p *= t.w[qi];
      }
      if (KEYS_OWN) {
        buf1[i * kPStride + j] = p;
        buf2[i * kPStride + j] = ds;
      } else {
        buf1[i * kPStride + j] = ds;
      }
    }
  }
  __syncwarp();

  // accumulate: lane owns own row lane / 8, dimensions [(lane % 8) * ND, + ND)
  constexpr int ND = DP / kLanesPerRow;
  const int i = lane / kLanesPerRow;
  const int d0 = (lane % kLanesPerRow) * ND;
  if (i < nr) {
    const int r = row0 + stride * i;
    // dq: dS against k (b1); dv: P w against dmix (b2)
    const float* src1 = KEYS_OWN ? t.b2 : t.b1;
    float* acc1 = t.acc1 + r * DP + d0;
    float a[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) a[e] = acc1[e];
    const float* p1 = buf1 + i * kPStride;
#pragma unroll 4
    for (int j = 0; j < no; ++j) {
      const float pj = p1[j];
      const float2* s2 = reinterpret_cast<const float2*>(src1 + j * S + d0);
#pragma unroll
      for (int e = 0; e < ND / 2; ++e) {
        const float2 sv = s2[e];
        a[2 * e] = fmaf(pj, sv.x, a[2 * e]);
        a[2 * e + 1] = fmaf(pj, sv.y, a[2 * e + 1]);
      }
    }
#pragma unroll
    for (int e = 0; e < ND; ++e) acc1[e] = a[e];
    if constexpr (KEYS_OWN) {
      // dk: dS against q*scale (b1)
      float* acc2 = t.acc2 + r * DP + d0;
#pragma unroll
      for (int e = 0; e < ND; ++e) a[e] = acc2[e];
      const float* p2 = buf2 + i * kPStride;
#pragma unroll 4
      for (int j = 0; j < no; ++j) {
        const float pj = p2[j];
        const float2* s2 = reinterpret_cast<const float2*>(t.b1 + j * S + d0);
#pragma unroll
        for (int e = 0; e < ND / 2; ++e) {
          const float2 sv = s2[e];
          a[2 * e] = fmaf(pj, sv.x, a[2 * e]);
          a[2 * e + 1] = fmaf(pj, sv.y, a[2 * e + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < ND; ++e) acc2[e] = a[e];
    }
  }
  __syncwarp();
}

// Write a 64-row fp32 accumulator (row stride DP) times `scale` to rows
// [0, n) of a (.., D) tensor, row i at base + row_offset(i).
template <int DP, typename T, typename RowOffset>
__device__ __forceinline__ void store_rows(T* base, const float* acc, int n, int D, float scale,
                                           RowOffset row_offset) {
  for (int e = threadIdx.x; e < kBlockQ * DP; e += kThreads) {
    const int i = e / DP, d = e - i * DP;
    if (i < n && d < D) base[row_offset(i) + d] = from_float<T>(acc[e] * scale);
  }
}

}  // namespace mt
