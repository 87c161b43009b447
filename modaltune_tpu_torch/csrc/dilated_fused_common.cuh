// Geometry shared by the per-branch dilated attention kernels
// (dilated_fused_fwd.cu, dilated_fused_bwd.cu): the compact row layout of
// ops/dilated_fused.py and the mapping from a block index to its tile.
//
// Branch bi (segment length w, ratio r) of a length-L sequence: sl =
// min(w, L), nseg = ceil(L / sl), m = ceil(sl / r). Head h, of group
// g = head_group(h, H, r), owns nseg * m compact rows: row seg * m + l is the
// position seg * sl + l * r + g, real when l * r + g < sl and the position
// lies below L. Within a (segment, head group) the real rows are the first
// n_real of the m, and they are at once the queries and the keys of one
// ordinary attention. The branches' rows are concatenated: branch bi owns
// [off[bi], off[bi + 1]) of the M = off[n] rows of a (B, H, M, ...) tensor.
//
// A block owns kBlockQ consecutive compact rows of one (batch, head, branch,
// segment). blockIdx.x enumerates the tiles of every branch, branch after
// branch: branch bi owns [tile0[bi], tile0[bi + 1]). A block that owns a
// span of two consecutive tiles of one (segment, head group) enumerates the
// spans the same way, [span0[bi], span0[bi + 1]); the second tile of a
// group's last span may hold no row.
//
// A query range [q0, q1) (K1's q_token_range, the sequence-parallel shard's
// rows): query_tiles() gives the enumeration of the tiles (spans) that may
// hold a position of the range, branch by branch, as a run of the full
// enumeration's (segment, tile) order that starts at tfirst[bi] (sfirst[bi])
// and is bounded over every head group at once; every kernel reads q0 and q1
// to zero or skip what lies outside. make_fused_branches() sets them to 0
// and L (every row).
#pragma once

#include <cstdint>
#include <type_traits>

#include "attention_bwd_common.cuh"

namespace mt {

// Head dimensions a lane holds in the warp-per-(token, head) kernels.
constexpr int kMaxDimsPerLane = 4;  // D <= 128

struct FusedBranches {
  int n;
  int seg[kMaxBranches];    // sl = min(w, L)
  int ratio[kMaxBranches];
  int nseg[kMaxBranches];
  int m[kMaxBranches];      // compact rows per (segment, head)
  int off[kMaxBranches + 1];
  int tile0[kMaxBranches + 1];
  int span0[kMaxBranches + 1];  // spans of two tiles
  int tfirst[kMaxBranches];     // the branch's first tile (span) of the
  int sfirst[kMaxBranches];     // full enumeration: 0 unless restricted
  int q0, q1;                   // query positions [q0, q1)
};

// Fills fb; false when the arguments are out of range.
inline bool make_fused_branches(FusedBranches& fb, int L, const int* segments, const int* ratios,
                                int n) {
  if (L < 1 || n < 1 || n > kMaxBranches) return false;
  fb.n = n;
  long long off = 0, tiles = 0, spans = 0;
  for (int i = 0; i < n; ++i) {
    if (segments[i] < 1 || ratios[i] < 1) return false;
    const int sl = segments[i] < L ? segments[i] : L;
    fb.seg[i] = sl;
    fb.ratio[i] = ratios[i];
    fb.nseg[i] = (L + sl - 1) / sl;
    fb.m[i] = (sl + ratios[i] - 1) / ratios[i];
    fb.off[i] = static_cast<int>(off);
    fb.tile0[i] = static_cast<int>(tiles);
    fb.span0[i] = static_cast<int>(spans);
    const int per_seg = (fb.m[i] + kBlockQ - 1) / kBlockQ;
    off += static_cast<long long>(fb.nseg[i]) * fb.m[i];
    tiles += static_cast<long long>(fb.nseg[i]) * per_seg;
    spans += static_cast<long long>(fb.nseg[i]) * ((per_seg + 1) / 2);
    if (off > 0x3fffffff || tiles > 0x3fffffff) return false;
  }
  for (int i = n; i <= kMaxBranches; ++i) {
    fb.off[i] = static_cast<int>(off);
    fb.tile0[i] = static_cast<int>(tiles);
    fb.span0[i] = static_cast<int>(spans);
  }
  for (int i = 0; i < kMaxBranches; ++i) fb.tfirst[i] = fb.sfirst[i] = 0;
  fb.q0 = 0;
  fb.q1 = L;
  return true;
}

// Sets the query range [q0, q1) of fb (made for length L); false when it is
// empty or out of [0, L).
inline bool set_query_range(FusedBranches& fb, int L, int q0, int q1) {
  if (q0 < 0 || q1 > L || q0 >= q1) return false;
  fb.q0 = q0;
  fb.q1 = q1;
  return true;
}

// fb's enumeration restricted to the tiles (and spans) of its query range:
// in branch bi, the segments from the range's first to its last position,
// from the tile of row (q0 - s0) / r of the first (no head group's first row
// of the range lies before it) to the tile of row ceil((q1 - s0') / r) - 1
// of the last (none's last after it). The full range leaves fb as it is.
inline FusedBranches query_tiles(const FusedBranches& fb, int L) {
  if (fb.q0 == 0 && fb.q1 == L) return fb;
  FusedBranches fq = fb;
  int tiles = 0, spans = 0;
  for (int i = 0; i < fb.n; ++i) {
    const int sl = fb.seg[i], r = fb.ratio[i], m = fb.m[i];
    const int per_seg = (m + kBlockQ - 1) / kBlockQ, pss = (per_seg + 1) / 2;
    const int seg_lo = fb.q0 / sl, seg_hi = (fb.q1 - 1) / sl;
    const int t_lo = (fb.q0 - seg_lo * sl) / r / kBlockQ;
    const int rows_hi = (fb.q1 - seg_hi * sl + r - 1) / r;
    const int l_hi = rows_hi < m ? rows_hi : m;
    const int t_hi = (l_hi + kBlockQ - 1) / kBlockQ;
    fq.tfirst[i] = seg_lo * per_seg + t_lo;
    fq.sfirst[i] = seg_lo * pss + t_lo / 2;
    fq.tile0[i] = tiles;
    fq.span0[i] = spans;
    tiles += seg_hi * per_seg + t_hi - fq.tfirst[i];
    spans += seg_hi * pss + (t_hi + 1) / 2 - fq.sfirst[i];
  }
  for (int i = fb.n; i <= kMaxBranches; ++i) {
    fq.tile0[i] = tiles;
    fq.span0[i] = spans;
  }
  return fq;
}

// Whether position p is a query of fb's range.
__device__ __forceinline__ bool in_query_range(const FusedBranches& fb, int p) {
  return p >= fb.q0 && p < fb.q1;
}

// The slots (b, p, h) outside a query range [q0, q1), which K1's CUDA-core
// kernels, their grids restricted to the range, never reach: `rows`
// (B, L, H, D) zero; with `stats` (B*H, nbr + 2, L) every branch's lse and m
// NEG_INF and Z 0 (a row without a valid key). A thread a slot.
template <typename T>
__global__ void __launch_bounds__(kThreads)
range_fill_kernel(T* __restrict__ rows, float* __restrict__ stats, int B, int L, int H, int D,
                  int nbr, int q0, int q1) {
  const int outside = L - (q1 - q0);
  const size_t slot = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= static_cast<size_t>(B) * outside * H) return;
  const int h = static_cast<int>(slot % H);
  const int j = static_cast<int>((slot / H) % outside);
  const int b = static_cast<int>(slot / (static_cast<size_t>(H) * outside));
  const int p = j < q0 ? j : j + (q1 - q0);
  const size_t row = (static_cast<size_t>(b) * L + p) * H + h;
  const T zero = from_float<T>(0.f);
  for (int d = 0; d < D; ++d) rows[row * D + d] = zero;
  if (stats == nullptr) return;
  float* st = stats + (static_cast<size_t>(b) * H + h) * (nbr + 2) * L + p;
  for (int i = 0; i <= nbr; ++i) st[static_cast<size_t>(i) * L] = kNegInf;
  st[static_cast<size_t>(nbr + 1) * L] = 0.f;
}

template <typename T>
inline cudaError_t launch_range_fill(void* rows, float* stats, int B, int L, int H, int D,
                                     int nbr, int q0, int q1, cudaStream_t stream) {
  const size_t slots = static_cast<size_t>(B) * (L - (q1 - q0)) * H;
  if (slots == 0) return cudaSuccess;
  range_fill_kernel<T><<<static_cast<unsigned>((slots + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(static_cast<T*>(rows), stats, B, L, H, D, nbr, q0, q1);
  return cudaGetLastError();
}

// q.k_j scale (s) and dmix.v_j (dp) of one key's rows against the staged
// qd, in order of d. With `wide` (fp32 rows, D % 4 == 0, 16-byte aligned)
// each load reads four floats: a lane a key leaves a warp's loads
// uncoalesced, so their count bounds window_pdp (one float a load: 60.36 of
// the CUDA-core K1b's 68.69 ms at (3, 2048, 16, 48), fp32; fp32 at D = 48
// has since run on the 3xTF32 core, dilated_bwd_tf32.cu, which takes delta
// in its dq kernel and never calls window_pdp).
template <typename T>
__device__ __forceinline__ void key_dots(const T* kr, const T* vr, const float* qd, int D,
                                         bool wide, float& s, float& dp) {
  if constexpr (std::is_same<T, float>::value) {
    if (wide) {
      const float4* k4 = reinterpret_cast<const float4*>(kr);
      const float4* v4 = reinterpret_cast<const float4*>(vr);
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 a = __ldg(k4 + d / 4), c = __ldg(v4 + d / 4);
        s = fmaf(qd[d], a.x, s);
        s = fmaf(qd[d + 1], a.y, s);
        s = fmaf(qd[d + 2], a.z, s);
        s = fmaf(qd[d + 3], a.w, s);
        dp = fmaf(qd[D + d], c.x, dp);
        dp = fmaf(qd[D + d + 1], c.y, dp);
        dp = fmaf(qd[D + d + 2], c.z, dp);
        dp = fmaf(qd[D + d + 3], c.w, dp);
      }
      return;
    }
  }
  for (int d = 0; d < D; ++d) {
    s = fmaf(qd[d], to_float<T>(kr[d]), s);
    dp = fmaf(qd[D + d], to_float<T>(vr[d]), dp);
  }
}

// rowsum(P dP) of one query row over its (segment, head group)'s keys, the
// CUDA-core families' delta (fp32 and bf16 at D != 48; the tensor-core
// cores take it in their dq kernels): the keys lie at positions first + r j, j < n_keys, of the head's
// rows `k` and `v` (position stride tok); P_j = exp(q.k_j scale - lse) for a
// valid key (mask byte 1, or no mask), dP_j = dmix.v_j. A warp per row, a
// lane per key, the query's q and dmix rows staged in `qd` (2 D floats of
// the warp's shared memory); the lanes' sums added by warp_sum.
template <typename T>
__device__ float window_pdp(const T* q_row, const T* dm_row, const T* k, const T* v, size_t tok,
                            const unsigned char* maskb, int first, int r, int n_keys, float lse,
                            float scale, int D, float* qd) {
  const int lane = threadIdx.x % 32;
  for (int d = lane; d < D; d += 32) {
    qd[d] = to_float<T>(q_row[d]) * scale;
    qd[D + d] = to_float<T>(dm_row[d]);
  }
  __syncwarp();
  const bool wide = D % 4 == 0 && tok % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  float sum = 0.f;
  for (int j = lane; j < n_keys; j += 32) {
    const size_t pos = static_cast<size_t>(first) + static_cast<size_t>(r) * j;
    if (maskb != nullptr && !maskb[pos]) continue;
    float s = 0.f, dp = 0.f;
    key_dots(k + pos * tok, v + pos * tok, qd, D, wide, s, dp);
    sum = fmaf(expf(s - lse), dp, sum);
  }
  __syncwarp();   // the warp's next row overwrites qd
  return warp_sum(sum);
}

// One block's tile.
struct FusedTile {
  int r;       // the branch's ratio
  int first;   // position of the (segment, group)'s row 0; row l is first + r * l
  int n_real;  // real rows of the (segment, group)
  int l0;      // the tile's first row within the (segment, group)
  int n_rows;  // rows the tile holds, real or not: min(kBlockQ, m - l0)
  int n_own;   // real rows among them
  int seg_row; // compact row of the (segment, group)'s row 0 (within one head)
};

// Tile `tile` (SPAN = 1), or tile `sub` of span `tile` (SPAN = 2).
template <int SPAN = 1>
__device__ __forceinline__ FusedTile locate_tile(const FusedBranches& fb, int tile, int h, int H,
                                                 int L, int sub = 0) {
  static_assert(SPAN == 1 || SPAN == 2, "a block owns one tile or a span of two");
  const int* start = SPAN == 1 ? fb.tile0 : fb.span0;
  int bi = 0;
  while (bi + 1 < fb.n && tile >= start[bi + 1]) ++bi;
  const int m = fb.m[bi], sl = fb.seg[bi], r = fb.ratio[bi];
  const int per_seg = ((m + kBlockQ - 1) / kBlockQ + SPAN - 1) / SPAN;
  const int t = tile - start[bi] + (SPAN == 1 ? fb.tfirst[bi] : fb.sfirst[bi]);
  const int seg = t / per_seg;
  const int g = head_group(h, H, r);
  const int s0 = seg * sl, s1 = min(s0 + sl, L);
  FusedTile ft;
  ft.r = r;
  ft.first = s0 + g;
  ft.n_real = ceil_div_nonneg(s1 - s0 - g, r);
  ft.l0 = ((t - seg * per_seg) * SPAN + sub) * kBlockQ;
  ft.n_rows = max(0, min(kBlockQ, m - ft.l0));
  ft.n_own = max(0, min(kBlockQ, ft.n_real - ft.l0));
  ft.seg_row = fb.off[bi] + seg * m;
  return ft;
}

// The compact row of (position p, head h) in branch bi, or -1 when the
// branch does not cover the slot.
__device__ __forceinline__ int covering_row(const FusedBranches& fb, int bi, int p, int h, int H) {
  const int sl = fb.seg[bi], r = fb.ratio[bi];
  const int seg = p / sl, o = p - seg * sl;
  if (o % r != head_group(h, H, r)) return -1;
  return fb.off[bi] + seg * fb.m[bi] + o / r;
}

}  // namespace mt
