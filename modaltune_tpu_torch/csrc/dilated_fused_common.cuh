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
#pragma once

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
  return true;
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
  const int t = tile - start[bi];
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
