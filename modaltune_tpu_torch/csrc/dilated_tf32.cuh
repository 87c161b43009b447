// The device frame of the 3xTF32 attention cores at fp32, D = 48: the
// dilated attention's (dilated_fwd_tf32.cu, dilated_bwd_tf32.cu) and the
// key-bias flash attention's (flash_tf32.cuh, on contiguous rows): fp32
// 64-row tiles in shared memory, the dilated cores' gather of compact rows,
// products at fp32 accuracy on the TF32 tensor cores, the forward's
// half-tile step, the shared-memory layouts, and the stream of a group's
// live key tiles.
//
// * 3xTF32 (tf32x3.cuh, shared with the fp32 short-side flash attention):
//   an fp32 operand x is split into hi and lo TF32 parts and a product is
//   lo hi + hi lo + hi hi, about 2^-21 of each product, where one TF32
//   product keeps 2^-11 and misses the fp32 gates
//   (tests/test_torch_dilated_{fwd,bwd}.py emulate both). A register tile
//   (P, dS) is split the same way. The tensor cores add into their
//   accumulator by truncation, so a product over a stream sums each half
//   tile into fresh fragments and adds them to nearest (product()).
// * mma.sync m16n8k8 for every product, not wgmma: wgmma takes TF32
//   operands from shared memory only K-major, and O += P v, dq += dS k,
//   dk += dS^T q and dv += (P^T w) dmix read their B operand from a row
//   tile, MN-major. A warp loads each fragment from the row tiles in the
//   layout its product needs and splits it as it loads. The C fragment of a
//   16 x 8 score tile is the A fragment of the next product's 8-deep step
//   once that step's keys are permuted (logical column c of thread c is key
//   2c, column c + 4 key 2c + 1; the B operand's rows follow), so a register
//   tile never leaves the registers.
// * A block is four warps of 16 own rows of one 64-row compact tile; every
//   thread gathers its share of a tile with 16-byte cp.async (zero-filled
//   past the group's n_real).
// * Shared memory: rows of 48 floats padded to 52 (208 bytes), so that every
//   fragment load of a warp (rows g, columns t and t + 4; or rows 2t and
//   2t + 1, column g) falls on 32 distinct banks.
#pragma once

#include "dilated_wgmma_frame.cuh"
#include "tf32x3.cuh"

namespace mt {
namespace dtf {

using dwg::Group;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::Frag;
using tf32::from_scores;
using tf32::mma3;
using tf32::split;

constexpr int kD = kWgmmaD;
constexpr int kTile = 64;
constexpr int kStride = kD + 4;               // floats a row in shared memory
constexpr int kTileFloats = kTile * kStride;
constexpr int kChunks = kD / 4;               // 16-byte chunks of a row
constexpr int kThreads = 128;                 // four warps of 16 own rows
constexpr int kStages = 2;
constexpr int kHalf = kTile / 2;              // rows of a stage multiplied at once
static_assert(kStride % 4 == 0, "16-byte rows");

// Tile t of x's group (64 rows of 48 floats, 12 chunks each) into d, chunk
// threadIdx.x + 128 i by thread threadIdx.x; rows past n_real as zeros.
__device__ __forceinline__ void gather(float* d, const float* x, const Group& g, int t) {
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i, row = c / kChunks, ch = c % kChunks;
    const int l = t * kTile + row;
    const bool real = l < g.ft.n_real;
    dwg::cp_async16(d + row * kStride + 4 * ch, x + (real ? g.element(l) : 0) + 4 * ch, real);
  }
}

// ---- the products -----------------------------------------------------------
//
// A thread (g = lane / 4, t = lane % 4) of the warp owning rows
// [r0, r0 + 16) holds, in element 4 j + 2 rr + e of a 16 x 8N register tile,
// row r0 + g + 8 rr and column 8 j + 2 t + e: the C fragments of the N
// 16 x 8 tiles, indexed as the bf16 cores' wgmma accumulators (wg::Lane:
// row0 = r0 + g, col0 = 2 t).

// The warp's A fragment of its 16 rows of tile a, columns [8 kk, + 8).
__device__ __forceinline__ Frag row_frag(const float* a, int kk, const wg::Lane& ln) {
  const float* ar = a + ln.row0 * kStride + 8 * kk + ln.col0 / 2;
  Frag fa;
  split(ar[0], fa.hi[0], fa.lo[0]);                  // (g, t)
  split(ar[8 * kStride], fa.hi[1], fa.lo[1]);        // (g + 8, t)
  split(ar[4], fa.hi[2], fa.lo[2]);                  // (g, t + 4)
  split(ar[8 * kStride + 4], fa.hi[3], fa.lo[3]);    // (g + 8, t + 4)
  return fa;
}

// s += the 8-deep step kk of A B^T: fa the warp's A fragment there, B the
// 32 rows at b.
__device__ __forceinline__ void scores_step(float (&s)[16], const Frag& fa, const float* b,
                                            int kk, const wg::Lane& ln) {
  const int g = ln.row0 & 7, t = ln.col0 / 2;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    const float* br = b + (8 * j + g) * kStride + 8 * kk + t;
    uint32_t bh[2], bl[2];
    split(br[0], bh[0], bl[0]);                      // (k = t, n = g)
    split(br[4], bh[1], bl[1]);                      // (k = t + 4, n = g)
    mma3(s + 4 * j, fa.hi, fa.lo, bh, bl);
  }
}

// s (the warp's 16 rows x 32) = A B^T over the 48 columns: A the warp's
// rows of tile a, B the 32 rows at b.
__device__ __forceinline__ void scores(float (&s)[16], const float* a, const float* b,
                                       const wg::Lane& ln) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) scores_step(s, row_frag(a, kk, ln), b, kk, ln);
}

// The B fragment of step j (rows 8 j + 2 t and + 1 at b, in from_scores'
// order) for output columns 8 m + g.
__device__ __forceinline__ void row_pair(const float* b, int j, int m, const wg::Lane& ln,
                                         uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* br = b + (8 * j + ln.col0) * kStride + 8 * m + (ln.row0 & 7);
  split(br[0], bh[0], bl[0]);
  split(br[kStride], bh[1], bl[1]);
}

// acc (the warp's 16 rows x 48) += X B over a half, in a fresh fragment
// (tf32::product): X the 16 x 32 register tile, B the 32 rows at b (their
// 48 columns are N).
__device__ __forceinline__ void product(float (&acc)[24], const float (&x)[16], const float* b,
                                        const wg::Lane& ln) {
  tf32::product<6, kHalf / 8>(acc, x, [&](int j, int m, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
    row_pair(b, j, m, ln, bh, bl);
  });
}

// One half of a forward stage (keys [h, h + 32) of a key tile): S = q k^T
// from the own rows' split fragments qf and the 32 k rows at kt, the online
// softmax of the thread's two rows in registers (dwg::online_softmax, the
// keys' base-2 terms at terms), then O += P v from the 32 v rows at vt.
__device__ __forceinline__ void attend_half(float (&o)[24], float (&m_run)[2], float (&l_run)[2],
                                            const Frag (&qf)[kD / 8], const float* kt,
                                            const float* vt, const float* terms, float scale2,
                                            const wg::Lane& ln) {
  float s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) scores_step(s, qf[kk], kt, kk, ln);
  dwg::online_softmax(s, o, m_run, l_run, terms, scale2, ln);
  product(o, s, vt, ln);   // O += P v
}

// ---- shared memory ----------------------------------------------------------

// The forward cores, in floats: the own q tile, then the ring; a stage is a
// key tile's k and v and its keys' terms. 67,072 bytes, two blocks an SM.
struct FwdSmem {
  static constexpr int kRing = kTileFloats;
  static constexpr int kTerms = 2 * kTileFloats;
  static constexpr int kStageFloats = kTerms + kTile;
  static constexpr size_t bytes = sizeof(float) * (kRing + kStages * kStageFloats);
  static_assert(kStageFloats % 4 == 0, "16-byte stages");
  static_assert(2 * bytes <= 232448, "two blocks an SM");
};

// The gradient cores, in floats: the two own tiles, then the ring; a stage
// is two tiles and three planes of per-row terms. 81,408 bytes, two blocks
// an SM.
struct Smem {
  static constexpr int kRing = 2 * kTileFloats;
  static constexpr int kTerms = 2 * kTileFloats;
  static constexpr int kStageFloats = kTerms + 3 * kTile;
  static constexpr size_t bytes = sizeof(float) * (kRing + kStages * kStageFloats);
  static_assert(kStageFloats % 4 == 0 && kStride % 4 == 0, "16-byte rows and stages");
  static_assert(2 * bytes <= 232448, "two blocks an SM");
};

// ---- the streams ------------------------------------------------------------

// The group's first key tile at or after t that holds a valid key (n_tiles
// if none), found by the whole block; `term` gets this thread's key term
// there (threads below 64: 0 or -inf).
__device__ __forceinline__ int next_live(const Group& g, const unsigned char* mask, int t,
                                         float& term) {
  for (; t < g.n_tiles(); ++t) {
    const bool valid = threadIdx.x < kTile && g.valid_key(t * kTile + threadIdx.x, mask);
    if (__syncthreads_or(valid)) {
      term = valid ? 0.f : -INFINITY;
      break;
    }
  }
  return t;
}

}  // namespace dtf
}  // namespace mt
