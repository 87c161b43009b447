// The device frame of the 3xTF32 dilated attention cores at fp32, D = 48
// (dilated_fwd_tf32.cu, dilated_bwd_tf32.cu): fp32 compact 64-row tiles in
// shared memory, their gather, products at fp32 accuracy on the TF32 tensor
// cores, and the stream of a group's live key tiles.
//
// * 3xTF32. An fp32 operand x is split into hi = cvt.rna.tf32.f32(x) and
//   lo = cvt.rna.tf32.f32(x - hi), and a product is lo hi + hi lo + hi hi
//   accumulated in fp32 (the small terms first), lo lo dropped: about 2^-21
//   of each product, where one TF32 product keeps 2^-11 and misses the fp32
//   gates (tests/test_torch_dilated_{fwd,bwd}.py emulate both). A register
//   tile (P, dS) is split the same way. The tensor cores add into their
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

namespace mt {
namespace dtf {

using dwg::Group;

constexpr int kD = kWgmmaD;
constexpr int kTile = 64;
constexpr int kStride = kD + 4;               // floats a row in shared memory
constexpr int kTileFloats = kTile * kStride;
constexpr int kChunks = kD / 4;               // 16-byte chunks of a row
constexpr int kThreads = 128;                 // four warps of 16 own rows
constexpr int kStages = 2;
constexpr int kHalf = kTile / 2;              // rows of a stage multiplied at once
static_assert(kStride % 4 == 0, "16-byte rows");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// ---- 3xTF32 ---------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo + (what lo's rounding drops)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// An A fragment (16 x 8) in two parts.
struct Frag {
  uint32_t hi[4], lo[4];
};

// c (16 x 8) += a b for one 8-deep step, TF32 operands (a: four registers),
// fp32 sums.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at fp32 accuracy: lo hi, then hi lo, then hi hi.
__device__ __forceinline__ void mma3(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma(c, a_lo, bh[0], bh[1]);
  mma(c, a_hi, bl[0], bl[1]);
  mma(c, a_hi, bh[0], bh[1]);
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

// The A fragment of the next product's 8-deep step j from the C fragment of
// score tile j: logical column t is key 2t, column t + 4 key 2t + 1.
__device__ __forceinline__ Frag from_scores(const float (&x)[16], int j) {
  Frag f;
  split(x[4 * j], f.hi[0], f.lo[0]);          // (g, key 2t)
  split(x[4 * j + 2], f.hi[1], f.lo[1]);      // (g + 8, key 2t)
  split(x[4 * j + 1], f.hi[2], f.lo[2]);      // (g, key 2t + 1)
  split(x[4 * j + 3], f.hi[3], f.lo[3]);      // (g + 8, key 2t + 1)
  return f;
}

// The B fragment of step j (rows 8 j + 2 t and + 1 at b, in from_scores'
// order) for output columns 8 m + g.
__device__ __forceinline__ void row_pair(const float* b, int j, int m, const wg::Lane& ln,
                                         uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* br = b + (8 * j + ln.col0) * kStride + 8 * m + (ln.row0 & 7);
  split(br[0], bh[0], bl[0]);
  split(br[kStride], bh[1], bl[1]);
}

// acc (the warp's 16 rows x 48) += X B over a half: X the 16 x 32 register
// tile, B the 32 rows at b (their 48 columns are N). The tensor cores add
// into their fp32 accumulator by truncation, not to nearest, and one
// accumulator over a whole stream of tiles read dq at rel-L2 1.104e-05
// against the plain fp32 backward at (3, 10240, 16, 48), past the 1e-5 gate
// (NVIDIA H100 80GB HBM3, 700 W): so the half's products go into a fresh
// fragment t, which fp32 adds (to nearest) add to acc.
__device__ __forceinline__ void product(float (&acc)[24], const float (&x)[16], const float* b,
                                        const wg::Lane& ln) {
  float t[24] = {};
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    const Frag f = from_scores(x, j);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      uint32_t bh[2], bl[2];
      row_pair(b, j, m, ln, bh, bl);
      mma3(t + 4 * m, f.hi, f.lo, bh, bl);
    }
  }
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] += t[i];
}

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
