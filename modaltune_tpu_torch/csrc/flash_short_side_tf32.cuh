// The short-side family of the key-bias flash attention kernels (K2f, K2b)
// at fp32: fp32 q/k/v at head dimension 16 with one side of the attention
// at most kMaxShort rows long, which is every adapter attention of the
// models with an fp32 backbone (the CLI's --bf16 0): 65 modal tokens against
// the bag's patches, or against themselves. flash_short_side.cuh has the
// bf16 family, whose plan this one keeps; flash_short_side_tf32_{fwd,bwd}.cu
// have the kernels.
//
// * The plan: the short side ("resident") is held by every block for its
//   whole life; the long side is cut into 64-row tiles and split into C
//   chunks (ss::Chunk, ss::chunks_valid), one block per (bh, chunk), each
//   tile read from device memory once. Cross-chunk partials go through fp32
//   scratch that the wrapper allocates and are added in chunk order by the
//   bf16 family's combine and sum kernels (templated on the output type):
//   no atomics, so reruns are bit-equal.
// * Products at fp32 accuracy on the TF32 tensor cores (tf32x3.cuh): every
//   product is mma.sync m16n8k8 with the operands split into TF32 hi + lo.
//   The resident side is split once, at the block's start, into hi and lo
//   planes of TF32 words, so its fragments load without a conversion;
//   streamed fragments are split as they load, P and dS in registers. A
//   product over the long side or over the resident rows sums at most 32
//   of its inner index into a fresh fragment and adds it to nearest
//   (tf32::product): the tensor cores accumulate by truncation.
// * Shared memory rows of 16 floats padded to kStride = 20 (80 bytes): a
//   fragment load of rows g, columns t and t + 4 (or rows 2t and 2t + 1,
//   column g) then falls on 32 distinct banks, where rows of 16 floats
//   put it on banks (16 g + t) mod 32, a 4-way conflict. The same trick as
//   the dilated 3xTF32 core's 52-float rows.
// * Streamed tiles land by 16-byte cp.async into the padded rows (four
//   chunks a row, zero-filled past the side's end), in a ring of stages
//   filled one tile ahead or more. The bf16 family's one bulk copy a tile
//   needs a dense tile, whose fragment loads would conflict 4-way; a
//   swizzle would make every fragment load compute its address, and
//   fragment loads from device memory would leave nothing in flight while
//   a tile is multiplied.
// * Transposes: there is no ldmatrix.trans for 32-bit elements. Short keys:
//   the P and dS of a query tile go to shared memory in fp32 ([query][key],
//   kTile x (KP + 4) floats), and the warps read P^T and dS^T fragments
//   from there with scalar loads for dv = P^T dout and dk = dS^T q. Short
//   queries: S^T is computed with the keys as rows, so dk = dS^T q and
//   dv = P^T dout take their A operand from registers; dS^T goes to shared
//   memory ([key][query]) for the partial dq. A row stride of
//   (resident rows + 4) floats keeps those loads on 32 distinct banks. A
//   register tile feeds the next product along its own columns through the
//   C -> A reuse with permuted indices (tf32::from_scores).
// * Masking as the bf16 family: a masked or padded key has the term -inf,
//   a query row without a valid key takes +|NEG_INF/2| for its lse in the
//   backward; padded resident rows are zero in both planes.
#pragma once

#include "dilated_wgmma_frame.cuh"  // dwg::cp_async16
#include "flash_short_side.cuh"
#include "tf32x3.cuh"

namespace mt {
namespace sst {

using ss::Chunk;
using ss::kD;
using ss::kTile;
using ss::kWarps;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::Frag;
using tf32::mma3;
using tf32::split;

constexpr int kStride = kD + 4;               // floats a row in shared memory
constexpr int kTileFloats = kTile * kStride;  // a streamed tile
constexpr int kChunks = kD / 4;               // 16-byte chunks of a row
constexpr int kGroup = 32;                    // inner index a fresh fragment
static_assert(kStride % 4 == 0, "16-byte rows");

// Rows [0, min(n, 64)) of a (.., 16) fp32 array at src into the padded tile
// d, zeros past n; every thread of the block issues its share.
__device__ __forceinline__ void load_tile(float* d, const float* src, int n) {
  for (int c = threadIdx.x; c < kTile * kChunks; c += blockDim.x) {
    const int row = c / kChunks, ch = c % kChunks;
    const bool real = row < n;
    dwg::cp_async16(d + row * kStride + 4 * ch, src + (real ? row * kD : 0) + 4 * ch, real);
  }
}

// A resident side: rows [0, n) of a (.., 16) fp32 array, less the 16-float
// row `shift` where given, into `rows` rows of TF32 hi and lo planes
// (kStride words a row), zeros past n.
__device__ __forceinline__ void split_resident(uint32_t* hi, uint32_t* lo, const float* src,
                                               int n, int rows,
                                               const float* shift = nullptr) {
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int row = c / kChunks, ch = c % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) {
      x = reinterpret_cast<const float4*>(src)[c];
      if (shift != nullptr) {
        const float4 m = reinterpret_cast<const float4*>(shift)[ch];
        x = make_float4(x.x - m.x, x.y - m.y, x.z - m.z, x.w - m.w);
      }
    }
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    const int at = row * kStride + 4 * ch;
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// ---- fragments ---------------------------------------------------------------
//
// A thread (g = lane / 4, t = lane % 4) of a warp holds, in element
// 4 j + 2 rr + e of a 16 x 8N register tile, row g + 8 rr of the warp's 16
// and column 8 j + 2 t + e: the C fragments of the N 16 x 8 tiles.

// The A fragment of the 16 rows at a (a streamed tile's, kStride floats a
// row), columns [8 kk, + 8), split as it loads.
__device__ __forceinline__ Frag tile_frag(const float* a, int kk, int g, int t) {
  const float* ar = a + g * kStride + 8 * kk + t;
  Frag f;
  split(ar[0], f.hi[0], f.lo[0]);                  // (g, t)
  split(ar[8 * kStride], f.hi[1], f.lo[1]);        // (g + 8, t)
  split(ar[4], f.hi[2], f.lo[2]);                  // (g, t + 4)
  split(ar[8 * kStride + 4], f.hi[3], f.lo[3]);    // (g + 8, t + 4)
  return f;
}

// The B fragment of a score product's step kk (B = R^T: k the column of R,
// n its row) for the 8 rows at r, from R's hi and lo planes.
__device__ __forceinline__ void plane_cols(const uint32_t* hi, const uint32_t* lo, int r, int kk,
                                           int g, int t, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const int at = (r + g) * kStride + 8 * kk + t;
  bh[0] = hi[at];
  bh[1] = hi[at + 4];
  bl[0] = lo[at];
  bl[1] = lo[at + 4];
}

// The B fragment of a product's step over R's rows r + 2t and r + 2t + 1
// (from_scores' order), output columns 8 m + g, from R's hi and lo planes.
__device__ __forceinline__ void plane_rows(const uint32_t* hi, const uint32_t* lo, int r, int m,
                                           int g, int t, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const int at = (r + 2 * t) * kStride + 8 * m + g;
  bh[0] = hi[at];
  bh[1] = hi[at + kStride];
  bl[0] = lo[at];
  bl[1] = lo[at + kStride];
}

// The same from a streamed tile's rows at b, split as it loads.
__device__ __forceinline__ void tile_cols(const float* b, int r, int kk, int g, int t,
                                          uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* br = b + (r + g) * kStride + 8 * kk + t;
  split(br[0], bh[0], bl[0]);
  split(br[4], bh[1], bl[1]);
}
__device__ __forceinline__ void tile_rows(const float* b, int r, int m, int g, int t,
                                          uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* br = b + (r + 2 * t) * kStride + 8 * m + g;
  split(br[0], bh[0], bl[0]);
  split(br[kStride], bh[1], bl[1]);
}

// s (the warp's 16 rows x 8 NT) = A R^T over the 16 columns: fa the warp's
// two A fragments, R the resident rows in planes.
template <int NT>
__device__ __forceinline__ void plane_scores(float* s, const Frag (&fa)[2], const uint32_t* hi,
                                             const uint32_t* lo, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t bh[2], bl[2];
      plane_cols(hi, lo, 8 * j, kk, g, t, bh, bl);
      mma3(s + 4 * j, fa[kk].hi, fa[kk].lo, bh, bl);
    }
  }
}

// acc (16 x 16) += X R over NT 8-deep steps: X the register tile x (NT
// tiles of 8), R the resident rows in planes; a fresh fragment each 32 rows
// of R (the last group may hold 16).
template <int NT>
__device__ __forceinline__ void plane_product(float (&acc)[8], const float* x, const uint32_t* hi,
                                              const uint32_t* lo, int g, int t) {
#pragma unroll
  for (int j0 = 0; j0 + 4 <= NT; j0 += 4)
    tf32::product<2, 4>(acc, x + 4 * j0, [&](int j, int m, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
      plane_rows(hi, lo, 8 * (j0 + j), m, g, t, bh, bl);
    });
  if constexpr (NT % 4 != 0) {
    constexpr int j0 = NT / 4 * 4;
    tf32::product<2, NT % 4>(acc, x + 4 * j0,
                             [&](int j, int m, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
                               plane_rows(hi, lo, 8 * (j0 + j), m, g, t, bh, bl);
                             });
  }
}

// Two rows (g and g + 8 of a 16 x 16 accumulator) times `mul` into rows of
// a (.., 16) fp32 array: columns 2t and 8 + 2t.
__device__ __forceinline__ void store_row(float* row, const float (&acc)[8], int h, int t,
                                          float mul) {
  float2* r2 = reinterpret_cast<float2*>(row);
  r2[t] = make_float2(acc[2 * h] * mul, acc[2 * h + 1] * mul);
  r2[4 + t] = make_float2(acc[4 + 2 * h] * mul, acc[4 + 2 * h + 1] * mul);
}

// ---- launchers (flash_short_side_tf32_fwd.cu, flash_short_side_tf32_bwd.cu) --

// The scratch `work` as the bf16 family's (flash_short_side.cuh).
cudaError_t launch_fwd(int fam, const float* q, const float* k, const float* v, const float* bias,
                       float* out, float* lse, int BH, int Lq, int Lk, float scale, int chunks,
                       float* work, cudaStream_t stream);
cudaError_t launch_bwd(int fam, const float* q, const float* k, const float* v, const float* bias,
                       const float* dout, const float* out, const float* lse, float* dq,
                       float* dk, float* dv, int BH, int Lq, int Lk, float scale, int chunks,
                       float* work, cudaStream_t stream);

}  // namespace sst
}  // namespace mt
