// Shared pieces of the tensor-core (bf16) ALiBi attention kernels
// (alibi_attention_{fwd,bwd}.cu): tile geometry, bf16 tile loads, and the
// row index of each element of a wmma accumulator fragment.
//
// A block of four warps owns 64 "own" rows (queries, or keys in the dk/dv
// kernel), 16 per warp, and streams 64-row "other" tiles through shared
// memory. Products run on the tensor cores as nvcuda::wmma m16n16k16 bf16
// tiles with fp32 accumulation. A warp's 16 x 64 score tile goes through its
// own fp32 patch of shared memory, where two lanes per row apply the scale,
// the ALiBi term and the key bias and take the softmax statistics; the
// probabilities go back as bf16 for the second product.
#pragma once

#include <mma.h>

#include "attention_common.cuh"

namespace mt {

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16;        // own rows per warp: one wmma tile
constexpr int kTcPS = kBlockK + 8; // bf16 row stride of a warp's P / dS tile
static_assert(kBlockQ == kTcWarps * kTcRows && kBlockK == 64, "tile geometry");

using bf16 = __nv_bfloat16;
using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                     nvcuda::wmma::row_major>;
using FragBRow = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                        nvcuda::wmma::row_major>;
using FragBCol = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                        nvcuda::wmma::col_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Row strides for a padded head dimension DP (a multiple of 16): bf16 tiles
// are padded by 8 elements (16 bytes) so that the tensor-core loads of
// consecutive rows fall on distinct banks; a warp's fp32 patch holds a
// 16 x 64 score tile or a 16 x DP output tile.
template <int DP>
struct TcPlan {
  static constexpr int LD = DP + 8;
  static constexpr int SS = (DP > kBlockK ? DP : kBlockK) + 4;
  static constexpr int tile_elems = kBlockK * LD;                 // bf16
  static constexpr int patch_floats = kTcWarps * kTcRows * SS;    // all warps
  static constexpr int p_elems = kTcWarps * kTcRows * kTcPS;      // bf16
};

// Copy `n` rows of a (.., D) bf16 tensor into a [64][LD] bf16 tile; row i
// starts at base + (row0 + i) * D. Padding columns and rows past n are zero.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* base, int n, int D) {
  constexpr int LD = TcPlan<DP>::LD;
  if (D == DP) {  // rows are 16-byte aligned: 8 elements per load
    for (int i = threadIdx.x; i < kBlockK * (DP / 8); i += kTcThreads) {
      const int r = i / (DP / 8), c = (i - r * (DP / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) x = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(r) * D + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < kBlockK * DP; i += kTcThreads) {
      const int r = i / DP, c = i - r * DP;
      dst[r * LD + c] =
          (r < n && c < D) ? base[static_cast<size_t>(r) * D + c] : __float2bfloat16(0.f);
    }
  }
}

// rows[i] = the tile row that element i of this thread's accumulator
// fragment holds (the same for every accumulator fragment of this shape):
// read off a 16 x 16 patch whose entries are their own row numbers.
// `patch` is the calling warp's fp32 patch (row stride ss).
__device__ __forceinline__ void fragment_rows(float* patch, int ss, int lane, int* rows) {
  for (int e = lane; e < 16 * 16; e += 32) patch[(e / 16) * ss + e % 16] = float(e / 16);
  __syncwarp();
  FragC f;
  nvcuda::wmma::load_matrix_sync(f, patch, ss, nvcuda::wmma::mem_row_major);
#pragma unroll
  for (int i = 0; i < f.num_elements; ++i) rows[i] = static_cast<int>(f.x[i]);
  __syncwarp();
}

// C (16 x 64, into a warp's fp32 patch) = A (16 x DP, row-major bf16, stride
// lda) . B^T, with B a [64][LD] bf16 tile (row j of B is column j of C).
template <int DP>
__device__ __forceinline__ void warp_scores(float* patch, const bf16* a, int lda, const bf16* b) {
  constexpr int LD = TcPlan<DP>::LD, SS = TcPlan<DP>::SS;
  FragC acc[kBlockK / 16];
#pragma unroll
  for (int j = 0; j < kBlockK / 16; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    FragA fa;
    nvcuda::wmma::load_matrix_sync(fa, a + kk * 16, lda);
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      FragBCol fb;
      nvcuda::wmma::load_matrix_sync(fb, b + j * 16 * LD + kk * 16, LD);
      nvcuda::wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kBlockK / 16; ++j)
    nvcuda::wmma::store_matrix_sync(patch + j * 16, acc[j], SS, nvcuda::wmma::mem_row_major);
}

// acc (16 x DP) += P (16 x 64 bf16, a warp's tile, stride kTcPS) . B, with
// B a [64][LD] bf16 tile (row j of B meets column j of P).
template <int DP>
__device__ __forceinline__ void warp_accumulate(FragC* acc, const bf16* p, const bf16* b) {
  constexpr int LD = TcPlan<DP>::LD;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    FragA fa;
    nvcuda::wmma::load_matrix_sync(fa, p + kk * 16, kTcPS);
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      FragBRow fb;
      nvcuda::wmma::load_matrix_sync(fb, b + kk * 16 * LD + n * 16, LD);
      nvcuda::wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write a warp's 16 x DP accumulator, times `scale`, to rows [0, n) of a
// (.., D) bf16 tensor through the warp's fp32 patch.
template <int DP>
__device__ __forceinline__ void warp_store(bf16* dst, int D, int n, FragC* acc, float* patch,
                                           float scale, int lane) {
  constexpr int SS = TcPlan<DP>::SS;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    nvcuda::wmma::store_matrix_sync(patch + j * 16, acc[j], SS, nvcuda::wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < kTcRows * DP; e += 32) {
    const int r = e / DP, c = e - r * DP;
    if (r < n && c < D)
      dst[static_cast<size_t>(r) * D + c] = __float2bfloat16(patch[r * SS + c] * scale);
  }
  __syncwarp();
}

}  // namespace mt
