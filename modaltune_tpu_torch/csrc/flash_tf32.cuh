// The 3xTF32 family of the key-bias flash attention kernels (K2f, K2b): fp32
// q/k/v at head dimension 48, any Lq and Lk. That is every call of the
// per-branch dilated attention (ops/dilated.py, the CLI's
// --fused_attention 0) under an fp32 backbone (the CLI's --bf16 0), and the
// LoRA attention's at fp32: five branches a LongNet layer of GigaPath, 60
// K2f and 60 K2b a train step.
//
// The kernels (flash_tf32_fwd.cu, flash_tf32_bwd.cu) stand on the frame of
// the dilated 3xTF32 cores (dilated_tf32.cuh): blocks of four warps of 16
// own rows of one 64-row tile, rows of 48 floats padded to 52 in shared
// memory, a two-stage cp.async ring of the live key tiles, every product as
// three TF32 mma.sync m16n8k8 (tf32x3.cuh) summed a half tile at a time in
// fresh fragments (the tensor cores accumulate by truncation). What differs
// from the dilated cores is only where rows come from, as the wgmma family
// (flash_wgmma.cuh) differs from the bf16 dilated cores: row l of plane bh of
// a (BH, L, 48) tensor lies at (bh L + l) 48, so a tile is 64 neighbouring
// rows, gathered with 16-byte cp.async and zero-filled past L, which covers
// every ragged tail (the r = 2 branch's 2,896 rows are 45 tiles and 16
// rows) without reading past a tensor.
//
// Key terms: a stage carries its keys' additive terms in base 2, bias *
// log2(e) for a key whose bias is above NEG_INF/2, -inf for a masked key or
// a row past Lk (ss::key_term). The bias is any float, not only 0 or
// NEG_INF. The block ORs the validity of a key tile and never loads a tile
// without a valid key; a bh without a valid key streams nothing.
#pragma once

#include "dilated_tf32.cuh"
#include "flash_short_side.cuh"

namespace mt {

// The forward (flash_tf32_fwd.cu): out (BH, Lq, 48) and lse (BH, Lq) fp32,
// 0 and NEG_INF for a row without a valid key.
cudaError_t launch_flash_tf32_fwd(const float* q, const float* k, const float* v,
                                  const float* bias, float* out, float* lse, int BH, int Lq,
                                  int Lk, float scale, cudaStream_t stream);

// The backward (flash_tf32_bwd.cu): a kernel that writes vbar, the mean of
// the valid keys' v rows, of every bh into the first (BH, 48) floats of the
// 16-byte aligned fp32 scratch `work`; the dq kernel, which also writes
// delta = dout.(out - vbar) into the (BH, Lq) floats after them; then the
// dk/dv kernel, which reads both.
cudaError_t launch_flash_tf32_bwd(const float* q, const float* k, const float* v,
                                  const float* bias, const float* dout, const float* out,
                                  const float* lse, float* work, float* dq, float* dk, float* dv,
                                  int BH, int Lq, int Lk, float scale, cudaStream_t stream);

namespace ftf {

using dtf::kChunks;
using dtf::kD;
using dtf::kStride;
using dtf::kThreads;
using dtf::kTile;
using dtf::kTileFloats;

__host__ __device__ inline int tiles_of(int L) { return (L + kTile - 1) / kTile; }

// Tile t of the rows [0, L) at x (64 rows of 48 floats, 12 chunks each)
// into d, chunk threadIdx.x + 128 i by thread threadIdx.x; rows past L as
// zeros.
__device__ __forceinline__ void load_tile(float* d, const float* x, int L, int t) {
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i, row = c / kChunks, ch = c % kChunks;
    const int l = t * kTile + row;
    const bool real = l < L;
    dwg::cp_async16(d + row * kStride + 4 * ch,
                    x + static_cast<size_t>(real ? l : 0) * kD + 4 * ch, real);
  }
}

// The plane's first key tile at or after t that holds a valid key
// (tiles_of(Lk) if none), found by the whole block; `term` gets this
// thread's key term there (threads below 64). bias: the plane's Lk
// entries, or null (every key valid).
__device__ __forceinline__ int next_live(const float* bias, int Lk, int t, float& term) {
  for (; t < tiles_of(Lk); ++t) {
    const float x = threadIdx.x < kTile
                        ? ss::key_term(bias, t * kTile + threadIdx.x, Lk, wg::kLog2e)
                        : -INFINITY;
    if (__syncthreads_or(x != -INFINITY)) {
      term = x;
      break;
    }
  }
  return t;
}

}  // namespace ftf
}  // namespace mt
