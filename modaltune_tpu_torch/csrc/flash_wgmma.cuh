// The wgmma family of the key-bias flash attention kernels (K2f, K2b): bf16
// q/k/v at head dimension 48, any Lq and Lk. That is every call of the
// per-branch dilated attention (ops/dilated.py, the CLI's
// --fused_attention 0): five branches a LongNet layer of GigaPath, 60 K2f
// and 60 K2b a train step.
//
// The kernels (flash_wgmma_fwd.cu, flash_wgmma_bwd.cu) stand on the D = 48
// frame of the dilated cores (dilated_wgmma_frame.cuh): 64-row tiles held as
// three 16-column slabs in the 32-byte swizzle, S = q k^T as m64n64k16 in
// three steps, O += P v (and every gradient product) as m64n48k16 with the
// left operand in registers, a producer warpgroup feeding a ring of four
// stages that the consumers release, setmaxnreg, a sentinel stage ending a
// stream. What differs from the dilated cores is only where rows come from:
// row l of plane bh of a (BH, L, 48) tensor lies at (bh L + l) 48, so a
// tile is 64 neighbouring rows of 96 bytes, read by the producer's 16-byte
// cp.async (the frame's gather with r = 1) and zero-filled past L, which
// covers every ragged tail (L % 64 != 0) without reading past a tensor.
//
// Key terms: a stage carries its keys' additive terms in base 2, bias *
// log2(e) for a key whose bias is above NEG_INF/2, -inf for a masked key or
// a row past Lk (ss::key_term). The bias is any float, not only 0 or
// NEG_INF. The producer ORs the validity of a key tile over its warpgroup
// and never loads a tile without a valid key.
#pragma once

#include "dilated_wgmma_frame.cuh"
#include "flash_short_side.cuh"

namespace mt {

static_assert(ss::kWgmmaD == kWgmmaD, "one head dimension for both wgmma families");

// The forward (flash_wgmma_fwd.cu): out (BH, Lq, 48) bf16 and lse (BH, Lq)
// fp32, 0 and NEG_INF for a row without a valid key.
cudaError_t launch_flash_wgmma_fwd(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                   bf16* out, float* lse, int BH, int Lq, int Lk, float scale,
                                   cudaStream_t stream);

// The backward (flash_wgmma_bwd.cu): the dq kernel, which also writes delta
// = rowsum(dout * out) into `delta` (BH, Lq) fp32 scratch, then the dk/dv
// kernel, which reads it.
cudaError_t launch_flash_wgmma_bwd(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                   const bf16* dout, const bf16* out, const float* lse,
                                   float* delta, bf16* dq, bf16* dk, bf16* dv, int BH, int Lq,
                                   int Lk, float scale, cudaStream_t stream);

namespace fwg {

using dwg::kD;
using dwg::kStages;
using dwg::kTile;
using dwg::kTileBytes;
using dwg::Smem;

__host__ __device__ inline int tiles_of(int L) { return (L + kTile - 1) / kTile; }

// Producer thread p (0..127): its three 16-byte chunks of row p / 2 of
// tile t of the rows [0, L) at `x` into tile d; rows past L arrive as zeros.
__device__ __forceinline__ void load_tile(unsigned char* d, const bf16* x, int L, int t, int p) {
  const int i = p >> 1, l = t * kTile + i;
  const bool real = l < L;
  const bf16* src = x + static_cast<size_t>(real ? l : 0) * kD;
#pragma unroll
  for (int cc = 0; cc < 3; ++cc) {
    const int c = 3 * (p & 1) + cc;
    dwg::cp_async16(d + dwg::chunk_offset(i, c), src + 8 * c, real);
  }
}

// The producer's stream of one plane's live key tiles: each stage holds a
// tile's k and v and its keys' terms; then the sentinel. k, v and bias are
// the plane's rows [0, Lk); bias may be null (every key valid).
__device__ __forceinline__ void produce_keys(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                             const bf16* k, const bf16* v, const float* bias,
                                             int Lk, int p) {
  wg::Ring r;
  for (int t = 0; t < tiles_of(Lk); ++t) {
    const float term = ss::key_term(bias, t * kTile + (p >> 1), Lk, wg::kLog2e);
    if (!dwg::producer_any(term != -INFINITY)) continue;   // a dead key tile
    wg::mbar_wait(empty + r.stage, r.phase ^ 1);
    unsigned char* st = ring + r.stage * Smem::kStageBytes;
    load_tile(st, k, Lk, t, p);
    load_tile(st + kTileBytes, v, Lk, t, p);
    dwg::cp_async_arrive(full + r.stage);
    if ((p & 1) == 0) reinterpret_cast<float*>(st + Smem::kTerms)[p >> 1] = term;
    if (p == 0) *reinterpret_cast<int*>(st + Smem::kEnd) = 0;
    wg::mbar_arrive(full + r.stage);
    r.advance<kStages>();
  }
  dwg::producer_finish(ring, full, empty, r, p);
}

// Rows row0 + lane's row and + 8 of a 64 x 48 accumulator times `scale`
// into bf16 rows at `dst` (row stride 48), the rows below n only.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[24], int n, float scale,
                                           const wg::Lane& ln) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    if (row >= n) continue;
    bf16* d = dst + static_cast<size_t>(row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(d + 8 * j) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// The block's shared memory: the frame's layout (two own tiles, the ring,
// the barriers).
struct Frame {
  unsigned char* smem;
  unsigned char* ring;
  uint64_t *full, *empty, *own_bar;
  __device__ explicit Frame(unsigned char* raw) {
    smem = dwg::aligned_smem(raw);
    ring = smem + Smem::kRing;
    full = reinterpret_cast<uint64_t*>(smem + Smem::kBars);
    empty = full + kStages;
    own_bar = empty + kStages;
  }
};

}  // namespace fwg
}  // namespace mt
