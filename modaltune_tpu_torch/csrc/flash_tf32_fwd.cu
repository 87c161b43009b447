// The key-bias flash attention forward (K2f) at fp32 on Hopper's tensor
// cores: the 3xTF32 family, fp32 at head dimension 48 (flash_tf32.cuh).
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_fwd_pallas (the Pallas
// TPU kernel _fwd_kernel) on the per-branch dilated attention's calls at
// fp32, where its dots run at Precision.HIGHEST (exact fp32).
//
// Computes, for every (bh, query row i):
//   s_j = (q_i . k_j) * scale + bias[bh, j]
//   out_i = sum_j softmax(s)_j v_j     (a key with bias <= NEG_INF/2 gets
//                                        exactly zero weight)
//   lse_i = log sum_j exp(s_j)         (NEG_INF and out 0 when every key of
//                                        the row is masked)
// in fp32, every product at fp32 accuracy. The plain oracle is
// ops/flash_attention.py::flash_attention_reference.
//
// What bounds it on the H100: operations. At fp32 accuracy each of the two
// products is three TF32 products: 3 x 4 pairs D flop at 495 TFLOP/s dense
// TF32, 0.82 ms at the r = 2 branch of a 10,240-token layer (96 x 2,896
// rows, 12 % of the keys masked), against 2.03 ms for the two products on
// the CUDA cores at 67 TFLOP/s, where the CUDA-core kernel of
// flash_attention_fwd.cu read 10.67 ms (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py).
//
// The design: the dilated 3xTF32 forward core's (dilated_fwd_tf32.cu), on
// contiguous rows.
// * One kernel, no atomics, so two runs give the same bits: a block is four
//   warps of 16 own rows of one 64-row query tile of a bh and streams the
//   bh's live key tiles through a two-stage ring of cp.async loads; a dead
//   key tile is never loaded.
// * The own q tile is split into its TF32 hi + lo A fragments once, into
//   registers (48 a thread), and is not read again.
// * A stage is multiplied in two halves of 32 keys (dtf::attend_half):
//   S = q k^T (3xTF32), the online softmax in registers (base 2, the key's
//   term folded into one FMA with the scale, the running max shared in a
//   quad, O rescaled), then O += P v with P split hi + lo in registers and
//   S's C fragments reused as A fragments, into fresh fragments that fp32
//   adds add to O.
// * Ragged tails: query rows past Lq are zero-filled and never written; key
//   rows past Lk have the term -inf.
// * Shared memory: the own tile, then two stages of a k and a v tile and
//   their keys' terms (dtf::FwdSmem): 67,072 bytes, two blocks an SM.
#include "flash_tf32.cuh"

namespace mt {
namespace ftf {

using dtf::FwdSmem;

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                      float scale) {
  const int bh = blockIdx.y, t0 = blockIdx.x;
  const size_t q_row0 = static_cast<size_t>(bh) * Lq;
  const size_t k_row0 = static_cast<size_t>(bh) * Lk;
  const float* kb = k + k_row0 * kD;
  const float* vb = v + k_row0 * kD;
  const float* bias_b = bias == nullptr ? nullptr : bias + k_row0;
  const int n_tiles = tiles_of(Lk);
  extern __shared__ float4 smem_ftf[];
  float* own = reinterpret_cast<float*>(smem_ftf);
  float* ring = own + FwdSmem::kRing;
  load_tile(own, q + q_row0 * kD, Lq, t0);
  dtf::cp_async_commit();
  float term = 0.f;
  int t = next_live(bias_b, Lk, 0, term);
  if (t < n_tiles) {
    load_tile(ring, kb, Lk, t);
    load_tile(ring + kTileFloats, vb, Lk, t);
    if (threadIdx.x < kTile) ring[FwdSmem::kTerms + threadIdx.x] = term;
  }
  dtf::cp_async_commit();
  dtf::cp_async_wait<1>();   // the own tile
  __syncthreads();

  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  dtf::Frag qf[kD / 8];
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) qf[kk] = dtf::row_frag(own, kk, ln);
  float o[24], m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 24; ++i) o[i] = 0.f;

  for (int stage = 0; t < n_tiles; stage ^= 1) {
    // scanning is a barrier: no warp still reads the stage the next tile fills
    const int next = next_live(bias_b, Lk, t + 1, term);
    if (next < n_tiles) {
      float* nst = ring + (stage ^ 1) * FwdSmem::kStageFloats;
      load_tile(nst, kb, Lk, next);
      load_tile(nst + kTileFloats, vb, Lk, next);
      if (threadIdx.x < kTile) nst[FwdSmem::kTerms + threadIdx.x] = term;
    }
    dtf::cp_async_commit();
    dtf::cp_async_wait<1>();
    __syncthreads();
    const float* st = ring + stage * FwdSmem::kStageFloats;
#pragma unroll 1
    for (int h = 0; h < kTile; h += dtf::kHalf)   // keys [h, h + 32) of the tile
      dtf::attend_half(o, m_run, l_run, qf, st + h * kStride, st + kTileFloats + h * kStride,
                       st + FwdSmem::kTerms + h, scale2, ln);
    t = next;
  }
  dtf::cp_async_wait<0>();

  // rows past Lq are not written; a row without a valid key: 0, NEG_INF
  const int tile_row0 = t0 * kTile;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = wg::quad_sum(l_run[rr]);   // the whole warp shuffles
    const int row = tile_row0 + ln.row0 + 8 * rr;
    if (row >= Lq) continue;
    const bool live = l > 0.f;
    const float inv = live ? 1.f / l : 0.f;
    float* orow = out + (q_row0 + row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[i] * inv, o[i + 1] * inv);
    }
    if (ln.col0 == 0) lse[q_row0 + row] = live ? (m_run[rr] + log2f(l)) * wg::kLn2 : kNegInf;
  }
}

}  // namespace ftf

cudaError_t launch_flash_tf32_fwd(const float* q, const float* k, const float* v,
                                  const float* bias, float* out, float* lse, int BH, int Lq,
                                  int Lk, float scale, cudaStream_t stream) {
  const void* rows[4] = {q, k, v, out};   // cp.async reads 16-byte chunks
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const cudaError_t err = allow_smem(ftf::flash_fwd_tf32_kernel, dtf::FwdSmem::bytes);
  if (err != cudaSuccess) return err;
  ftf::flash_fwd_tf32_kernel<<<dim3(ftf::tiles_of(Lq), BH), ftf::kThreads, dtf::FwdSmem::bytes,
                               stream>>>(q, k, v, bias, out, lse, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace mt
