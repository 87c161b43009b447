// The key-bias flash attention forward (K2f) on Hopper's tensor cores: the
// wgmma family, bf16 at head dimension 48 (flash_wgmma.cuh).
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_fwd_pallas (the Pallas
// TPU kernel _fwd_kernel) on the per-branch dilated attention's calls.
//
// Computes, for every (bh, query row i):
//   s_j = (q_i . k_j) * scale + bias[bh, j]
//   out_i = sum_j softmax(s)_j v_j     (a key with bias <= NEG_INF/2 gets
//                                        exactly zero weight)
//   lse_i = log sum_j exp(s_j)         (NEG_INF and out 0 when every key of
//                                        the row is masked)
// with P rounded once to bf16 before P v, as the JAX kernel's
// p.astype(v.dtype), its row sum taken in fp32; out in bf16, lse in fp32.
// The plain oracle is ops/flash_attention.py::flash_attention_reference.
//
// What bounds it on the H100: operations. The two products are 4 pairs D
// flop: at the 10,240-token layer's five branches (1.38 G unmasked pairs
// with 9,000 valid tokens) 0.268 ms. One exp2 an element on the special
// function units and the online softmax's handful of fp32 operations an
// element run beside the products.
//
// The design: the dilated forward core's (dilated_fwd_wgmma.cu), on
// contiguous rows.
// * W = 2 consumer warpgroups a block (kFlashFwdWarpgroups), each owning
//   one of two consecutive 64-row query tiles of a bh, both reading every
//   k/v stage, so a stage's loads serve 128 query rows. The producer
//   warpgroup loads the own q tiles once, then streams the bh's live key
//   tiles with their terms and ends with the sentinel; a dead key tile is
//   never loaded, and a bh without a valid key streams nothing.
// * The online softmax in registers (dwg::softmax_tile): scores in base 2
//   with scale log2(e) and the key's term folded into one FMA, the running
//   max shared within a quad, O rescaled in registers, P packed to bf16 as
//   the register operand of O += P v.
// * Ragged tails: query rows past Lq are zero-filled and never written; key
//   rows past Lk have the term -inf.
// * No atomics: each output row is written by one thread quad, so two runs
//   give the same bits.
// * Occupancy: 66,632 bytes of shared memory and 384 threads, one block an
//   SM; the r = 16 branch at 10,240 tokens has 480 query tiles, 240 blocks
//   for 132 SMs.
#include "flash_wgmma.cuh"

namespace mt {
namespace fwg {

template <int W>
__global__ void __launch_bounds__((W + 1) * wg::kWgThreads, W == 1 ? 2 : 1)
flash_fwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                    float scale) {
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * W;   // the block's first query tile
  const size_t q_row0 = static_cast<size_t>(bh) * Lq;
  const size_t k_row0 = static_cast<size_t>(bh) * Lk;
  extern __shared__ unsigned char smem_fwg[];
  const Frame f(smem_fwg);
  dwg::init_barriers(f.full, f.empty, f.own_bar, 4 * W);

  if (threadIdx.x >= W * wg::kWgThreads) {
    // ---- producer warpgroup: the own q tiles, then the live key tiles ----
    wg::give_registers<wg::kProducerRegs>();
    const int p = threadIdx.x - W * wg::kWgThreads;
#pragma unroll
    for (int w = 0; w < W; ++w) load_tile(f.smem + w * kTileBytes, q + q_row0 * kD, Lq, t0 + w, p);
    dwg::cp_async_arrive(f.own_bar);
    produce_keys(f.ring, f.full, f.empty, k + k_row0 * kD, v + k_row0 * kD,
                 bias == nullptr ? nullptr : bias + k_row0, Lk, p);
    return;
  }

  // ---- consumer warpgroup w: query rows [(t0 + w) 64, + 64) ----
  wg::take_registers<wg::kConsumerRegs<W>>();
  const int w = threadIdx.x / wg::kWgThreads;
  const unsigned char* q_tile = f.smem + w * kTileBytes;
  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float o[24], m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 24; ++i) o[i] = 0.f;
  wg::mbar_wait(f.own_bar, 0);
  dwg::fence_async_shared();

  wg::Ring r;
  const unsigned char* st;
  while (dwg::next_stage(st, f.ring, f.full, r)) {
    float s[32];
    wg::wgmma_fence();
    dwg::product_ss(s, q_tile, st);                              // q k^T
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(s);
    uint32_t pt[16];
    dwg::softmax_tile(s, pt, o, m_run, l_run,
                      reinterpret_cast<const float*>(st + Smem::kTerms), scale2, ln);
    wg::wgmma_fence();
    dwg::product_rs(o, pt, st + kTileBytes);                     // O += P v
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    dwg::hold(o);
    wg::hold(pt);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(f.empty + r.stage);
    r.advance<kStages>();
  }

  // rows past Lq are not written; a row without a valid key: 0, NEG_INF
  const int tile_row0 = (t0 + w) * kTile;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = wg::quad_sum(l_run[rr]);   // the whole warp shuffles
    const int row = tile_row0 + ln.row0 + 8 * rr;
    if (row >= Lq) continue;
    const bool live = l > 0.f;
    const float inv = live ? 1.f / l : 0.f;
    bf16* orow = out + (q_row0 + row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
    if (ln.col0 == 0) lse[q_row0 + row] = live ? (m_run[rr] + log2f(l)) * wg::kLn2 : kNegInf;
  }
}

}  // namespace fwg

// Consumer warpgroups a block of the forward, as the dilated forward core's
// kFwdWarpgroups.
constexpr int kFlashFwdWarpgroups = 2;

cudaError_t launch_flash_wgmma_fwd(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                   bf16* out, float* lse, int BH, int Lq, int Lk, float scale,
                                   cudaStream_t stream) {
  constexpr int W = kFlashFwdWarpgroups;
  const void* rows[4] = {q, k, v, out};   // cp.async reads 16-byte chunks
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  auto kernel = fwg::flash_fwd_wg_kernel<W>;
  const cudaError_t err = allow_smem(kernel, fwg::Smem::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((fwg::tiles_of(Lq) + W - 1) / W, BH);
  kernel<<<grid, (W + 1) * wg::kWgThreads, fwg::Smem::bytes, stream>>>(q, k, v, bias, out, lse,
                                                                       Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace mt
