// The forward core of the dilated attention on Hopper's tensor cores: bf16
// at head dimension 48, K1f's and K3f's family for GigaPath.
//
// Replaces, with the mix kernel of dilated_fused_fwd.cu that both routes
// run after it: modaltune_tpu/ops/dilated_mega.py::_mega_fwd_call and
// modaltune_tpu/ops/dilated_fused.py::_branch_fwd_call (the Pallas TPU
// kernels that run every branch's softmax attention over its sparse rows).
//
// Semantics, per compact row i (query) and j (key) of one (batch, head,
// branch, segment) (dilated_wgmma.cuh): out_b,i = softmax_j(q_i.k_j scale)
// v over the real rows j at valid positions, lse_b,i its log-normaliser;
// out 0 and lse NEG_INF for a row that is no real position or has no valid
// key. Written as compact out_c (B, H, M, 48) bf16 and lse_c (B, H, M) fp32.
// The plain oracle is ops/dilated_fused.py::fused_branch_reference.
//
// What bounds it on the H100: operations. The two products are 4 pairs D
// flop, 0.268 ms at the train step's (3, 10240, 16, 48) and 9,000 valid
// tokens; one exp2 an element (0.38 ms at 16 a clock and SM) and the online
// softmax's handful of fp32 operations an element run beside them.
//
// The design:
// * The gradient core's frame (dilated_wgmma_frame.cuh): a block owns
//   compact 64-row tiles of one (segment, head group), so every row of a
//   wgmma tile takes part; a producer warpgroup gathers the own q tiles
//   once, then streams the group's live k/v tiles with their keys' terms
//   through a ring of four stages and ends with the sentinel; dead key tiles
//   are never loaded; D = 48 is three 16-column slabs, never padded to 64.
// * W = 2 consumer warpgroups a block (kFwdWarpgroups), each owning one of
//   two consecutive tiles of the group (a span, dilated_fused_common.cuh;
//   the second tile of a group's last span may hold no row) and both
//   reading each k/v stage, so a stage's gather serves 128 query rows:
//   S = q k^T is m64n64k16 in three 16-deep steps, O += P v is m64n48k16 in
//   four, each waited for.
// * The online softmax in registers, as K4f's (alibi_attention_fwd.cu):
//   scores in base 2 with scale log2(e) and the key term (0 or -inf) folded
//   into one FMA, the running max shared within a quad by shuffles, the row
//   sum a per-thread partial until the end, O rescaled in registers, P
//   packed to bf16 as the register operand of the second product.
// * Precision: P enters P v rounded once to bf16; its row sum is taken in
//   fp32. The CPU emulation (tests/test_torch_dilated_fwd.py) holds the
//   outputs, and the gradients computed from them, at the limits of
//   chip_smoke.py and within 1.2x the results' own bf16 rounding.
// * No atomics: each output row is written by one thread quad, so two runs
//   give the same bits.
#include "dilated_wgmma_frame.cuh"

namespace mt {
namespace dwg {

// Rows [l0, l0 + n) of a group as rows without a key: out 0, lse NEG_INF,
// written by the whole block.
__device__ __forceinline__ void empty_rows(bf16* out_c, float* lse_c, size_t row0, int n,
                                           int threads) {
  for (int i = threadIdx.x; i < n * kD / 2; i += threads)
    reinterpret_cast<__nv_bfloat162*>(out_c + row0 * kD)[i] = __floats2bfloat162_rn(0.f, 0.f);
  for (int i = threadIdx.x; i < n; i += threads) lse_c[row0 + i] = kNegInf;
}

template <int W>
__global__ void __launch_bounds__((W + 1) * wg::kWgThreads, W == 1 ? 2 : 1)
dilated_fwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                      bf16* __restrict__ out_c, float* __restrict__ lse_c, int L, int H,
                      float scale, FusedBranches fb) {
  constexpr int kBlockThreads = (W + 1) * wg::kWgThreads;
  const int h = blockIdx.y, b = blockIdx.z;
  // the group of the block's first tile; its other tiles follow it
  const Group g(fb, locate_tile<W>(fb, blockIdx.x, h, H, L, 0), h, b, L, H);
  if (g.ft.n_own == 0) {   // no real row in any of the block's tiles
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const FusedTile ft = locate_tile<W>(fb, blockIdx.x, h, H, L, w);
      empty_rows(out_c, lse_c, g.rows0 + ft.l0, ft.n_rows, kBlockThreads);
    }
    return;
  }
  extern __shared__ unsigned char smem_dwg[];
  unsigned char* smem = aligned_smem(smem_dwg);
  unsigned char* ring = smem + Smem::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own_bar = empty + kStages;
  init_barriers(full, empty, own_bar, 4 * W);

  if (threadIdx.x >= W * wg::kWgThreads) {
    // ---- producer warpgroup: the own q tiles, then the live key tiles ----
    wg::give_registers<wg::kProducerRegs>();
    const int p = threadIdx.x - W * wg::kWgThreads;
#pragma unroll
    for (int w = 0; w < W; ++w) gather(smem + w * kTileBytes, q, g, g.ft.l0 / kTile + w, p);
    cp_async_arrive(own_bar);
    produce_key_tiles(ring, full, empty, k, v, mask, g, p);
    return;
  }

  // ---- consumer warpgroup w: own query rows [l0, l0 + 64) of the group ----
  wg::take_registers<wg::kConsumerRegs<W>>();
  const int w = threadIdx.x / wg::kWgThreads;
  const FusedTile ft = W == 1 ? g.ft : locate_tile<W>(fb, blockIdx.x, h, H, L, w);
  const unsigned char* q_tile = smem + w * kTileBytes;
  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float o[24], m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 24; ++i) o[i] = 0.f;
  wg::mbar_wait(own_bar, 0);
  fence_async_shared();

  wg::Ring r;
  const unsigned char* st;
  while (next_stage(st, ring, full, r)) {
    float s[32];
    wg::wgmma_fence();
    product_ss(s, q_tile, st);                                  // q k^T
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(s);
    uint32_t pt[16];
    softmax_tile(s, pt, o, m_run, l_run, reinterpret_cast<const float*>(st + Smem::kTerms),
                 scale2, ln);
    wg::wgmma_fence();
    product_rs(o, pt, st + kTileBytes);                         // O += P v
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    hold(o);
    wg::hold(pt);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(empty + r.stage);
    r.advance<kStages>();
  }

  // rows past the group's real ones, and rows without a valid key: 0, NEG_INF
  const size_t row0 = g.rows0 + ft.l0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = wg::quad_sum(l_run[rr]);   // the whole warp shuffles
    const int row = ln.row0 + 8 * rr;
    if (row >= ft.n_rows) continue;
    const bool live = row < ft.n_own && l > 0.f;
    const float inv = live ? 1.f / l : 0.f;
    bf16* orow = out_c + (row0 + row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
    if (ln.col0 == 0) lse_c[row0 + row] = live ? (m_run[rr] + log2f(l)) * wg::kLn2 : kNegInf;
  }
}

}  // namespace dwg

// The forward core as it is built: W = 2 consumer warpgroups a block, which
// share every k/v stage; PERF.md has the card's readings of W = 1 and of
// scores issued a key tile ahead of the softmax.
constexpr int kFwdWarpgroups = 2;

cudaError_t launch_dilated_fwd_core(const DilatedFwdCore& a, const FusedBranches& fb,
                                    cudaStream_t stream) {
  constexpr int W = kFwdWarpgroups;
  using dwg::Smem;
  const void* rows[3] = {a.q, a.k, a.v};   // cp.async reads 16-byte chunks
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  auto kernel = dwg::dilated_fwd_wg_kernel<W>;
  const cudaError_t err = allow_smem(kernel, Smem::bytes);
  if (err != cudaSuccess) return err;
  // only the tiles of the query range (K1's q_token_range); the mix reads
  // no other compact row
  const FusedBranches fq = query_tiles(fb, a.L);
  const dim3 grid(W == 1 ? fq.tile0[fq.n] : fq.span0[fq.n], a.H, a.B);
  kernel<<<grid, (W + 1) * wg::kWgThreads, Smem::bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, static_cast<bf16*>(a.out_c), a.lse_c, a.L, a.H,
      a.scale, fq);
  return cudaGetLastError();
}

}  // namespace mt
