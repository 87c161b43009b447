// The forward core of the dilated attention at fp32 on Hopper's tensor
// cores: fp32 at head dimension 48 (GigaPath's), K1f's and K3f's family for
// an fp32 backbone (the CLI's --bf16 0).
//
// Replaces, with the mix kernel of dilated_fused_fwd.cu that both routes
// run after it: modaltune_tpu/ops/dilated_mega.py::_mega_fwd_call and
// modaltune_tpu/ops/dilated_fused.py::_branch_fwd_call at fp32, where every
// dot of the Pallas kernels runs at Precision.HIGHEST (exact fp32).
//
// Semantics: those of the bf16 forward core (dilated_fwd_wgmma.cu, which
// states them; the contract is dilated_wgmma.cuh's DilatedFwdCore) on fp32
// q, k, v: per compact row the branch's output out_c (B, H, M, 48) fp32 and
// lse_c (B, H, M) fp32, 0 and NEG_INF where the row is no real position or
// has no valid key. The plain oracle is
// ops/dilated_fused.py::fused_branch_reference.
//
// What bounds it on the H100: operations. At fp32 accuracy each of the two
// products is three TF32 products: 3 x 4 pairs D flop at 495 TFLOP/s dense
// TF32, 1.60 ms at the train step's (3, 10240, 16, 48) and 9,000 valid
// tokens, against 3.95 ms for the two products on the CUDA cores at 67
// TFLOP/s. The CUDA-core kernels it replaces at fp32 read 25.90 ms there
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py); K1f on this core reads
// 6.96 ms (card 6.74, of which the mix 0.15), 4.3x the bound; the kernel
// takes 207 registers, no spill, two blocks an SM.
//
// The design (the 3xTF32 products, the mma.sync fragments, the padded rows
// and the key stream are dilated_tf32.cuh's, shared with the gradient core
// dilated_bwd_tf32.cu):
// * One kernel, no atomics, so two runs give the same bits: a block is four
//   warps of 16 own rows of one 64-row compact query tile and streams the
//   live key tiles of its (segment, head group) through a two-stage ring of
//   cp.async gathers; a dead key tile is never loaded.
// * The own q tile is split into its TF32 hi + lo A fragments once, into
//   registers (48 a thread), and is not read again.
// * A stage is multiplied in two halves of 32 keys: S = q k^T (3xTF32), the
//   bf16 cores' online softmax in registers (dwg::online_softmax: base 2, the
//   key term 0 or -inf folded into one FMA with the scale, the running max
//   shared in a quad, the row sum a per-thread partial until the end, O
//   rescaled), then O += P v with P split hi + lo in registers and S's C
//   fragments reused as A fragments. The tensor cores accumulate by
//   truncation, so each half's P v goes into fresh fragments that fp32
//   adds add to O.
// * Shared memory: the own tile, then two stages of a k and a v tile and
//   their keys' terms: 67,072 bytes.
#include "dilated_tf32.cuh"

namespace mt {
namespace dtf {

// Shared memory of the forward core, in floats: the own q tile, then the
// ring; a stage is a key tile's k and v and its keys' terms.
struct FwdSmem {
  static constexpr int kRing = kTileFloats;
  static constexpr int kTerms = 2 * kTileFloats;
  static constexpr int kStageFloats = kTerms + kTile;
  static constexpr size_t bytes = sizeof(float) * (kRing + kStages * kStageFloats);
  static_assert(kStageFloats % 4 == 0, "16-byte stages");
  static_assert(2 * bytes <= 232448, "two blocks an SM");
};

__global__ void __launch_bounds__(kThreads, 2)
dilated_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const unsigned char* __restrict__ mask,
                        float* __restrict__ out_c, float* __restrict__ lse_c, int L, int H,
                        float scale, FusedBranches fb) {
  const Group g(fb, blockIdx.x, blockIdx.y, blockIdx.z, L, H);
  const int n_own = g.ft.n_own, n_rows = g.ft.n_rows, n_tiles = g.n_tiles();
  const size_t own_row0 = g.rows0 + g.ft.l0;
  if (n_own == 0) {   // no real row: 0 and NEG_INF, as every row past n_real gets
    dwg::zero_rows(out_c + own_row0 * kD, n_rows);
    for (int i = threadIdx.x; i < n_rows; i += kThreads) lse_c[own_row0 + i] = kNegInf;
    return;
  }
  extern __shared__ float4 smem_dtf[];
  float* own = reinterpret_cast<float*>(smem_dtf);
  float* ring = own + FwdSmem::kRing;
  gather(own, q, g, g.ft.l0 / kTile);
  cp_async_commit();
  float term = 0.f;
  int t = next_live(g, mask, 0, term);
  if (t < n_tiles) {
    gather(ring, k, g, t);
    gather(ring + kTileFloats, v, g, t);
    if (threadIdx.x < kTile) ring[FwdSmem::kTerms + threadIdx.x] = term;
  }
  cp_async_commit();
  cp_async_wait<1>();   // the own tile
  __syncthreads();

  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  Frag qf[kD / 8];
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) qf[kk] = row_frag(own, kk, ln);
  float o[24], m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 24; ++i) o[i] = 0.f;

  for (int stage = 0; t < n_tiles; stage ^= 1) {
    // scanning is a barrier: no warp still reads the stage the next tile fills
    const int next = next_live(g, mask, t + 1, term);
    if (next < n_tiles) {
      float* nst = ring + (stage ^ 1) * FwdSmem::kStageFloats;
      gather(nst, k, g, next);
      gather(nst + kTileFloats, v, g, next);
      if (threadIdx.x < kTile) nst[FwdSmem::kTerms + threadIdx.x] = term;
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = ring + stage * FwdSmem::kStageFloats;
#pragma unroll 1
    for (int h = 0; h < kTile; h += kHalf) {   // keys [h, h + 32) of the tile
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) scores_step(s, qf[kk], st + h * kStride, kk, ln);
      dwg::online_softmax(s, o, m_run, l_run, st + FwdSmem::kTerms + h, scale2, ln);
      product(o, s, st + kTileFloats + h * kStride, ln);        // O += P v
    }
    t = next;
  }
  cp_async_wait<0>();

  // rows past the group's real ones, and rows without a valid key: 0, NEG_INF
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = wg::quad_sum(l_run[rr]);   // the whole warp shuffles
    const int row = ln.row0 + 8 * rr;
    if (row >= n_rows) continue;
    const bool live = row < n_own && l > 0.f;
    const float inv = live ? 1.f / l : 0.f;
    float* orow = out_c + (own_row0 + row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[i] * inv, o[i + 1] * inv);
    }
    if (ln.col0 == 0) lse_c[own_row0 + row] = live ? (m_run[rr] + log2f(l)) * wg::kLn2 : kNegInf;
  }
}

}  // namespace dtf

cudaError_t launch_dilated_fwd_core_tf32(const DilatedFwdCore& a, const FusedBranches& fb,
                                         cudaStream_t stream) {
  const void* rows[3] = {a.q, a.k, a.v};   // cp.async reads 16-byte chunks
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const cudaError_t err = allow_smem(dtf::dilated_fwd_tf32_kernel, dtf::FwdSmem::bytes);
  if (err != cudaSuccess) return err;
  // only the tiles of the query range (K1's q_token_range); the mix reads
  // no other compact row
  const FusedBranches fq = query_tiles(fb, a.L);
  dtf::dilated_fwd_tf32_kernel<<<dim3(fq.tile0[fq.n], a.H, a.B), dtf::kThreads,
                                 dtf::FwdSmem::bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.out_c), a.lse_c, a.L, a.H,
      a.scale, fq);
  return cudaGetLastError();
}

}  // namespace mt
