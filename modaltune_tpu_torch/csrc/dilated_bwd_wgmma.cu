// The gradient core of the dilated attention backward on Hopper's tensor
// cores: bf16 at head dimension 48, K1b's and K3b's family for GigaPath.
//
// Replaces, with the prep and combine kernels of the two routes
// (dilated_attention_bwd.cu, dilated_fused_bwd.cu):
// modaltune_tpu/ops/dilated_mega.py::_mega_bwd_call and
// modaltune_tpu/ops/dilated_fused.py::_branch_bwd_call (the Pallas TPU
// kernels that recompute every branch's probabilities from its lse).
//
// Semantics, per compact row i (query) and j (key) of one (batch, head,
// branch, segment), with lse_i and w_i from the prep (dilated_wgmma.cuh):
//   P_ij  = exp(q_i.k_j * scale - lse_i)   (0 for a masked key, a row that
//                                            is no real position, or a row
//                                            whose lse is NEG_INF)
//   delta_i = w_i sum_j P_ij dmix_i.v_j    (= w_i dmix_i.o_i, o_i the
//                                            branch's output, never formed)
//   dS_ij = P_ij (w_i dmix_i.v_j - delta_i)
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij w_i dmix_i
// written as fp32 compact rows, delta_i too. The plain oracle is
// ops/dilated_fused.py::fused_branch_backward_reference. The Pallas kernels
// take delta the same way, from P and dP in fp32 inside the tile, and keep
// no branch output; nor does the port's forward.
//
// What bounds it on the H100: operations. The five products are 10 pairs D
// flop, 0.669 ms at the train step's (3, 10240, 16, 48) and 9,000 valid
// tokens; one exp2 a pair in each kernel on the special-function units and
// the elementwise work of P and dS run beside them. Delta costs no product
// that the function needs.
//
// The design (the card's choices, each a decision of this file):
// * Two kernels without atomics, so two runs give the same bits: the dq
//   kernel's block owns 64 query rows and streams the key tiles, the dk/dv
//   kernel's owns 64 key rows and streams the query tiles, both on K4's
//   frame: W = 1 consumer warpgroup running every product as wgmma with fp32
//   accumulation, one producer warpgroup filling a ring of four stages,
//   setmaxnreg moving registers to the consumer, two blocks an SM. q.k and
//   dmix.v run in both kernels (seven products for five, eight with
//   delta's P k), as in K4b.
// * Delta in the dq kernel, which writes it per compact row for the dk/dv
//   kernel launched after it on the same stream, in one pass over the live
//   key tiles: a second accumulator B_i = sum_j P_ij k_j beside
//   A_i = sum_j P_ij w_i dP_ij k_j (one more product, P as hi + lo parts),
//   and dq_i = scale (A_i - delta_i B_i) at the end. A thread sums P dP over
//   its columns in key-tile order, then over its quad (lanes ^1, then ^2).
//   Two designs were built and read on the H100 (NVIDIA H100 80GB HBM3,
//   700.00 W): K1b at (3, 25600, 16, 48) took 18.751 card ms with this one
//   and 24.516 with two passes (a first stream of the key tiles for delta,
//   then today's dS); the extra product hides behind the exp2 and
//   elementwise work where a second stream of the key tiles does not.
// * Compact tiles (K3's geometry, locate_tile): every row of a block's tile
//   belongs to its (segment, head group), so a 64-row wgmma tile wastes
//   products only at a group's ragged end; K1b reaches the same tiles
//   through its own prep, where its old blocks of 64 consecutive positions
//   held 64 / r rows of a branch.
// * The frame of dilated_wgmma_frame.cuh, which the forward core shares:
//   tiles of three 16-column slabs in the 32-byte swizzle, S = q k^T and
//   dP = dmix v^T as K-major products, dq += dS k, dk += dS^T q and
//   dv += P^T dmix as m64n48k16 (nothing padded to 64 columns), rows
//   gathered by a producer warpgroup with cp.async, zero-filled past a
//   group's end.
// * Masking without a branch: a key's term is 0 or -inf (its tile's mask
//   bytes, read by the producer), a query's lse2 is lse log2(e) or +1e30,
//   and P = exp2(s scale log2(e) + key term - lse2) is exactly 0 for every
//   masked pair. The dq kernel streams only the live key tiles, as the
//   forward core does (produce_key_tiles). A dk/dv block whose own keys
//   are all masked writes zeros and leaves (the combine reads those rows).
// * Precision: P and dS enter every product that takes them as two bf16
//   parts, hi = bf16(x) and lo = bf16(x - hi) (two wgmma into one fp32
//   accumulator), as K2's short-side kernels take them: rounded once, the
//   CPU emulation (tests/test_torch_dilated_bwd.py) reads 1.4x the
//   gradients' own bf16 rounding, and in K2 sums over thousands of rows
//   that cancel failed the train step's per-tensor gradient gate.
#include "dilated_wgmma_frame.cuh"

namespace mt {
namespace dwg {

// dq and delta: the own rows are queries (their q and dmix tiles stay in
// shared memory; lse2, w and delta in registers); a stage is a live key
// tile's k and v with the keys' terms (0 or -inf).
__global__ void __launch_bounds__(kThreads, 2)
dilated_bwd_dq_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dmix,
                         const unsigned char* __restrict__ mask, const float* __restrict__ lse_c,
                         const float* __restrict__ w_c, float* __restrict__ delta_c,
                         float* __restrict__ dq_c, int L, int H, float scale, FusedBranches fb) {
  const Group g(fb, blockIdx.x, blockIdx.y, blockIdx.z, L, H);
  const int n_own = g.ft.n_own, n_rows = g.ft.n_rows;
  const size_t own_row0 = g.rows0 + g.ft.l0;
  if (n_own == 0) {   // no real row: zeros, as every row past n_real gets
    zero_rows(dq_c + own_row0 * kD, n_rows);
    for (int i = threadIdx.x; i < n_rows; i += kThreads) delta_c[own_row0 + i] = 0.f;
    return;
  }
  extern __shared__ unsigned char smem_dwg[];
  unsigned char* smem = aligned_smem(smem_dwg);
  unsigned char* ring = smem + Smem::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own_bar = empty + kStages;
  const int own_t = g.ft.l0 / kTile;
  init_barriers(full, empty, own_bar, 4);

  if (threadIdx.x >= wg::kWgThreads) {
    // ---- producer warpgroup: gathers the own tiles, then the live key
    // tiles
    wg::give_registers<wg::kProducerRegs>();
    const int p = threadIdx.x - wg::kWgThreads;
    gather(smem, q, g, own_t, p);
    gather(smem + kTileBytes, dmix, g, own_t, p);
    cp_async_arrive(own_bar);
    produce_key_tiles(ring, full, empty, k, v, mask, g, p);
    return;
  }

  // ---- consumer warpgroup: own query rows [l0, l0 + 64) of the group ----
  wg::take_registers<wg::kConsumerRegs<1>>();
  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float lse2[2], w[2], delta[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    const bool real = row < n_own;
    const size_t at = own_row0 + (real ? row : 0);
    lse2[rr] = lse2_of(lse_c[at], real);
    w[rr] = real ? w_c[at] : 0.f;
  }
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.f;
  wg::mbar_wait(own_bar, 0);
  fence_async_shared();

  wg::Ring r;
  const unsigned char* st;
  float acc_b[24];   // B = sum_j P_ij k_j
#pragma unroll
  for (int i = 0; i < 24; ++i) acc_b[i] = 0.f;
  while (next_stage(st, ring, full, r)) {
    float s[32], dp[32];
    wg::wgmma_fence();
    product_ss(s, smem, st);                                  // q k^T
    product_ss(dp, smem + kTileBytes, st + kTileBytes);       // dmix v^T
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(s);
    wg::hold(dp);
    probabilities(s, dp, rs, reinterpret_cast<const float*>(st + Smem::kTerms), lse2, scale2,
                  ln);
    uint32_t hi[16], lo[16], p_hi[16], p_lo[16];
    pack_parts(p_hi, p_lo, s);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= w[(i >> 1) & 1] * dp[i];   // P w dP
    pack_parts(hi, lo, s);
    wg::wgmma_fence();
    product_rs(acc, hi, st);                                  // A += P w dP k
    product_rs(acc, lo, st);
    product_rs(acc_b, p_hi, st);                              // B += P k
    product_rs(acc_b, p_lo, st);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    hold(acc_b);
    wg::hold(p_hi);
    wg::hold(p_lo);
    hold(acc);
    wg::hold(hi);
    wg::hold(lo);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(empty + r.stage);
    r.advance<kStages>();
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) delta[rr] = w[rr] * wg::quad_sum(rs[rr]);
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = fmaf(-delta[(i >> 1) & 1], acc_b[i], acc[i]);
  if (ln.col0 == 0) {   // one lane of a row's quad writes its delta
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = ln.row0 + 8 * rr;
      if (row < n_rows) delta_c[own_row0 + row] = row < n_own ? delta[rr] : 0.f;
    }
  }
  store_rows(dq_c + own_row0 * kD, acc, n_rows, scale, ln);
}

// dk/dv: the own rows are keys (their k and v tiles stay in shared memory,
// their terms in registers); a stage is a query tile's q and dmix with the
// queries' lse2, w and delta (+1e30, 0, 0 past n_real). The score tiles are
// computed transposed, S^T = k q^T and dP^T = v dmix^T, and P^T w and dS^T
// feed dv += (P^T w) dmix and dk += dS^T q from registers.
__global__ void __launch_bounds__(kThreads, 2)
dilated_bwd_dkv_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dmix,
                          const unsigned char* __restrict__ mask, const float* __restrict__ lse_c,
                          const float* __restrict__ w_c, const float* __restrict__ delta_c,
                          float* __restrict__ dk_c, float* __restrict__ dv_c, int L, int H,
                          float scale, FusedBranches fb) {
  const Group g(fb, blockIdx.x, blockIdx.y, blockIdx.z, L, H);
  const int n_rows = g.ft.n_rows;
  const size_t own_row0 = g.rows0 + g.ft.l0;
  const int own_t = g.ft.l0 / kTile;
  const bool live =
      __syncthreads_or(threadIdx.x < kTile && g.valid_key(g.ft.l0 + threadIdx.x, mask));
  if (!live) {   // every own key masked, or no real row: zero gradients
    zero_rows(dk_c + own_row0 * kD, n_rows);
    zero_rows(dv_c + own_row0 * kD, n_rows);
    return;
  }
  extern __shared__ unsigned char smem_dwg[];
  unsigned char* smem = aligned_smem(smem_dwg);
  unsigned char* ring = smem + Smem::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own_bar = empty + kStages;
  init_barriers(full, empty, own_bar, 4);

  if (threadIdx.x >= wg::kWgThreads) {
    // ---- producer warpgroup: the own tiles, then every query tile ----
    wg::give_registers<wg::kProducerRegs>();
    const int p = threadIdx.x - wg::kWgThreads;
    gather(smem, k, g, own_t, p);
    gather(smem + kTileBytes, v, g, own_t, p);
    cp_async_arrive(own_bar);
    wg::Ring r;
    int t_lo, t_hi;   // a query tile wholly outside fb's range adds nothing
    g.query_tiles(fb.q0, fb.q1, t_lo, t_hi);
    for (int t = t_lo; t < t_hi; ++t) {
      wg::mbar_wait(empty + r.stage, r.phase ^ 1);
      unsigned char* st = ring + r.stage * Smem::kStageBytes;
      gather(st, q, g, t, p);
      gather(st + kTileBytes, dmix, g, t, p);
      cp_async_arrive(full + r.stage);
      if ((p & 1) == 0) {
        const int l = t * kTile + (p >> 1);
        const bool real = l < g.ft.n_real;
        const size_t at = g.rows0 + (real ? l : 0);
        float* terms = reinterpret_cast<float*>(st + Smem::kTerms) + (p >> 1);
        terms[0] = lse2_of(lse_c[at], real);
        terms[kTile] = real ? w_c[at] : 0.f;
        terms[2 * kTile] = real ? delta_c[at] : 0.f;
      }
      if (p == 0) *reinterpret_cast<int*>(st + Smem::kEnd) = 0;
      wg::mbar_arrive(full + r.stage);
      r.advance<kStages>();
    }
    producer_finish(ring, full, empty, r, p);
    return;
  }

  // ---- consumer warpgroup: own key rows [l0, l0 + 64) of the group ----
  wg::take_registers<wg::kConsumerRegs<1>>();
  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float kterm[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kterm[rr] = g.valid_key(g.ft.l0 + ln.row0 + 8 * rr, mask) ? 0.f : -INFINITY;
  float acc_dk[24], acc_dv[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  wg::mbar_wait(own_bar, 0);
  fence_async_shared();

  wg::Ring r;
  for (;;) {
    const unsigned char* st;
    if (!next_stage(st, ring, full, r)) break;
    float s[32], dp[32];
    wg::wgmma_fence();
    product_ss(s, smem, st);                                  // k q^T
    product_ss(dp, smem + kTileBytes, st + kTileBytes);       // v dmix^T
    wg::wgmma_commit();
    const float* terms = reinterpret_cast<const float*>(st + Smem::kTerms);
    wg::wgmma_wait<0>();
    wg::hold(s);
    wg::hold(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + ln.col0;
      const float2 ls = *reinterpret_cast<const float2*>(terms + c);
      const float2 ww = *reinterpret_cast<const float2*>(terms + kTile + c);
      const float2 dl = *reinterpret_cast<const float2*>(terms + 2 * kTile + c);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr;
        const float p0 = wg::exp2_fast(fmaf(s[i], scale2, kterm[rr] - ls.x));
        const float p1 = wg::exp2_fast(fmaf(s[i + 1], scale2, kterm[rr] - ls.y));
        dp[i] = p0 * fmaf(ww.x, dp[i], -dl.x);               // dS^T
        dp[i + 1] = p1 * fmaf(ww.y, dp[i + 1], -dl.y);
        s[i] = p0 * ww.x;                                    // P^T w
        s[i + 1] = p1 * ww.y;
      }
    }
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    pack_parts(p_hi, p_lo, s);
    pack_parts(ds_hi, ds_lo, dp);
    wg::wgmma_fence();
    product_rs(acc_dv, p_hi, st + kTileBytes);                // dv += P^T w dmix
    product_rs(acc_dv, p_lo, st + kTileBytes);
    product_rs(acc_dk, ds_hi, st);                            // dk += dS^T q
    product_rs(acc_dk, ds_lo, st);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    hold(acc_dv);
    hold(acc_dk);
    wg::hold(p_hi);
    wg::hold(p_lo);
    wg::hold(ds_hi);
    wg::hold(ds_lo);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(empty + r.stage);
    r.advance<kStages>();
  }
  store_rows(dk_c + own_row0 * kD, acc_dk, n_rows, scale, ln);
  store_rows(dv_c + own_row0 * kD, acc_dv, n_rows, 1.f, ln);
}

}  // namespace dwg

namespace {

cudaError_t check_core(const DilatedBwdCore& a) {
  const void* rows[4] = {a.q, a.k, a.v, a.dmix};   // cp.async reads 16-byte chunks
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaError_t err = allow_smem(dwg::dilated_bwd_dq_wg_kernel,
                               dwg::Smem::bytes);
  if (err == cudaSuccess) err = allow_smem(dwg::dilated_bwd_dkv_wg_kernel, dwg::Smem::bytes);
  return err;
}

}  // namespace

cudaError_t launch_dilated_bwd_dq(const DilatedBwdCore& a, const FusedBranches& fb,
                                  cudaStream_t stream) {
  cudaError_t err = check_core(a);
  if (err != cudaSuccess) return err;
  // dq and delta only on the tiles of the query range (the combine reads no
  // other row of dq_c, the dk/dv kernel no other row of delta_c)
  const FusedBranches fq = query_tiles(fb, a.L);
  const dim3 grid(fq.tile0[fq.n], a.H, a.B);
  dwg::dilated_bwd_dq_wg_kernel<<<grid, dwg::kThreads, dwg::Smem::bytes,
                                                     stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dmix), a.mask, a.lse_c, a.w_c,
      a.delta_c, a.dq_c, a.L, a.H, a.scale, fq);
  return cudaGetLastError();
}

cudaError_t launch_dilated_bwd_dkv(const DilatedBwdCore& a, const FusedBranches& fk,
                                   cudaStream_t stream) {
  cudaError_t err = check_core(a);
  if (err != cudaSuccess) return err;
  const dim3 grid(fk.tile0[fk.n], a.H, a.B);
  dwg::dilated_bwd_dkv_wg_kernel<<<grid, dwg::kThreads, dwg::Smem::bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dmix), a.mask, a.lse_c, a.w_c,
      a.delta_c, a.dk_c, a.dv_c, a.L, a.H, a.scale, fk);
  return cudaGetLastError();
}

// dq and delta on the range's query tiles, then dk/dv on every key tile over
// the range's query tiles, after the dq kernel on the same stream
cudaError_t launch_dilated_bwd_core(const DilatedBwdCore& a, const FusedBranches& fb,
                                    cudaStream_t stream) {
  const cudaError_t err = launch_dilated_bwd_dq(a, fb, stream);
  return err == cudaSuccess ? launch_dilated_bwd_dkv(a, fb, stream) : err;
}

}  // namespace mt

// Which kernels serve a dilated attention (mt::dilated_family): 0 the
// CUDA-core kernels, 1 the tensor-core cores of this file and
// dilated_fwd_wgmma.cu, 2 the 3xTF32 cores of dilated_fwd_tf32.cu and
// dilated_bwd_tf32.cu.
extern "C" int mt_dilated_family(int D, int dtype) {
  return mt::dilated_family(D, dtype);
}
