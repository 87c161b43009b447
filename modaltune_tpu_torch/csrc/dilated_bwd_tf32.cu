// The gradient core of the dilated attention backward at fp32 on Hopper's
// tensor cores: fp32 at head dimension 48 (GigaPath's), K1b's and K3b's
// family for training with an fp32 backbone (the CLI's --bf16 0).
//
// Replaces, with the prep and combine kernels of the two routes
// (dilated_attention_bwd.cu, dilated_fused_bwd.cu):
// modaltune_tpu/ops/dilated_mega.py::_mega_bwd_call and
// modaltune_tpu/ops/dilated_fused.py::_branch_bwd_call at fp32, where every
// dot of the Pallas kernels runs at Precision.HIGHEST (exact fp32).
//
// Semantics: those of the bf16 core (dilated_bwd_wgmma.cu, which states
// them) on fp32 q, k, v and dmix: per compact row the branch's P from its
// lse, delta = w rowsum(P dP) taken in the dq kernel, dS = P (w dP - delta),
// and fp32 compact dq, dk, dv and delta, zeros in every row that is no real
// position. The plain oracle is
// ops/dilated_fused.py::fused_branch_backward_reference.
//
// What bounds it on the H100: operations. At fp32 accuracy each of the five
// products is three TF32 products (below): 3 x 10 pairs D flop at 495
// TFLOP/s dense TF32, 4.0 ms at the train step's (3, 10240, 16, 48) and
// 9,000 valid tokens, against 9.9 ms for the five products on the CUDA
// cores at 67 TFLOP/s. The kernels run eight products (q.k and dmix.v in
// both, delta's P k in the dq kernel), as the bf16 core does. Read there
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): K1b 25.67 ms, 6.4x the
// bound (dq kernel 11.57, dk/dv 13.12 card ms), where the CUDA-core
// kernels it replaces at fp32 took 305.57.
//
// The design (each point a decision of this file; the 3xTF32 products, the
// mma.sync fragments and the padded rows are dilated_tf32.cuh's, shared
// with the forward core dilated_fwd_tf32.cu):
// * P, P w dP and dS are split into TF32 hi + lo in registers, and the
//   products of dq, dk and dv sum each half tile into fresh fragments (the
//   tensor cores accumulate by truncation).
// * A stage is multiplied in two halves of 32 keys (queries in the dk/dv
//   kernel): the score tiles, P, dS and the partial fragments of a half
//   fit the registers beside the accumulators without a spill.
// * Two kernels without atomics, so two runs give the same bits, as the
//   bf16 core: the dq kernel's block owns 64 compact query rows and streams
//   the live key tiles of its (segment, head group), taking delta in its
//   one pass (B_i = sum_j P_ij k_j beside A_i = sum_j P_ij w_i dP_ij k_j,
//   dq_i = scale (A_i - delta_i B_i)) and writing it per compact row; the
//   dk/dv kernel, launched after it on the same stream, owns 64 key rows
//   and streams the query tiles of the range. A block is four warps of 16
//   own rows; every thread gathers its share of the next tile with 16-byte
//   cp.async (zero-filled past the group's n_real) into the other stage of
//   a two-stage ring while the current one is multiplied.
// * Shared memory: two own tiles of 52-float rows, then two stages of two
//   tiles and their rows' terms: 81,408 bytes, two blocks an SM. No
//   transposed copy is kept.
// * Masking as the bf16 core: a key's term is 0 or -inf, a query's lse2 is
//   lse log2(e) or +1e30, so P is exactly 0 for every masked pair; the dq
//   kernel never loads a key tile without a valid key, a dk/dv block whose
//   own keys are all masked writes zeros.
#include "dilated_tf32.cuh"

namespace mt {
namespace dtf {

// acc1 += X1 B and acc2 += X2 B on one load of B's fragments.
__device__ __forceinline__ void product2(float (&acc1)[24], const float (&x1)[16],
                                         float (&acc2)[24], const float (&x2)[16],
                                         const float* b, const wg::Lane& ln) {
  float t1[24] = {}, t2[24] = {};
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    const Frag f1 = from_scores(x1, j), f2 = from_scores(x2, j);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      uint32_t bh[2], bl[2];
      row_pair(b, j, m, ln, bh, bl);
      mma3(t1 + 4 * m, f1.hi, f1.lo, bh, bl);
      mma3(t2 + 4 * m, f2.hi, f2.lo, bh, bl);
    }
  }
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    acc1[i] += t1[i];
    acc2[i] += t2[i];
  }
}

// A query tile's row terms, fetched by threads below 64 into registers, so
// that their loads overlap the products: lse, w and delta of row
// t * 64 + threadIdx.x.
struct QueryTerms {
  float lse, w, delta;
  bool real;
  __device__ void fetch(const Group& g, const float* lse_c, const float* w_c,
                        const float* delta_c, int t) {
    const int l = t * kTile + threadIdx.x;
    real = l < g.ft.n_real;
    const size_t at = g.rows0 + (real ? l : 0);
    lse = lse_c[at];
    w = w_c[at];
    delta = delta_c[at];
  }
  // lse2, w and delta (+1e30, 0, 0 past n_real) into a stage's terms
  __device__ void store(float* terms) const {
    terms[threadIdx.x] = dwg::lse2_of(lse, real);
    terms[kTile + threadIdx.x] = real ? w : 0.f;
    terms[2 * kTile + threadIdx.x] = real ? delta : 0.f;
  }
};

// ---- the kernels --------------------------------------------------------------

// dq and delta: the own rows are queries (their q and dmix tiles stay in
// shared memory; lse2, w, delta and rowsum(P dP) in registers); a stage is a
// live key tile's k and v with the keys' terms.
__global__ void __launch_bounds__(kThreads, 2)
dilated_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dmix,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ lse_c, const float* __restrict__ w_c,
                           float* __restrict__ delta_c, float* __restrict__ dq_c, int L, int H,
                           float scale, FusedBranches fb) {
  const Group g(fb, blockIdx.x, blockIdx.y, blockIdx.z, L, H);
  const int n_own = g.ft.n_own, n_rows = g.ft.n_rows, n_tiles = g.n_tiles();
  const size_t own_row0 = g.rows0 + g.ft.l0;
  if (n_own == 0) {   // no real row: zeros, as every row past n_real gets
    dwg::zero_rows(dq_c + own_row0 * kD, n_rows);
    for (int i = threadIdx.x; i < n_rows; i += kThreads) delta_c[own_row0 + i] = 0.f;
    return;
  }
  extern __shared__ float4 smem_dtf[];
  float* own = reinterpret_cast<float*>(smem_dtf);
  float* ring = own + Smem::kRing;
  gather(own, q, g, g.ft.l0 / kTile);
  gather(own + kTileFloats, dmix, g, g.ft.l0 / kTile);
  float term = 0.f;
  int t = next_live(g, mask, 0, term);
  if (t < n_tiles) {
    gather(ring, k, g, t);
    gather(ring + kTileFloats, v, g, t);
    if (threadIdx.x < kTile) ring[Smem::kTerms + threadIdx.x] = term;
  }
  cp_async_commit();

  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float lse2[2], w[2], delta[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    const bool real = row < n_own;
    const size_t at = own_row0 + (real ? row : 0);
    lse2[rr] = dwg::lse2_of(lse_c[at], real);
    w[rr] = real ? w_c[at] : 0.f;
  }
  float acc[24], acc_b[24];   // A = sum P w dP k, B = sum P k
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = acc_b[i] = 0.f;

  for (int stage = 0; t < n_tiles; stage ^= 1) {
    // scanning is a barrier: no warp still reads the stage the next tile fills
    const int next = next_live(g, mask, t + 1, term);
    if (next < n_tiles) {
      float* nst = ring + (stage ^ 1) * Smem::kStageFloats;
      gather(nst, k, g, next);
      gather(nst + kTileFloats, v, g, next);
      if (threadIdx.x < kTile) nst[Smem::kTerms + threadIdx.x] = term;
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = ring + stage * Smem::kStageFloats;
#pragma unroll 1
    for (int h = 0; h < kTile; h += kHalf) {   // keys [h, h + 32) of the tile
      const float* kh = st + h * kStride;
      const float* vh = st + kTileFloats + h * kStride;
      float s[16], dp[16];
      scores(s, own, kh, ln);                               // q k^T
      scores(dp, own + kTileFloats, vh, ln);                // dmix v^T
      dwg::probabilities(s, dp, rs, st + Smem::kTerms + h, lse2, scale2, ln);
#pragma unroll
      for (int i = 0; i < 16; ++i) dp[i] = s[i] * (w[(i >> 1) & 1] * dp[i]);   // P w dP
      product2(acc, dp, acc_b, s, kh, ln);                   // A += P w dP k, B += P k
    }
    t = next;
  }
  cp_async_wait<0>();
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
  dwg::store_rows(dq_c + own_row0 * kD, acc, n_rows, scale, ln);
}

// dk/dv: the own rows are keys (their k and v tiles stay in shared memory,
// their terms in registers); a stage is a query tile's q and dmix with the
// queries' lse2, w and delta. The score tiles are computed transposed,
// S^T = k q^T and dP^T = v dmix^T, and P^T w and dS^T feed
// dv += (P^T w) dmix and dk += dS^T q from registers.
__global__ void __launch_bounds__(kThreads, 2)
dilated_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dmix,
                            const unsigned char* __restrict__ mask,
                            const float* __restrict__ lse_c, const float* __restrict__ w_c,
                            const float* __restrict__ delta_c, float* __restrict__ dk_c,
                            float* __restrict__ dv_c, int L, int H, float scale,
                            FusedBranches fb) {
  const Group g(fb, blockIdx.x, blockIdx.y, blockIdx.z, L, H);
  const int n_rows = g.ft.n_rows;
  const size_t own_row0 = g.rows0 + g.ft.l0;
  const bool live =
      __syncthreads_or(threadIdx.x < kTile && g.valid_key(g.ft.l0 + threadIdx.x, mask));
  if (!live) {   // every own key masked, or no real row: zero gradients
    dwg::zero_rows(dk_c + own_row0 * kD, n_rows);
    dwg::zero_rows(dv_c + own_row0 * kD, n_rows);
    return;
  }
  extern __shared__ float4 smem_dtf[];
  float* own = reinterpret_cast<float*>(smem_dtf);
  float* ring = own + Smem::kRing;
  gather(own, k, g, g.ft.l0 / kTile);
  gather(own + kTileFloats, v, g, g.ft.l0 / kTile);
  int t, t_hi;   // a query tile wholly outside fb's range adds nothing
  g.query_tiles(fb.q0, fb.q1, t, t_hi);
  QueryTerms terms;
  if (t < t_hi) {
    gather(ring, q, g, t);
    gather(ring + kTileFloats, dmix, g, t);
    if (threadIdx.x < kTile) {
      terms.fetch(g, lse_c, w_c, delta_c, t);
      terms.store(ring + Smem::kTerms);
    }
  }
  cp_async_commit();

  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float kterm[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kterm[rr] = g.valid_key(g.ft.l0 + ln.row0 + 8 * rr, mask) ? 0.f : -INFINITY;
  float acc_dk[24], acc_dv[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int stage = 0; t < t_hi; ++t, stage ^= 1) {
    __syncthreads();   // no warp still reads the stage the next tile fills
    float* nst = ring + (stage ^ 1) * Smem::kStageFloats;
    const bool more = t + 1 < t_hi;
    if (more) {
      gather(nst, q, g, t + 1);
      gather(nst + kTileFloats, dmix, g, t + 1);
      if (threadIdx.x < kTile) terms.fetch(g, lse_c, w_c, delta_c, t + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = ring + stage * Smem::kStageFloats;
#pragma unroll 1
    for (int h = 0; h < kTile; h += kHalf) {   // queries [h, h + 32) of the tile
      const float* qh = st + h * kStride;
      const float* dh = st + kTileFloats + h * kStride;
      const float* qt = st + Smem::kTerms + h;
      float s[16], dp[16];
      scores(s, own, qh, ln);                                 // k q^T
      scores(dp, own + kTileFloats, dh, ln);                  // v dmix^T
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int c = 8 * j + ln.col0;
        const float2 ls = *reinterpret_cast<const float2*>(qt + c);
        const float2 ww = *reinterpret_cast<const float2*>(qt + kTile + c);
        const float2 dl = *reinterpret_cast<const float2*>(qt + 2 * kTile + c);
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
      product(acc_dv, s, dh, ln);                              // dv += P^T w dmix
      product(acc_dk, dp, qh, ln);                             // dk += dS^T q
    }
    if (more && threadIdx.x < kTile) terms.store(nst + Smem::kTerms);
  }
  cp_async_wait<0>();
  dwg::store_rows(dk_c + own_row0 * kD, acc_dk, n_rows, scale, ln);
  dwg::store_rows(dv_c + own_row0 * kD, acc_dv, n_rows, 1.f, ln);
}

}  // namespace dtf

namespace {

cudaError_t check_core_tf32(const DilatedBwdCore& a) {
  const void* rows[4] = {a.q, a.k, a.v, a.dmix};   // cp.async reads 16-byte chunks
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaError_t err = allow_smem(dtf::dilated_bwd_dq_tf32_kernel, dtf::Smem::bytes);
  if (err == cudaSuccess) err = allow_smem(dtf::dilated_bwd_dkv_tf32_kernel, dtf::Smem::bytes);
  return err;
}

}  // namespace

// dq and delta on the range's query tiles, then dk/dv on every key tile
// over the range's query tiles, after the dq kernel on the same stream.
cudaError_t launch_dilated_bwd_core_tf32(const DilatedBwdCore& a, const FusedBranches& fb,
                                         cudaStream_t stream) {
  cudaError_t err = check_core_tf32(a);
  if (err != cudaSuccess) return err;
  const auto q = static_cast<const float*>(a.q), k = static_cast<const float*>(a.k);
  const auto v = static_cast<const float*>(a.v), dmix = static_cast<const float*>(a.dmix);
  // dq and delta only on the tiles of the query range (the combine reads no
  // other row of dq_c, the dk/dv kernel no other row of delta_c)
  const FusedBranches fq = query_tiles(fb, a.L);
  dtf::dilated_bwd_dq_tf32_kernel<<<dim3(fq.tile0[fq.n], a.H, a.B), dtf::kThreads,
                                    dtf::Smem::bytes, stream>>>(
      q, k, v, dmix, a.mask, a.lse_c, a.w_c, a.delta_c, a.dq_c, a.L, a.H, a.scale, fq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dtf::dilated_bwd_dkv_tf32_kernel<<<dim3(fb.tile0[fb.n], a.H, a.B), dtf::kThreads,
                                     dtf::Smem::bytes, stream>>>(
      q, k, v, dmix, a.mask, a.lse_c, a.w_c, a.delta_c, a.dk_c, a.dv_c, a.L, a.H, a.scale, fb);
  return cudaGetLastError();
}

}  // namespace mt
