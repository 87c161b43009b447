// The key-bias flash attention backward (K2b) on Hopper's tensor cores: the
// wgmma family, bf16 at head dimension 48 (flash_wgmma.cuh).
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_bwd_pallas (the Pallas
// TPU kernels _dq_kernel and _dkv_kernel) on the per-branch dilated
// attention's calls.
//
// Computes, from the forward's out and lse, for every bh:
//   delta_i = sum_d dout_id out_id          (fp32, made by the dq kernel)
//   P_ij  = exp(q_i.k_j * scale + bias_j - lse_i)   (0 for a key with bias
//                                         <= NEG_INF/2, a row past Lq or a
//                                         row whose lse is NEG_INF)
//   dS_ij = P_ij (dout_i.v_j - delta_i)
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij dout_i
// in bf16, from fp32 sums; the lse cotangent is dropped, as _bwd_pallas
// drops it. The plain oracle is
// ops/flash_attention.py::flash_attention_backward_reference.
//
// What bounds it on the H100: operations. The five products are 10 pairs D
// flop: 0.669 ms at the 10,240-token layer's five branches with 9,000 valid
// tokens. One exp2 a pair in each kernel and the elementwise work of P and
// dS run beside them.
//
// The design: the shared gradient core of the dilated attention
// (dilated_bwd_wgmma.cu), on contiguous rows.
// * Two kernels without atomics, so two runs give the same bits: the dq
//   kernel's block owns 64 query rows and streams the bh's live key tiles,
//   the dk/dv kernel's owns 64 key rows and streams every query tile; W = 1
//   consumer warpgroup, one producer warpgroup, a ring of four stages,
//   setmaxnreg, two blocks an SM. q.k and dout.v run in both kernels (seven
//   products for five).
// * delta: the dq kernel's consumer reads its rows' dout and out from
//   device memory (a quad a row, twelve columns a thread) before its first
//   stage and writes delta to fp32 scratch that the wrapper allocates; the
//   dk/dv kernel, launched after it on the stream, loads it with the
//   queries' lse into each stage.
// * Masking without a branch: a key's term is its bias in base 2 or -inf, a
//   query's lse2 is lse log2(e) or +1e30 (dwg::lse2_of), and P = exp2(s
//   scale log2(e) + key term - lse2) is exactly 0 for every masked pair. A
//   dk/dv block whose own keys are all masked writes zeros and leaves.
// * Precision: P and dS enter every product that takes them as two bf16
//   parts, hi = bf16(x) and lo = bf16(x - hi) (dwg::pack_parts); rounded
//   once, they failed the bf16 train step's per-tensor gradient gate in the
//   short-side family (sums over thousands of rows that cancel).
#include "flash_wgmma.cuh"

namespace mt {
namespace fwg {

// Rows [0, n) of bf16 (.., 48) rows at `dst` set to 0, by the whole block.
__device__ __forceinline__ void zero_rows(bf16* dst, int n) {
  for (int i = threadIdx.x; i < n * kD / 8; i += dwg::kThreads)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
}

// rowsum(dout * out) of the thread's rows row0 + lane's row and + 8 (rows
// [0, n) of the tile at dout and out), over the quad's 48 columns; 0 past n.
__device__ __forceinline__ void row_deltas(float (&delta)[2], const bf16* dout, const bf16* out,
                                           int n, const wg::Lane& ln) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    float sum = 0.f;
    if (row < n) {
      const size_t at = static_cast<size_t>(row) * kD + ln.col0;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + at + 8 * j));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + at + 8 * j));
        sum = fmaf(a.x, b.x, fmaf(a.y, b.y, sum));
      }
    }
    delta[rr] = wg::quad_sum(sum);   // the whole warp shuffles
  }
}

// dq: the own rows are queries (their q and dout tiles stay in shared
// memory; lse2 and delta in registers); a stage is a live key tile's k and
// v with the keys' terms.
__global__ void __launch_bounds__(dwg::kThreads, 2)
flash_bwd_dq_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const bf16* __restrict__ dout, const bf16* __restrict__ out,
                       const float* __restrict__ lse, float* __restrict__ delta_out,
                       bf16* __restrict__ dq, int Lq, int Lk, float scale) {
  const int bh = blockIdx.y, t = blockIdx.x;
  const size_t q_row0 = static_cast<size_t>(bh) * Lq;
  const size_t k_row0 = static_cast<size_t>(bh) * Lk;
  const size_t own_row0 = q_row0 + static_cast<size_t>(t) * kTile;
  const int n_own = min(kTile, Lq - t * kTile);
  extern __shared__ unsigned char smem_fwg[];
  const Frame f(smem_fwg);
  dwg::init_barriers(f.full, f.empty, f.own_bar, 4);

  if (threadIdx.x >= wg::kWgThreads) {
    // ---- producer warpgroup: the own tiles, then the live key tiles ----
    wg::give_registers<wg::kProducerRegs>();
    const int p = threadIdx.x - wg::kWgThreads;
    load_tile(f.smem, q + q_row0 * kD, Lq, t, p);
    load_tile(f.smem + kTileBytes, dout + q_row0 * kD, Lq, t, p);
    dwg::cp_async_arrive(f.own_bar);
    produce_keys(f.ring, f.full, f.empty, k + k_row0 * kD, v + k_row0 * kD,
                 bias == nullptr ? nullptr : bias + k_row0, Lk, p);
    return;
  }

  // ---- consumer warpgroup: query rows [t 64, + 64) of the bh ----
  wg::take_registers<wg::kConsumerRegs<1>>();
  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float delta[2], lse2[2];
  row_deltas(delta, dout + own_row0 * kD, out + own_row0 * kD, n_own, ln);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    const bool real = row < n_own;
    lse2[rr] = dwg::lse2_of(real ? lse[own_row0 + row] : 0.f, real);
    if (real && ln.col0 == 0) delta_out[own_row0 + row] = delta[rr];
  }
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.f;
  wg::mbar_wait(f.own_bar, 0);
  dwg::fence_async_shared();

  wg::Ring r;
  const unsigned char* st;
  while (dwg::next_stage(st, f.ring, f.full, r)) {
    float s[32], dp[32];
    wg::wgmma_fence();
    dwg::product_ss(s, f.smem, st);                              // q k^T
    dwg::product_ss(dp, f.smem + kTileBytes, st + kTileBytes);   // dout v^T
    wg::wgmma_commit();
    const float* kterm = reinterpret_cast<const float*>(st + Smem::kTerms);
    wg::wgmma_wait<0>();
    wg::hold(s);
    wg::hold(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 kt = *reinterpret_cast<const float2*>(kterm + 8 * j + ln.col0);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr;
        const float p0 = wg::exp2_fast(fmaf(s[i], scale2, kt.x - lse2[rr]));
        const float p1 = wg::exp2_fast(fmaf(s[i + 1], scale2, kt.y - lse2[rr]));
        s[i] = p0 * (dp[i] - delta[rr]);                         // dS
        s[i + 1] = p1 * (dp[i + 1] - delta[rr]);
      }
    }
    uint32_t hi[16], lo[16];
    dwg::pack_parts(hi, lo, s);
    wg::wgmma_fence();
    dwg::product_rs(acc, hi, st);                                // dq += dS k
    dwg::product_rs(acc, lo, st);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    dwg::hold(acc);
    wg::hold(hi);
    wg::hold(lo);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(f.empty + r.stage);
    r.advance<kStages>();
  }
  store_rows(dq + own_row0 * kD, acc, n_own, scale, ln);
}

// dk/dv: the own rows are keys (their k and v tiles stay in shared memory,
// their terms in registers); a stage is a query tile's q and dout with the
// queries' lse2 and delta (+1e30 and 0 past Lq). The score tiles are taken
// transposed, S^T = k q^T and dP^T = v dout^T, and P^T and dS^T feed
// dv += P^T dout and dk += dS^T q from registers.
__global__ void __launch_bounds__(dwg::kThreads, 2)
flash_bwd_dkv_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int Lq, int Lk, float scale) {
  const int bh = blockIdx.y, t = blockIdx.x;
  const size_t q_row0 = static_cast<size_t>(bh) * Lq;
  const size_t k_row0 = static_cast<size_t>(bh) * Lk;
  const size_t own_row0 = k_row0 + static_cast<size_t>(t) * kTile;
  const int n_own = min(kTile, Lk - t * kTile);
  const float* bias_b = bias == nullptr ? nullptr : bias + k_row0;
  const bool live = __syncthreads_or(
      threadIdx.x < kTile &&
      ss::key_term(bias_b, t * kTile + threadIdx.x, Lk, wg::kLog2e) != -INFINITY);
  if (!live) {   // every own key masked: zero gradients
    zero_rows(dk + own_row0 * kD, n_own);
    zero_rows(dv + own_row0 * kD, n_own);
    return;
  }
  extern __shared__ unsigned char smem_fwg[];
  const Frame f(smem_fwg);
  dwg::init_barriers(f.full, f.empty, f.own_bar, 4);

  if (threadIdx.x >= wg::kWgThreads) {
    // ---- producer warpgroup: the own tiles, then every query tile ----
    wg::give_registers<wg::kProducerRegs>();
    const int p = threadIdx.x - wg::kWgThreads;
    load_tile(f.smem, k + k_row0 * kD, Lk, t, p);
    load_tile(f.smem + kTileBytes, v + k_row0 * kD, Lk, t, p);
    dwg::cp_async_arrive(f.own_bar);
    wg::Ring r;
    for (int tq = 0; tq < tiles_of(Lq); ++tq) {
      wg::mbar_wait(f.empty + r.stage, r.phase ^ 1);
      unsigned char* st = f.ring + r.stage * Smem::kStageBytes;
      load_tile(st, q + q_row0 * kD, Lq, tq, p);
      load_tile(st + kTileBytes, dout + q_row0 * kD, Lq, tq, p);
      dwg::cp_async_arrive(f.full + r.stage);
      if ((p & 1) == 0) {
        const int l = tq * kTile + (p >> 1);
        const bool real = l < Lq;
        float* terms = reinterpret_cast<float*>(st + Smem::kTerms) + (p >> 1);
        terms[0] = dwg::lse2_of(real ? lse[q_row0 + l] : 0.f, real);
        terms[kTile] = real ? delta[q_row0 + l] : 0.f;
      }
      if (p == 0) *reinterpret_cast<int*>(st + Smem::kEnd) = 0;
      wg::mbar_arrive(f.full + r.stage);
      r.advance<kStages>();
    }
    dwg::producer_finish(f.ring, f.full, f.empty, r, p);
    return;
  }

  // ---- consumer warpgroup: key rows [t 64, + 64) of the bh ----
  wg::take_registers<wg::kConsumerRegs<1>>();
  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float kterm[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kterm[rr] = ss::key_term(bias_b, t * kTile + ln.row0 + 8 * rr, Lk, wg::kLog2e);
  float acc_dk[24], acc_dv[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  wg::mbar_wait(f.own_bar, 0);
  dwg::fence_async_shared();

  wg::Ring r;
  const unsigned char* st;
  while (dwg::next_stage(st, f.ring, f.full, r)) {
    float s[32], dp[32];
    wg::wgmma_fence();
    dwg::product_ss(s, f.smem, st);                              // k q^T
    dwg::product_ss(dp, f.smem + kTileBytes, st + kTileBytes);   // v dout^T
    wg::wgmma_commit();
    const float* terms = reinterpret_cast<const float*>(st + Smem::kTerms);
    wg::wgmma_wait<0>();
    wg::hold(s);
    wg::hold(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + ln.col0;
      const float2 ls = *reinterpret_cast<const float2*>(terms + c);
      const float2 dl = *reinterpret_cast<const float2*>(terms + kTile + c);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr;
        const float p0 = wg::exp2_fast(fmaf(s[i], scale2, kterm[rr] - ls.x));
        const float p1 = wg::exp2_fast(fmaf(s[i + 1], scale2, kterm[rr] - ls.y));
        dp[i] = p0 * (dp[i] - dl.x);                             // dS^T
        dp[i + 1] = p1 * (dp[i + 1] - dl.y);
        s[i] = p0;                                               // P^T
        s[i + 1] = p1;
      }
    }
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    dwg::pack_parts(p_hi, p_lo, s);
    dwg::pack_parts(ds_hi, ds_lo, dp);
    wg::wgmma_fence();
    dwg::product_rs(acc_dv, p_hi, st + kTileBytes);              // dv += P^T dout
    dwg::product_rs(acc_dv, p_lo, st + kTileBytes);
    dwg::product_rs(acc_dk, ds_hi, st);                          // dk += dS^T q
    dwg::product_rs(acc_dk, ds_lo, st);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    dwg::hold(acc_dv);
    dwg::hold(acc_dk);
    wg::hold(p_hi);
    wg::hold(p_lo);
    wg::hold(ds_hi);
    wg::hold(ds_lo);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(f.empty + r.stage);
    r.advance<kStages>();
  }
  store_rows(dk + own_row0 * kD, acc_dk, n_own, scale, ln);
  store_rows(dv + own_row0 * kD, acc_dv, n_own, 1.f, ln);
}

}  // namespace fwg

cudaError_t launch_flash_wgmma_bwd(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                   const bf16* dout, const bf16* out, const float* lse,
                                   float* delta, bf16* dq, bf16* dk, bf16* dv, int BH, int Lq,
                                   int Lk, float scale, cudaStream_t stream) {
  const void* rows[8] = {q, k, v, dout, out, dq, dk, dv};   // 16-byte loads and stores
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  if (delta == nullptr) return cudaErrorInvalidValue;
  auto kq = fwg::flash_bwd_dq_wg_kernel;
  auto kkv = fwg::flash_bwd_dkv_wg_kernel;
  cudaError_t err = allow_smem(kq, fwg::Smem::bytes);
  if (err == cudaSuccess) err = allow_smem(kkv, fwg::Smem::bytes);
  if (err != cudaSuccess) return err;
  kq<<<dim3(fwg::tiles_of(Lq), BH), dwg::kThreads, fwg::Smem::bytes, stream>>>(
      q, k, v, bias, dout, out, lse, delta, dq, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3(fwg::tiles_of(Lk), BH), dwg::kThreads, fwg::Smem::bytes, stream>>>(
      q, k, v, bias, dout, lse, delta, dk, dv, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace mt
