// The key-bias flash attention backward (K2b) at fp32 on Hopper's tensor
// cores: the 3xTF32 family, fp32 at head dimension 48 (flash_tf32.cuh).
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_bwd_pallas (the Pallas
// TPU kernels _dq_kernel and _dkv_kernel) on the per-branch dilated
// attention's calls at fp32, where their dots run at Precision.HIGHEST.
//
// Computes, from the forward's out and lse, for every bh:
//   vbar    = the mean of the valid keys' v rows (0 without one)
//   delta_i = dout_i.(out_i - vbar)         (fp32, made by the dq kernel)
//   P_ij  = exp(q_i.k_j * scale + bias_j - lse_i)   (0 for a key with bias
//                                         <= NEG_INF/2, a row past Lq or a
//                                         row whose lse is NEG_INF)
//   dS_ij = P_ij (dout_i.(v_j - vbar) - delta_i)
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij dout_i
// in fp32, every product at fp32 accuracy; the lse cotangent is dropped, as
// _bwd_pallas drops it. The plain oracle is
// ops/flash_attention.py::flash_attention_backward_reference.
//
// What bounds it on the H100: operations. At fp32 accuracy each of the five
// products is three TF32 products: 3 x 10 pairs D flop at 495 TFLOP/s, 2.06
// ms at the r = 2 branch of a 10,240-token layer (96 x 2,896 rows, 12 % of
// the keys masked), against 5.08 ms for the five products on the CUDA cores
// at 67 TFLOP/s, where the CUDA-core kernels of flash_attention_bwd.cu (with
// delta made in torch) read 31.32 ms (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py). The kernels run seven products (q.k and dout.v in both),
// as the wgmma family's do.
//
// The design: the dilated 3xTF32 gradient core's (dilated_bwd_tf32.cu) on
// contiguous rows, with the wgmma family's delta (flash_wgmma_bwd.cu).
// * Two kernels without atomics, so two runs give the same bits: the dq
//   kernel's block owns 64 query rows and streams the bh's live key tiles;
//   the dk/dv kernel, launched after it on the same stream, owns 64 key rows
//   and streams every query tile. A block is four warps of 16 own rows;
//   every thread loads its share of the next tile with 16-byte cp.async
//   (zero-filled past L) into the other stage of a two-stage ring while the
//   current one is multiplied.
// * delta: the dq kernel reads its rows' dout and out from device memory (a
//   quad a row, twelve columns a thread) before its first stage and writes
//   delta to fp32 scratch that the wrapper allocates; the dk/dv kernel loads
//   it with the queries' lse into each stage. No delta is made in torch.
// * dP - delta is taken as dout.(v - vbar) - dout.(out - vbar), the same
//   value for any vbar, since a live row's P sums to 1, as the fp32
//   short-keys kernel takes it (flash_short_side_tf32_bwd.cu). Where a
//   plane's v rows lie close together, as on an fp32 train step's inputs,
//   dout.v and delta agree to a few digits and dS is what is left of their
//   difference; 3xTF32's error of dout.v is about 2^-21 of |dout| |v|, of
//   dout.(v - vbar) only of |dout| |v - vbar|. A first kernel writes vbar of
//   every bh to the scratch (a block a bh); each thread takes vbar off the
//   v chunks it loaded itself once their cp.async group is complete, so
//   centering costs no barrier (rows past Lk become -vbar, their P is 0).
// * P and dS are split into TF32 hi + lo in registers, and a stage is
//   multiplied in two halves of 32 keys (queries in the dk/dv kernel), each
//   product of dq, dk and dv summed in fresh fragments (the tensor cores
//   accumulate by truncation); the score tiles, P, dS and the partial
//   fragments of a half fit the registers beside the accumulators.
// * Masking without a branch: a key's term is its bias in base 2 or -inf, a
//   query's lse2 is lse log2(e) or +1e30 (dwg::lse2_of), so P is exactly 0
//   for every masked pair; the dq kernel never loads a key tile without a
//   valid key, a dk/dv block whose own keys are all masked writes zeros.
// * Shared memory: two own tiles of 52-float rows, then two stages of two
//   tiles and their rows' terms (dtf::Smem): 81,408 bytes, two blocks an SM.
#include "flash_tf32.cuh"

namespace mt {
namespace ftf {

using dtf::Smem;

constexpr int kVbarGroups = 8;   // the vbar kernel's block: 8 row groups of 48 threads

// vbar of plane blockIdx.x: the mean of its valid keys' v rows (0 without
// one), thread (g, c) summing column c over the rows g, g + 8, ..., the
// groups' sums added in order.
__global__ void __launch_bounds__(kVbarGroups * kD)
flash_bwd_vbar_tf32_kernel(const float* __restrict__ v, const float* __restrict__ bias,
                           float* __restrict__ vbar, int Lk) {
  __shared__ float sums[kVbarGroups][kD];
  __shared__ int counts[kVbarGroups];
  const int c = threadIdx.x % kD, g = threadIdx.x / kD;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * Lk;
  const float* bias_b = bias == nullptr ? nullptr : bias + row0;
  float sum = 0.f;
  int n = 0;
#pragma unroll 4
  for (int j = g; j < Lk; j += kVbarGroups)
    if (ss::key_term(bias_b, j, Lk, wg::kLog2e) != -INFINITY) {
      sum += v[(row0 + j) * kD + c];
      ++n;
    }
  sums[g][c] = sum;
  if (c == 0) counts[g] = n;
  __syncthreads();
  if (g == 0) {
    float total = 0.f;
    int valid = 0;
    for (int i = 0; i < kVbarGroups; ++i) {
      total += sums[i][c];
      valid += counts[i];
    }
    vbar[static_cast<size_t>(blockIdx.x) * kD + c] = valid > 0 ? total / valid : 0.f;
  }
}

// v less vbar in the chunks of a tile that this thread's load_tile filled,
// once their cp.async group is complete (so no barrier comes before it).
__device__ __forceinline__ void center_tile(float* d, const float* vbar) {
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i, row = c / kChunks, ch = c % kChunks;
    float4* x = reinterpret_cast<float4*>(d + row * kStride + 4 * ch);
    const float4 m = __ldg(reinterpret_cast<const float4*>(vbar) + ch);
    const float4 y = *x;
    *x = make_float4(y.x - m.x, y.y - m.y, y.z - m.z, y.w - m.w);
  }
}

// dout.(out - vbar) of the thread's rows row0 + lane's row and + 8 (rows
// [0, n) at dout and out), over the quad's 48 columns; 0 past n.
__device__ __forceinline__ void row_deltas(float (&delta)[2], const float* dout, const float* out,
                                           const float* vbar, int n, const wg::Lane& ln) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    float sum = 0.f;
    if (row < n) {
      const size_t at = static_cast<size_t>(row) * kD + ln.col0;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(dout + at + 8 * j);
        const float2 b = *reinterpret_cast<const float2*>(out + at + 8 * j);
        const float2 m = *reinterpret_cast<const float2*>(vbar + ln.col0 + 8 * j);
        sum = fmaf(a.x, b.x - m.x, fmaf(a.y, b.y - m.y, sum));
      }
    }
    delta[rr] = wg::quad_sum(sum);   // the whole warp shuffles
  }
}

// dq and delta: the own rows are queries (their q and dout tiles stay in
// shared memory; lse2 and delta in registers); a stage is a live key tile's
// k and v with the keys' terms.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ dout, const float* __restrict__ out,
                         const float* __restrict__ lse, const float* __restrict__ vbar_all,
                         float* __restrict__ delta_out, float* __restrict__ dq, int Lq, int Lk,
                         float scale) {
  const int bh = blockIdx.y, t0 = blockIdx.x;
  const size_t q_row0 = static_cast<size_t>(bh) * Lq;
  const size_t k_row0 = static_cast<size_t>(bh) * Lk;
  const size_t own_row0 = q_row0 + static_cast<size_t>(t0) * kTile;
  const int n_own = min(kTile, Lq - t0 * kTile);
  const float* kb = k + k_row0 * kD;
  const float* vb = v + k_row0 * kD;
  const float* bias_b = bias == nullptr ? nullptr : bias + k_row0;
  const float* vbar = vbar_all + static_cast<size_t>(bh) * kD;
  const int n_tiles = tiles_of(Lk);
  extern __shared__ float4 smem_ftf[];
  float* own = reinterpret_cast<float*>(smem_ftf);
  float* ring = own + Smem::kRing;
  load_tile(own, q + q_row0 * kD, Lq, t0);
  load_tile(own + kTileFloats, dout + q_row0 * kD, Lq, t0);
  float term = 0.f;
  int t = next_live(bias_b, Lk, 0, term);
  if (t < n_tiles) {
    load_tile(ring, kb, Lk, t);
    load_tile(ring + kTileFloats, vb, Lk, t);
    if (threadIdx.x < kTile) ring[Smem::kTerms + threadIdx.x] = term;
  }
  dtf::cp_async_commit();

  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float delta[2], lse2[2];
  row_deltas(delta, dout + own_row0 * kD, out + own_row0 * kD, vbar, n_own, ln);
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

  for (int stage = 0; t < n_tiles; stage ^= 1) {
    // scanning is a barrier: no warp still reads the stage the next tile fills
    const int next = next_live(bias_b, Lk, t + 1, term);
    if (next < n_tiles) {
      float* nst = ring + (stage ^ 1) * Smem::kStageFloats;
      load_tile(nst, kb, Lk, next);
      load_tile(nst + kTileFloats, vb, Lk, next);
      if (threadIdx.x < kTile) nst[Smem::kTerms + threadIdx.x] = term;
    }
    dtf::cp_async_commit();
    dtf::cp_async_wait<1>();
    float* st = ring + stage * Smem::kStageFloats;
    center_tile(st + kTileFloats, vbar);   // v - vbar
    __syncthreads();
#pragma unroll 1
    for (int h = 0; h < kTile; h += dtf::kHalf) {   // keys [h, h + 32) of the tile
      const float* kh = st + h * kStride;
      const float* kterm = st + Smem::kTerms + h;
      float s[16], dp[16];
      dtf::scores(s, own, kh, ln);                                        // q k^T
      dtf::scores(dp, own + kTileFloats, st + kTileFloats + h * kStride, ln);   // dout (v - vbar)^T
#pragma unroll
      for (int j = 0; j < dtf::kHalf / 8; ++j) {
        const float2 kt = *reinterpret_cast<const float2*>(kterm + 8 * j + ln.col0);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          const float p0 = wg::exp2_fast(fmaf(s[i], scale2, kt.x - lse2[rr]));
          const float p1 = wg::exp2_fast(fmaf(s[i + 1], scale2, kt.y - lse2[rr]));
          s[i] = p0 * (dp[i] - delta[rr]);                               // dS
          s[i + 1] = p1 * (dp[i + 1] - delta[rr]);
        }
      }
      dtf::product(acc, s, kh, ln);                                       // dq += dS k
    }
    t = next;
  }
  dtf::cp_async_wait<0>();
  dwg::store_rows(dq + own_row0 * kD, acc, n_own, scale, ln);
}

// A query tile's row terms, fetched by threads below 64 into registers, so
// that their loads overlap the products: lse and delta of row t 64 +
// threadIdx.x of the plane.
struct QueryTerms {
  float lse, delta;
  bool real;
  __device__ void fetch(const float* lse_b, const float* delta_b, int Lq, int t) {
    const int l = t * kTile + threadIdx.x;
    real = l < Lq;
    lse = lse_b[real ? l : 0];
    delta = delta_b[real ? l : 0];
  }
  // lse2 and delta (+1e30 and 0 past Lq) into a stage's terms
  __device__ void store(float* terms) const {
    terms[threadIdx.x] = dwg::lse2_of(lse, real);
    terms[kTile + threadIdx.x] = real ? delta : 0.f;
  }
};

// dk/dv: the own rows are keys (their k and v tiles stay in shared memory,
// their terms in registers); a stage is a query tile's q and dout with the
// queries' lse2 and delta. The score tiles are computed transposed,
// S^T = k q^T and dP^T = v dout^T, and P^T and dS^T feed dv += P^T dout and
// dk += dS^T q from registers.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ vbar_all, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                          float scale) {
  const int bh = blockIdx.y, t0 = blockIdx.x;
  const size_t q_row0 = static_cast<size_t>(bh) * Lq;
  const size_t k_row0 = static_cast<size_t>(bh) * Lk;
  const size_t own_row0 = k_row0 + static_cast<size_t>(t0) * kTile;
  const int n_own = min(kTile, Lk - t0 * kTile);
  const float* bias_b = bias == nullptr ? nullptr : bias + k_row0;
  const bool live = __syncthreads_or(
      threadIdx.x < kTile &&
      ss::key_term(bias_b, t0 * kTile + threadIdx.x, Lk, wg::kLog2e) != -INFINITY);
  if (!live) {   // every own key masked: zero gradients
    dwg::zero_rows(dk + own_row0 * kD, n_own);
    dwg::zero_rows(dv + own_row0 * kD, n_own);
    return;
  }
  const float* qb = q + q_row0 * kD;
  const float* db = dout + q_row0 * kD;
  const float* lse_b = lse + q_row0;
  const float* delta_b = delta + q_row0;
  const int n_tiles = tiles_of(Lq);
  extern __shared__ float4 smem_ftf[];
  float* own = reinterpret_cast<float*>(smem_ftf);
  float* ring = own + Smem::kRing;
  load_tile(own, k + k_row0 * kD, Lk, t0);
  load_tile(own + kTileFloats, v + k_row0 * kD, Lk, t0);
  load_tile(ring, qb, Lq, 0);
  load_tile(ring + kTileFloats, db, Lq, 0);
  QueryTerms terms;
  if (threadIdx.x < kTile) {
    terms.fetch(lse_b, delta_b, Lq, 0);
    terms.store(ring + Smem::kTerms);
  }
  dtf::cp_async_commit();

  const wg::Lane ln;
  const float scale2 = scale * wg::kLog2e;
  float kterm[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kterm[rr] = ss::key_term(bias_b, t0 * kTile + ln.row0 + 8 * rr, Lk, wg::kLog2e);
  float acc_dk[24], acc_dv[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int t = 0, stage = 0; t < n_tiles; ++t, stage ^= 1) {
    __syncthreads();   // no warp still reads the stage the next tile fills
    float* nst = ring + (stage ^ 1) * Smem::kStageFloats;
    const bool more = t + 1 < n_tiles;
    if (more) {
      load_tile(nst, qb, Lq, t + 1);
      load_tile(nst + kTileFloats, db, Lq, t + 1);
      if (threadIdx.x < kTile) terms.fetch(lse_b, delta_b, Lq, t + 1);
    }
    dtf::cp_async_commit();
    dtf::cp_async_wait<1>();
    if (t == 0)   // the own tiles came in the first group
      center_tile(own + kTileFloats, vbar_all + static_cast<size_t>(bh) * kD);   // v - vbar
    __syncthreads();
    const float* st = ring + stage * Smem::kStageFloats;
#pragma unroll 1
    for (int h = 0; h < kTile; h += dtf::kHalf) {   // queries [h, h + 32) of the tile
      const float* qh = st + h * kStride;
      const float* dh = st + kTileFloats + h * kStride;
      const float* qt = st + Smem::kTerms + h;
      float s[16], dp[16];
      dtf::scores(s, own, qh, ln);                                  // k q^T
      dtf::scores(dp, own + kTileFloats, dh, ln);                   // (v - vbar) dout^T
#pragma unroll
      for (int j = 0; j < dtf::kHalf / 8; ++j) {
        const int c = 8 * j + ln.col0;
        const float2 ls = *reinterpret_cast<const float2*>(qt + c);
        const float2 dl = *reinterpret_cast<const float2*>(qt + kTile + c);
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
      dtf::product(acc_dv, s, dh, ln);                              // dv += P^T dout
      dtf::product(acc_dk, dp, qh, ln);                             // dk += dS^T q
    }
    if (more && threadIdx.x < kTile) terms.store(nst + Smem::kTerms);
  }
  dtf::cp_async_wait<0>();
  dwg::store_rows(dk + own_row0 * kD, acc_dk, n_own, scale, ln);
  dwg::store_rows(dv + own_row0 * kD, acc_dv, n_own, 1.f, ln);
}

}  // namespace ftf

cudaError_t launch_flash_tf32_bwd(const float* q, const float* k, const float* v,
                                  const float* bias, const float* dout, const float* out,
                                  const float* lse, float* work, float* dq, float* dk, float* dv,
                                  int BH, int Lq, int Lk, float scale, cudaStream_t stream) {
  if (work == nullptr) return cudaErrorInvalidValue;
  const void* rows[9] = {q, k, v, dout, out, dq, dk, dv, work};   // 16-byte loads and stores
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  float* vbar = work;                                  // (BH, 48), then
  float* delta = work + static_cast<size_t>(BH) * ftf::kD;   // (BH, Lq)
  auto kq = ftf::flash_bwd_dq_tf32_kernel;
  auto kkv = ftf::flash_bwd_dkv_tf32_kernel;
  cudaError_t err = allow_smem(kq, dtf::Smem::bytes);
  if (err == cudaSuccess) err = allow_smem(kkv, dtf::Smem::bytes);
  if (err != cudaSuccess) return err;
  ftf::flash_bwd_vbar_tf32_kernel<<<BH, ftf::kVbarGroups * ftf::kD, 0, stream>>>(v, bias, vbar, Lk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kq<<<dim3(ftf::tiles_of(Lq), BH), ftf::kThreads, dtf::Smem::bytes, stream>>>(
      q, k, v, bias, dout, out, lse, vbar, delta, dq, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3(ftf::tiles_of(Lk), BH), ftf::kThreads, dtf::Smem::bytes, stream>>>(
      q, k, v, bias, dout, lse, vbar, delta, dk, dv, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace mt
