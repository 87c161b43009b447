// Flash attention backward with the 2-D ALiBi bias computed per tile (K4b).
//
// Replaces: modaltune_tpu/ops/alibi_flash.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels launched by _bwd_pallas) and their all-heads
// variants ::_dq_kernel_ah and ::_dkv_kernel_ah (launched by _bwd_pallas_ah).
//
// Computes, from the forward's lse and delta = rowsum(dout * out) (taken by
// the wrapper, as _bwd_pallas takes it outside its kernels), for every batch
// row b and head h:
//   s  = q k^T * scale - slope[h] * dist * not_cls + bias[b]   (the forward's)
//   P  = exp(s - lse)          (0 for a key with bias <= NEG_INF/2; a row
//                               whose keys are all masked gets zero gradients)
//   dS = P * (dout v^T - delta)
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dout
// coords, slopes and bias get no gradient. Layout q/k/v/dout/dq/dk/dv
// (B, H, N, D), coords (B, N, 3), slopes (H,), bias (B, N) or null, lse and
// delta (B, H, N); fp32 accumulation, gradients in the input dtype.
//
// What bounds it on the H100: operations. The five products a backward needs
// are 10 N^2 D per (b, h), 6.2 TFLOP at 3 x 12 x 16,384 x 64: 6.2 ms at the
// tensor cores' 989 TFLOP/s. Beside them the function needs one exp per
// (pair, head) and one sqrt per pair on the special-function units, here
// once in each of two kernels, and they set the pace more than the products.
//
// What the design does about it: a pair of kernels without atomics, so that
// two runs give the same bits (a dq kernel whose block owns query rows and
// streams the keys, a dk/dv kernel whose block owns key rows and streams the
// queries; q.k and dout.v are computed in both, seven products for five),
// with the ALiBi term recomputed per pair from the two tiles' coordinates,
// so neither the bias nor P is ever in device memory. Two families:
// * bf16 at D = 64, the model's path: alibi_bwd_dq_wg_kernel and
//   alibi_bwd_dkv_wg_kernel on the Hopper frame (attention_wgmma.cuh): a
//   producer lane streams tiles with TMA through a ring of four stages, W
//   consumer warpgroups of 64 own rows run every product as wgmma. S and
//   dP = dout v^T are two product chains into registers; P = exp2(S - lse)
//   and dS = P (dP - delta) are formed there (lse and delta per row in
//   registers in the dq kernel, per column from the stage in the dk/dv
//   kernel) and, packed to bf16, are the register operands of dq += dS k,
//   dv += P^T dout and dk += dS^T q. In the dk/dv kernel the own rows are
//   keys, so it computes the transposed tiles k q^T and v dout^T directly.
//   The dq kernel loops over a group of G heads per key tile and shares the
//   distance tile among them, and visits live key tiles only; the dk/dv
//   kernel holds two accumulators a head, which leaves no registers for a
//   second head, and a block whose key tiles are all dead writes zeros and
//   leaves.
// * fp32 (tests and oracles), and bf16 at any other D <= 128 (no model of the
//   package has one): K2b's kernels on CUDA cores with fp32 arithmetic. The
//   Hopper frame serves D = 64 alone.
#include "alibi_tf32.cuh"
#include "attention_bwd_common.cuh"
#include "attention_wgmma.cuh"

namespace mt {

template <int DP, bool DUAL>
constexpr size_t alibi_bwd_bytes() {
  return BwdPlan<DP, DUAL>::bytes + sizeof(float) * 3 * (kBlockQ + kBlockK);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
alibi_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ coords, const float* __restrict__ slopes,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  BwdTiles<DP, false> t(smem);
  constexpr int S = BwdPlan<DP, false>::S;
  float* qc = smem + BwdPlan<DP, false>::floats;  // [3][kBlockQ]
  float* kc = qc + 3 * kBlockQ;                   // [3][kBlockK]
  const AlibiTerm term{qc, kc};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, N - q0);
  const size_t qrow0 = static_cast<size_t>(bh) * N + q0;
  const T* kb = k + static_cast<size_t>(bh) * N * D;
  const T* vb = v + static_cast<size_t>(bh) * N * D;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;
  const auto qrow = [D](int r) { return static_cast<size_t>(r) * D; };

  load_rows<DP, kBlockQ, S>(t.a1, q + qrow0 * D, nq, D, scale, qrow);
  load_rows<DP, kBlockQ, S>(t.a2, dout + qrow0 * D, nq, D, 1.f, qrow);
  load_coords(qc, cb, q0, nq, slopes[bh % H]);
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    t.lse[i] = i < nq ? lse_for_bwd(lse[qrow0 + i]) : 0.f;
    t.w[i] = 1.f;
    t.delta[i] = i < nq ? delta[qrow0 + i] : 0.f;
  }
  t.zero_acc();

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    const int nk = min(kBlockK, N - k0);
    __syncthreads();  // the previous tile is consumed
    const auto krow = [D, k0](int j) { return static_cast<size_t>(k0 + j) * D; };
    load_rows<DP, kBlockK, S>(t.b1, kb, nk, D, 1.f, krow);
    load_rows<DP, kBlockK, S>(t.b2, vb, nk, D, 1.f, krow);
    load_coords(kc, cb, k0, nk, 1.f);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads)
      t.bias[j] = j < nk ? (biasb == nullptr ? 0.f : biasb[k0 + j]) : kNegInf;
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nq; r0 += kWarps * kRowsPerWarp)
      bwd_fold<DP, false>(t, r0, 1, min(kRowsPerWarp, nq - r0), nk, warp, lane, term);
  }
  __syncthreads();
  store_rows<DP>(dq + qrow0 * D, t.acc1, nq, D, scale, qrow);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
alibi_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ coords, const float* __restrict__ slopes,
                     const float* __restrict__ bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  BwdTiles<DP, true> t(smem);
  constexpr int S = BwdPlan<DP, true>::S;
  float* qc = smem + BwdPlan<DP, true>::floats;  // [3][kBlockQ]
  float* kc = qc + 3 * kBlockQ;                  // [3][kBlockK]
  const AlibiTerm term{qc, kc};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * kBlockK;
  const int nk = min(kBlockK, N - k0);
  const size_t krow0 = static_cast<size_t>(bh) * N + k0;
  const size_t qrow0 = static_cast<size_t>(bh) * N;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float slope = slopes[bh % H];
  const auto row = [D](int r) { return static_cast<size_t>(r) * D; };

  load_rows<DP, kBlockK, S>(t.a1, k + krow0 * D, nk, D, 1.f, row);
  load_rows<DP, kBlockK, S>(t.a2, v + krow0 * D, nk, D, 1.f, row);
  load_coords(kc, cb, k0, nk, 1.f);
  for (int j = threadIdx.x; j < kBlockK; j += kThreads)
    t.bias[j] = j < nk ? (bias == nullptr ? 0.f : bias[static_cast<size_t>(b) * N + k0 + j])
                       : kNegInf;
  t.zero_acc();

  for (int q0 = 0; q0 < N; q0 += kBlockQ) {
    const int nq = min(kBlockQ, N - q0);
    __syncthreads();  // the previous tile is consumed
    const auto qrow = [D, q0](int i) { return static_cast<size_t>(q0 + i) * D; };
    load_rows<DP, kBlockQ, S>(t.b1, q + qrow0 * D, nq, D, scale, qrow);
    load_rows<DP, kBlockQ, S>(t.b2, dout + qrow0 * D, nq, D, 1.f, qrow);
    load_coords(qc, cb, q0, nq, slope);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      t.lse[i] = i < nq ? lse_for_bwd(lse[qrow0 + q0 + i]) : 0.f;
      t.w[i] = 1.f;
      t.delta[i] = i < nq ? delta[qrow0 + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nk; r0 += kWarps * kRowsPerWarp)
      bwd_fold<DP, true>(t, r0, 1, min(kRowsPerWarp, nk - r0), nq, warp, lane, term);
  }
  __syncthreads();
  store_rows<DP>(dv + krow0 * D, t.acc1, nk, D, 1.f, row);
  store_rows<DP>(dk + krow0 * D, t.acc2, nk, D, 1.f, row);
}

// bf16 at head dimension 64 on the Hopper frame (attention_wgmma.cuh): lse
// arrives in log2 units with +huge for a row without a valid key or past N
// (its P underflows to 0) and delta padded with zeros, both (B, H, NP).
//
// dq: a block owns 64 * W query rows of one batch row and G heads (their q
// and dout tiles stay in shared memory) and streams the live key tiles; a
// ring stage is the k and v tiles of one (key tile, head) pair with the
// tile's coordinate planes and key terms.
template <int G, int W>
struct AlibiDqWg {
  static constexpr int kStages = 4;
  static constexpr int kThreads = (W + 1) * wg::kWgThreads;
  static constexpr int kPlanes = 2 * wg::kTileBytes;
  static constexpr int kKeyAdd = kPlanes + 3 * wg::kRowBytes;
  static constexpr int kStageBytes = kKeyAdd + wg::kRowBytes;
  static constexpr int kOwnBytes = 2 * W * G * wg::kTileBytes;   // q then dout
  static constexpr int kBars = kOwnBytes + kStages * kStageBytes;
  static constexpr size_t bytes = 1024 + kBars + (2 * kStages + 1) * sizeof(uint64_t);
  static_assert(kStageBytes % 1024 == 0, "a stage keeps its tiles 1024-byte aligned");
  static_assert(bytes <= 232448 / (W == 1 ? 2 : 1), "over the shared memory of the blocks");
};

template <int G, int W>
__global__ void __launch_bounds__(AlibiDqWg<G, W>::kThreads, W == 1 ? 2 : 1)
alibi_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do, const wg::SideInputs side,
                       const float* __restrict__ slopes, const float* __restrict__ lse2,
                       const float* __restrict__ delta, bf16* __restrict__ dq, int H, int N,
                       float scale) {
  using P = AlibiDqWg<G, W>;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_wg) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = smem + P::kOwnBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + P::kStages;
  uint64_t* own_bar = empty + P::kStages;

  const int n_tiles = (N + wg::kTile - 1) / wg::kTile, NP = n_tiles * wg::kTile;
  const int b = blockIdx.z, h0 = blockIdx.y * G, gn = min(G, H - h0);
  const int q0 = blockIdx.x * (wg::kTile * W);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 4 * W);
    }
    wg::mbar_init(own_bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * W) {
    // ---- producer: one lane keeps the ring full ----
    wg::give_registers<wg::kProducerRegs>();
    if (threadIdx.x != W * wg::kWgThreads) return;
    wg::mbar_expect(own_bar, 2 * W * gn * wg::kTileBytes);
    for (int w = 0; w < W; ++w)
      for (int g = 0; g < gn; ++g) {
        unsigned char* own = smem + 2 * (w * G + g) * wg::kTileBytes;
        wg::tma_tile(own, &map_q, own_bar, q0 + wg::kTile * w, b * H + h0 + g);
        wg::tma_tile(own + wg::kTileBytes, &map_do, own_bar, q0 + wg::kTile * w, b * H + h0 + g);
      }
    const int* live = side.tile_live + b * n_tiles;
    wg::Ring r;
    for (int kt = 0; kt < n_tiles; ++kt) {
      if (live[kt] == 0) continue;   // a dead key tile is never loaded
      const int k0 = kt * wg::kTile;
      for (int g = 0; g < gn; ++g) {
        wg::mbar_wait(empty + r.stage, r.phase ^ 1);
        unsigned char* st = ring + r.stage * P::kStageBytes;
        wg::mbar_expect(full + r.stage, P::kStageBytes);
        wg::tma_tile(st, &map_k, full + r.stage, k0, b * H + h0 + g);
        wg::tma_tile(st + wg::kTileBytes, &map_v, full + r.stage, k0, b * H + h0 + g);
        for (int p = 0; p < 3; ++p)
          wg::bulk_copy(st + P::kPlanes + p * wg::kRowBytes,
                        side.coords_t + (static_cast<size_t>(b) * 3 + p) * NP + k0,
                        wg::kRowBytes, full + r.stage);
        wg::bulk_copy(st + P::kKeyAdd, side.key_add + static_cast<size_t>(b) * NP + k0,
                      wg::kRowBytes, full + r.stage);
        r.advance<P::kStages>();
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows [q0 + 64 w, + 64) ----
  wg::take_registers<wg::kConsumerRegs<W>>();
  const int w = warp / 4;
  const wg::Lane ln;
  const int my_q0 = q0 + wg::kTile * w;
  const float scale2 = scale * wg::kLog2e;
  const int n_live = wg::count_live(side.tile_live + b * n_tiles, n_tiles);
  float own[2][3];
  wg::own_coords(own, side.coords_t + static_cast<size_t>(b) * 3 * NP, NP, my_q0 + ln.row0);
  float nslope[G], acc[G][32], lse_r[G][2], delta_r[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    nslope[g] = g < gn ? -slopes[h0 + g] * wg::kLog2e : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = my_q0 + ln.row0 + 8 * r;
      const bool in = g < gn && qi < NP;
      const size_t at = (static_cast<size_t>(b) * H + h0 + g) * NP + qi;
      lse_r[g][r] = in ? lse2[at] : 1e30f;
      delta_r[g][r] = in ? delta[at] : 0.f;
    }
  }
  wg::mbar_wait(own_bar, 0);

  wg::Ring r;
  float dnc[32];
  for (int t = 0; t < n_live; ++t) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= gn) continue;
      wg::mbar_wait(full + r.stage, r.phase);
      const unsigned char* st = ring + r.stage * P::kStageBytes;
      const unsigned char* mine = smem + 2 * (w * G + g) * wg::kTileBytes;
      float s[32], dp[32];
      wg::wgmma_fence();
      wg::product_ss(s, wg::tile_desc(mine), wg::tile_desc(st));                     // q k^T
      wg::product_ss(dp, wg::tile_desc(mine + wg::kTileBytes),
                     wg::tile_desc(st + wg::kTileBytes));                            // dout v^T
      wg::wgmma_commit();
      if (g == 0)
        wg::distance_tile(dnc, own, reinterpret_cast<const float*>(st + P::kPlanes), ln.col0);
      const float* key_add = reinterpret_cast<const float*>(st + P::kKeyAdd);
      wg::wgmma_wait<0>();
      wg::hold(s);
      wg::hold(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 ka = *reinterpret_cast<const float2*>(key_add + 8 * j + ln.col0);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          const float p0 = wg::exp2_fast(
              fmaf(s[i], scale2, fmaf(nslope[g], dnc[i], ka.x)) - lse_r[g][rr]);
          const float p1 = wg::exp2_fast(
              fmaf(s[i + 1], scale2, fmaf(nslope[g], dnc[i + 1], ka.y)) - lse_r[g][rr]);
          s[i] = p0 * (dp[i] - delta_r[g][rr]);          // dS
          s[i + 1] = p1 * (dp[i + 1] - delta_r[g][rr]);
        }
      }
      uint32_t ds[16];
      wg::pack_tile(ds, s);
      wg::wgmma_fence();
      wg::product_rs(acc[g], ds, wg::tile_desc(st));     // dq += dS k
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::hold(acc[g]);
      wg::hold(ds);
      if (threadIdx.x % 32 == 0) wg::mbar_arrive(empty + r.stage);
      r.advance<P::kStages>();
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= gn) continue;
    const size_t bh = static_cast<size_t>(b) * H + h0 + g;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = my_q0 + ln.row0 + 8 * rr;
      if (row >= N) continue;
      bf16* drow = dq + (bh * N + row) * wg::kD + ln.col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
            __floats2bfloat162_rn(acc[g][i] * scale, acc[g][i + 1] * scale);
      }
    }
  }
}

// dk/dv: a block owns W key tiles of one (batch row, head) (their k and v
// tiles stay in shared memory) and streams every query tile; a ring stage
// is the q and dout tiles with the queries' coordinate planes, lse and
// delta. The own rows are keys, so the score tile is computed transposed,
// S^T = k q^T, and P^T and dS^T feed dv += P^T dout and dk += dS^T q from
// registers. A block whose key tiles are all dead writes zeros and leaves.
template <int W>
struct AlibiDkvWg {
  static constexpr int kStages = 4;
  static constexpr int kThreads = (W + 1) * wg::kWgThreads;
  static constexpr int kPlanes = 2 * wg::kTileBytes;
  static constexpr int kLse = kPlanes + 3 * wg::kRowBytes;
  static constexpr int kDelta = kLse + wg::kRowBytes;
  static constexpr int kCopied = kDelta + wg::kRowBytes;
  static constexpr int kStageBytes = (kCopied + 1023) / 1024 * 1024;
  static constexpr int kOwnBytes = 2 * W * wg::kTileBytes;   // k then v
  static constexpr int kBars = kOwnBytes + kStages * kStageBytes;
  static constexpr size_t bytes = 1024 + kBars + (2 * kStages + 1) * sizeof(uint64_t);
  static_assert(bytes <= 232448 / (W == 1 ? 2 : 1), "over the shared memory of the blocks");
};

template <int W>
__global__ void __launch_bounds__(AlibiDkvWg<W>::kThreads, W == 1 ? 2 : 1)
alibi_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do, const wg::SideInputs side,
                        const float* __restrict__ slopes, const float* __restrict__ lse2,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int N, float scale) {
  using P = AlibiDkvWg<W>;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_wg) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = smem + P::kOwnBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + P::kStages;
  uint64_t* own_bar = empty + P::kStages;

  const int n_tiles = (N + wg::kTile - 1) / wg::kTile, NP = n_tiles * wg::kTile;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int k0 = blockIdx.x * (wg::kTile * W);
  const int warp = threadIdx.x / 32;

  bool any_live = false;
  for (int w = 0; w < W; ++w) {
    const int kt = blockIdx.x * W + w;
    any_live |= kt < n_tiles && side.tile_live[b * n_tiles + kt] != 0;
  }
  if (!any_live) {
    const int rows = min(wg::kTile * W, N - k0);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < rows * (wg::kD / 8); i += P::kThreads) {
      reinterpret_cast<uint4*>(dk + (bh * N + k0) * wg::kD)[i] = zero;
      reinterpret_cast<uint4*>(dv + (bh * N + k0) * wg::kD)[i] = zero;
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 4 * W);
    }
    wg::mbar_init(own_bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * W) {
    // ---- producer: one lane streams the query tiles ----
    wg::give_registers<wg::kProducerRegs>();
    if (threadIdx.x != W * wg::kWgThreads) return;
    wg::mbar_expect(own_bar, 2 * W * wg::kTileBytes);
    for (int w = 0; w < W; ++w) {
      unsigned char* own = smem + 2 * w * wg::kTileBytes;
      wg::tma_tile(own, &map_k, own_bar, k0 + wg::kTile * w, static_cast<int>(bh));
      wg::tma_tile(own + wg::kTileBytes, &map_v, own_bar, k0 + wg::kTile * w,
                   static_cast<int>(bh));
    }
    wg::Ring r;
    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = t * wg::kTile;
      wg::mbar_wait(empty + r.stage, r.phase ^ 1);
      unsigned char* st = ring + r.stage * P::kStageBytes;
      wg::mbar_expect(full + r.stage, P::kCopied);
      wg::tma_tile(st, &map_q, full + r.stage, q0, static_cast<int>(bh));
      wg::tma_tile(st + wg::kTileBytes, &map_do, full + r.stage, q0, static_cast<int>(bh));
      for (int p = 0; p < 3; ++p)
        wg::bulk_copy(st + P::kPlanes + p * wg::kRowBytes,
                      side.coords_t + (static_cast<size_t>(b) * 3 + p) * NP + q0, wg::kRowBytes,
                      full + r.stage);
      wg::bulk_copy(st + P::kLse, lse2 + bh * NP + q0, wg::kRowBytes, full + r.stage);
      wg::bulk_copy(st + P::kDelta, delta + bh * NP + q0, wg::kRowBytes, full + r.stage);
      r.advance<P::kStages>();
    }
    return;
  }

  // ---- consumers: warpgroup w owns key rows [k0 + 64 w, + 64) ----
  wg::take_registers<wg::kConsumerRegs<W>>();
  const int w = warp / 4;
  const wg::Lane ln;
  const int my_k0 = k0 + wg::kTile * w;
  const float scale2 = scale * wg::kLog2e;
  const float nslope = -slopes[h] * wg::kLog2e;
  float own[2][3], key_add[2];
  wg::own_coords(own, side.coords_t + static_cast<size_t>(b) * 3 * NP, NP, my_k0 + ln.row0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = my_k0 + ln.row0 + 8 * r;
    key_add[r] = kj < NP ? side.key_add[static_cast<size_t>(b) * NP + kj] : -INFINITY;
  }
  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const unsigned char* mine = smem + 2 * w * wg::kTileBytes;
  wg::mbar_wait(own_bar, 0);

  wg::Ring r;
  for (int t = 0; t < n_tiles; ++t) {
    wg::mbar_wait(full + r.stage, r.phase);
    const unsigned char* st = ring + r.stage * P::kStageBytes;
    float s[32], dp[32], dnc[32];
    wg::wgmma_fence();
    wg::product_ss(s, wg::tile_desc(mine), wg::tile_desc(st));                        // k q^T
    wg::product_ss(dp, wg::tile_desc(mine + wg::kTileBytes),
                   wg::tile_desc(st + wg::kTileBytes));                               // v dout^T
    wg::wgmma_commit();
    wg::distance_tile(dnc, own, reinterpret_cast<const float*>(st + P::kPlanes), ln.col0);
    const float* q_lse = reinterpret_cast<const float*>(st + P::kLse);
    const float* q_delta = reinterpret_cast<const float*>(st + P::kDelta);
    wg::wgmma_wait<0>();
    wg::hold(s);
    wg::hold(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(q_lse + 8 * j + ln.col0);
      const float2 dl = *reinterpret_cast<const float2*>(q_delta + 8 * j + ln.col0);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr;
        const float p0 =
            wg::exp2_fast(fmaf(s[i], scale2, fmaf(nslope, dnc[i], key_add[rr])) - ls.x);
        const float p1 =
            wg::exp2_fast(fmaf(s[i + 1], scale2, fmaf(nslope, dnc[i + 1], key_add[rr])) - ls.y);
        s[i] = p0;                                      // P^T
        s[i + 1] = p1;
        dp[i] = p0 * (dp[i] - dl.x);                    // dS^T
        dp[i + 1] = p1 * (dp[i + 1] - dl.y);
      }
    }
    uint32_t pt[16], dst[16];
    wg::pack_tile(pt, s);
    wg::pack_tile(dst, dp);
    wg::wgmma_fence();
    wg::product_rs(acc_dv, pt, wg::tile_desc(st + wg::kTileBytes));   // dv += P^T dout
    wg::product_rs(acc_dk, dst, wg::tile_desc(st));                   // dk += dS^T q
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(acc_dv);
    wg::hold(acc_dk);
    wg::hold(pt);
    wg::hold(dst);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(empty + r.stage);
    r.advance<P::kStages>();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = my_k0 + ln.row0 + 8 * rr;
    if (row >= N) continue;
    bf16* krow = dk + (bh * N + row) * wg::kD + ln.col0;
    bf16* vrow = dv + (bh * N + row) * wg::kD + ln.col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) =
          __floats2bfloat162_rn(acc_dk[i] * scale, acc_dk[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
          __floats2bfloat162_rn(acc_dv[i], acc_dv[i + 1]);
    }
  }
}

struct AlibiBwdWgArgs {
  const void *q, *k, *v, *dout;
  wg::SideInputs side;
  const float *slopes, *lse2, *delta;
  void *dq, *dk, *dv;
  int B, H, N;
  float scale;
  cudaStream_t stream;
};

// The Hopper kernels as they are built: the dq kernel with G = 2 heads on one
// distance tile and W = 2 consumer warpgroups a block, the dk/dv kernel with
// one warpgroup; the card's readings of the other choices are in PERF.md.
constexpr int kDqHeads = 2, kDqWarpgroups = 2, kDkvWarpgroups = 1;

// dq, then dk/dv.
inline cudaError_t launch_alibi_bwd_wg(const AlibiBwdWgArgs& a) {
  using PQ = AlibiDqWg<kDqHeads, kDqWarpgroups>;
  using PKV = AlibiDkvWg<kDkvWarpgroups>;
  CUtensorMap maps[4];
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = wg::make_tile_map(&maps[i], bases[i], a.B * a.H, a.N);
    if (err != cudaSuccess) return err;
  }
  auto kq = alibi_bwd_dq_wg_kernel<kDqHeads, kDqWarpgroups>;
  auto kkv = alibi_bwd_dkv_wg_kernel<kDkvWarpgroups>;
  cudaError_t err = allow_smem(kq, PQ::bytes);
  if (err == cudaSuccess) err = allow_smem(kkv, PKV::bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.N + wg::kTile - 1) / wg::kTile;
  const dim3 grid_q((n_tiles + kDqWarpgroups - 1) / kDqWarpgroups,
                    (a.H + kDqHeads - 1) / kDqHeads, a.B);
  kq<<<grid_q, PQ::kThreads, PQ::bytes, a.stream>>>(maps[0], maps[1], maps[2], maps[3], a.side,
                                                    a.slopes, a.lse2, a.delta,
                                                    static_cast<bf16*>(a.dq), a.H, a.N, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((n_tiles + kDkvWarpgroups - 1) / kDkvWarpgroups, a.H, a.B);
  kkv<<<grid_kv, PKV::kThreads, PKV::bytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.side, a.slopes, a.lse2, a.delta,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.N, a.scale);
  return cudaGetLastError();
}

template <int DP, typename T>
cudaError_t launch_alibi_bwd(const void* q, const void* k, const void* v, const float* coords,
                             const float* slopes, const float* bias, const void* dout,
                             const float* lse, const float* delta, void* dq, void* dk, void* dv,
                             int B, int H, int N, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes_q = alibi_bwd_bytes<DP, false>();
  constexpr size_t bytes_kv = alibi_bwd_bytes<DP, true>();
  static_assert(bytes_kv <= 232448, "over the H100's shared memory per block");
  auto kq = alibi_bwd_dq_kernel<DP, T>;
  auto kkv = alibi_bwd_dkv_kernel<DP, T>;
  cudaError_t err = allow_smem(kq, bytes_q);
  if (err == cudaSuccess) err = allow_smem(kkv, bytes_kv);
  if (err != cudaSuccess) return err;
  const auto tq = static_cast<const T*>(q);
  const auto tk = static_cast<const T*>(k);
  const auto tv = static_cast<const T*>(v);
  const auto tdo = static_cast<const T*>(dout);
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  kq<<<grid, kThreads, bytes_q, stream>>>(tq, tk, tv, coords, slopes, bias, tdo, lse, delta,
                                          static_cast<T*>(dq), H, N, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid, kThreads, bytes_kv, stream>>>(tq, tk, tv, coords, slopes, bias, tdo, lse, delta,
                                            static_cast<T*>(dk), static_cast<T*>(dv), H, N, D,
                                            scale);
  return cudaGetLastError();
}

// The CUDA-core kernels at the padded head dimension DP.
template <typename T>
cudaError_t dispatch_alibi_bwd(int DP, const void* q, const void* k, const void* v,
                               const float* coords, const float* slopes, const float* bias,
                               const void* dout, const float* lse, const float* delta, void* dq,
                               void* dk, void* dv, int B, int H, int N, int D, float scale,
                               cudaStream_t s) {
  switch (DP) {
#define MT_CASE(W)                                                                             \
  case W:                                                                                      \
    return launch_alibi_bwd<W, T>(q, k, v, coords, slopes, bias, dout, lse, delta, dq, dk, dv, \
                                  B, H, N, D, scale, s);
    MT_CASE(16)
    MT_CASE(32)
    MT_CASE(48)
    MT_CASE(64)
    MT_CASE(128)
#undef MT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mt

// q/k/v/dout/dq/dk/dv (B, H, N, D) contiguous in one dtype (0 = float32,
// 1 = bfloat16); coords (B, N, 3), slopes (H,), bias (B, N) or null, lse and
// delta (B, H, N), all fp32. bf16 at D = 64 runs on the Hopper frame and
// needs the side inputs (see wg::SideInputs), lse2 and delta_pad
// (B, H, NP); fp32 at D = 64 runs the 3xTF32 family and needs the side
// inputs, out and the fp32 scratch `work` (see launch_alibi_tf32_bwd), and makes its
// own delta (it reads neither delta, lse2 nor delta_pad); every other case
// ignores them. Returns a cudaError_t; 0 means the kernels were launched.
extern "C" int mt_alibi_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* coords, const void* slopes, const void* bias,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int B, int H, int N, int D,
                                      float scale, int dtype, const void* coords_t,
                                      const void* key_add, const void* tile_live,
                                      const void* lse2, const void* delta_pad, const void* out,
                                      void* work, void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || B < 1 || H < 1 || B * H > 65535 || N < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const float*>(coords);
  const auto sl = static_cast<const float*>(slopes);
  const auto bs = static_cast<const float*>(bias);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  const int fam = mt::alibi_family(D, dtype);
  if (fam == mt::kAlibiTf32x3) {
    if (coords_t == nullptr || key_add == nullptr || tile_live == nullptr || out == nullptr ||
        work == nullptr)
      return cudaErrorInvalidValue;
    const mt::wg::SideInputs side{static_cast<const float*>(coords_t),
                                  static_cast<const float*>(key_add),
                                  static_cast<const int*>(tile_live)};
    return mt::launch_alibi_tf32_bwd(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        side, sl, static_cast<const float*>(dout), static_cast<const float*>(out), l,
        static_cast<float*>(work), static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), B, H, N, scale, s);
  }
  if (dtype == 0)
    return mt::dispatch_alibi_bwd<float>(DP, q, k, v, c, sl, bs, dout, l, dl, dq, dk, dv, B, H,
                                         N, D, scale, s);
  if (fam == mt::kAlibiWgmma) {
    if (coords_t == nullptr || key_add == nullptr || tile_live == nullptr || lse2 == nullptr ||
        delta_pad == nullptr)
      return cudaErrorInvalidValue;
    const mt::AlibiBwdWgArgs a{q, k, v, dout,
                               {static_cast<const float*>(coords_t),
                                static_cast<const float*>(key_add),
                                static_cast<const int*>(tile_live)},
                               sl, static_cast<const float*>(lse2),
                               static_cast<const float*>(delta_pad), dq, dk, dv, B, H, N, scale,
                               s};
    return mt::launch_alibi_bwd_wg(a);
  }
  if (dtype == 1)
    return mt::dispatch_alibi_bwd<__nv_bfloat16>(DP, q, k, v, c, sl, bs, dout, l, dl, dq, dk,
                                                 dv, B, H, N, D, scale, s);
  return cudaErrorInvalidValue;
}
