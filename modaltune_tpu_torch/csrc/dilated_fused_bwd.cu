// LongNet dilated attention as per-branch attention plus a mix, backward (K3b).
//
// Replaces: modaltune_tpu/ops/dilated_fused.py::_branch_bwd_call (one Pallas
// TPU kernel per branch: P recomputed from the saved lse_b, the demix weight
// folded in, compact dq_b, dk_b, dv_b) and ::_combine_call (the sum of the
// branches' compact gradients to dense dq, dk, dv).
//
// Semantics (the plain oracles are ops/dilated_fused.py::
// fused_branch_backward_reference and ::fused_combine_reference; the layout
// is in dilated_fused_common.cuh). The forward saved each compact row's
// lse_b and the mix statistics m and Z, and no branch output: the Pallas
// kernels' residuals. With dmix the gradient of the mixed output and the
// mix weights taken as constants, per branch b and compact row i at
// position p:
//   w_i     = exp(lse_b,i - m_p) / Z_p where lse_b,i > NEG_INF / 2, else 0
//   dO_i    = w_i dmix_p
//   P_ij    = exp(q_i.k_j scale - lse_b,i)  (0 for a masked key; a row with a
//                                            masked lse uses +|NEG_INF/2|)
//   delta_i = rowsum_j(P_ij dO_i.v_j)       (= rowsum(dO_i * out_b,i))
//   dS_ij   = P_ij (dO_i.v_j - delta_i)
//   dq_b,i = sum_j dS_ij k_j scale, dk_b,j = sum_i dS_ij q_i scale,
//   dv_b,j = sum_i P_ij dO_i
// and dense dq, dk, dv at (p, head) sum the compact rows of the branches
// that cover the slot. The Pallas kernel holds a whole score row and takes
// delta from it as rowsum(P * dP); so do these kernels, over the streamed
// key tiles.
//
// Four launches, each covering every branch: a prep kernel writes w per
// compact row (and, for the CUDA-core kernels, delta, rebuilt over the
// row's keys by window_pdp: a warp a row, a lane a key); a dq kernel whose
// block owns 64 compact query rows of one (segment, head group) and streams
// its keys (the tensor-core core's takes delta there); a dk/dv kernel whose
// block owns 64 compact key rows and streams its queries; the combine
// kernel (a warp per (token, head)) adds the branches' rows. The compact
// gradients are an fp32 scratch, so bf16 inputs round each dense gradient
// once. No atomics. Three families of the dq and dk/dv kernels
// (mt::dilated_family), the tensor-core cores shared with K1b:
// * bf16 at D = 48 (GigaPath's head size): the wgmma core of
//   dilated_bwd_wgmma.cu;
// * fp32 at D = 48: the 3xTF32 core of dilated_bwd_tf32.cu;
// * fp32 and bf16 at any other D: the CUDA-core kernels below.
//
// What bounds it on the H100: operations, five products per query-key pair
// (dilated_bwd_wgmma.cu; at fp32 three TF32 products each,
// dilated_bwd_tf32.cu). The CUDA-core kernels run them in fp32 and are
// bound by that arithmetic rate and shared-memory bandwidth. The combine
// kernel is bound by device memory (about 12.5 times q's bytes), and so is
// the tensor-core families' prep.
//
// What the CUDA-core kernels do about it: q/k/v/dmix are read in place with
// strided rows; every row of a block's tile takes part in every streamed
// tile; the gradient update is K1b's and K2b's (attention_bwd_common.cuh).
#include <type_traits>

#include "dilated_wgmma.cuh"

namespace mt {

// w per compact row of a (B, H, M) tensor, a thread a row; with DELTA (the
// CUDA-core kernels) delta too, a warp a row.
template <typename T, bool DELTA>
__global__ void __launch_bounds__(kThreads)
fused_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const unsigned char* __restrict__ mask, const T* __restrict__ dmix,
                      const float* __restrict__ lse_c, const float* __restrict__ m_in,
                      const float* __restrict__ z_in, float* __restrict__ w_c,
                      float* __restrict__ delta_c, int B, int L, int H, int D, float scale,
                      FusedBranches fb) {
  __shared__ float qd[DELTA ? kWarps : 1][2 * 32 * kMaxDimsPerLane];
  const size_t gw =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / (DELTA ? 32 : 1);
  const int lane = DELTA ? threadIdx.x % 32 : 0;
  const int M = fb.off[fb.n];
  if (gw >= static_cast<size_t>(B) * H * M) return;
  const int row = static_cast<int>(gw % M);
  const size_t bh = gw / M;
  const int h = static_cast<int>(bh % H);
  int bi = 0;
  while (bi + 1 < fb.n && row >= fb.off[bi + 1]) ++bi;
  const int m = fb.m[bi], sl = fb.seg[bi], r = fb.ratio[bi];
  const int seg = (row - fb.off[bi]) / m, l = (row - fb.off[bi]) - seg * m;
  const int g = head_group(h, H, r);
  const int o = l * r + g;
  const int p = seg * sl + o;
  const float lse = lse_c[gw];
  float wb = 0.f, delta = 0.f;
  if (o < sl && p < L && lse > kMaskThreshold) {
    const float z = z_in[bh * L + p];
    wb = expf(lse - m_in[bh * L + p]) / (z > 0.f ? z : 1.f);
    if constexpr (DELTA) {
      const size_t b = bh / H, tok = static_cast<size_t>(H) * D;
      const size_t head0 = b * L * tok + static_cast<size_t>(h) * D;
      const int s0 = seg * sl;
      delta = wb * window_pdp(q + head0 + p * tok, dmix + head0 + p * tok, k + head0, v + head0,
                              tok, mask == nullptr ? nullptr : mask + b * L,
                              s0 + g, r, ceil_div_nonneg(min(s0 + sl, L) - s0 - g, r), lse,
                              scale, D, qd[threadIdx.x / 32]);
    }
  }
  if (lane == 0) {
    w_c[gw] = wb;
    if (DELTA) delta_c[gw] = delta;
  }
}

// The statistics of the compact query rows base + i, i < n, into the tile's
// lse/w/delta arrays (rows past n get values that zero P).
template <int DP, bool DUAL>
__device__ __forceinline__ void load_compact_stats(const BwdTiles<DP, DUAL>& t,
                                                   const float* lse_c, const float* w_c,
                                                   const float* delta_c, size_t base, int n) {
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    const bool in = i < n;
    t.lse[i] = in ? lse_for_bwd(lse_c[base + i]) : -kMaskThreshold;
    t.w[i] = in ? w_c[base + i] : 0.f;
    t.delta[i] = in ? delta_c[base + i] : 0.f;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
fused_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const unsigned char* __restrict__ mask, const T* __restrict__ dmix,
                    const float* __restrict__ lse_c, const float* __restrict__ w_c,
                    const float* __restrict__ delta_c, float* __restrict__ dq_c, int L, int H,
                    int D, float scale, FusedBranches fb) {
  extern __shared__ float4 smem4[];
  BwdTiles<DP, false> t(reinterpret_cast<float*>(smem4));
  constexpr int S = BwdPlan<DP, false>::S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const FusedTile ft = locate_tile(fb, blockIdx.x, h, H, L);
  const int r = ft.r, nq = ft.n_own;
  const size_t tok = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * fb.off[fb.n] + ft.seg_row + ft.l0;

  const int qpos0 = ft.first + r * ft.l0;  // position of own row i is qpos0 + r*i
  const auto own = [qpos0, r, tok](int i) { return static_cast<size_t>(qpos0 + r * i) * tok; };
  load_rows<DP, kBlockQ, S>(t.a1, q + head0, nq, D, scale, own);
  load_rows<DP, kBlockQ, S>(t.a2, dmix + head0, nq, D, 1.f, own);
  load_compact_stats(t, lse_c, w_c, delta_c, row0, nq);
  t.zero_acc();

  if (nq > 0) {
    for (int t0 = 0; t0 < ft.n_real; t0 += kBlockK) {
      const int nk = min(kBlockK, ft.n_real - t0);
      const int pos0 = ft.first + r * t0;  // position of key j is pos0 + r*j
      __syncthreads();  // the previous tile is consumed
      const auto row = [pos0, r, tok](int j) { return static_cast<size_t>(pos0 + r * j) * tok; };
      load_rows<DP, kBlockK, S>(t.b1, k + head0, nk, D, 1.f, row);
      load_rows<DP, kBlockK, S>(t.b2, v + head0, nk, D, 1.f, row);
      for (int j = threadIdx.x; j < kBlockK; j += kThreads)
        t.bias[j] = (j < nk && (maskb == nullptr || maskb[pos0 + r * j])) ? 0.f : kNegInf;
      __syncthreads();
      for (int i = warp * kRowsPerWarp; i < nq; i += kWarps * kRowsPerWarp)
        bwd_fold<DP, false>(t, i, 1, min(kRowsPerWarp, nq - i), nk, warp, lane);
    }
  }
  __syncthreads();
  store_rows<DP>(dq_c + row0 * D, t.acc1, ft.n_rows, D, scale,
                 [D](int i) { return static_cast<size_t>(i) * D; });
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
fused_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const unsigned char* __restrict__ mask, const T* __restrict__ dmix,
                     const float* __restrict__ lse_c, const float* __restrict__ w_c,
                     const float* __restrict__ delta_c, float* __restrict__ dk_c,
                     float* __restrict__ dv_c, int L, int H, int D, float scale,
                     FusedBranches fb) {
  extern __shared__ float4 smem4[];
  BwdTiles<DP, true> t(reinterpret_cast<float*>(smem4));
  constexpr int S = BwdPlan<DP, true>::S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const FusedTile ft = locate_tile(fb, blockIdx.x, h, H, L);
  const int r = ft.r, nk = ft.n_own;
  const size_t tok = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;
  const size_t seg0 = (static_cast<size_t>(b) * H + h) * fb.off[fb.n] + ft.seg_row;
  const size_t row0 = seg0 + ft.l0;

  const int kpos0 = ft.first + r * ft.l0;  // position of own row j is kpos0 + r*j
  const auto own = [kpos0, r, tok](int j) { return static_cast<size_t>(kpos0 + r * j) * tok; };
  load_rows<DP, kBlockK, S>(t.a1, k + head0, nk, D, 1.f, own);
  load_rows<DP, kBlockK, S>(t.a2, v + head0, nk, D, 1.f, own);
  // a masked key gets no probability, so zero gradients
  for (int j = threadIdx.x; j < kBlockK; j += kThreads)
    t.bias[j] = (j < nk && (maskb == nullptr || maskb[kpos0 + r * j])) ? 0.f : kNegInf;
  t.zero_acc();

  if (nk > 0) {
    for (int t0 = 0; t0 < ft.n_real; t0 += kBlockQ) {
      const int nq = min(kBlockQ, ft.n_real - t0);
      const int pos0 = ft.first + r * t0;  // position of query i is pos0 + r*i
      __syncthreads();  // the previous tile is consumed
      const auto row = [pos0, r, tok](int i) { return static_cast<size_t>(pos0 + r * i) * tok; };
      load_rows<DP, kBlockQ, S>(t.b1, q + head0, nq, D, scale, row);
      load_rows<DP, kBlockQ, S>(t.b2, dmix + head0, nq, D, 1.f, row);
      load_compact_stats(t, lse_c, w_c, delta_c, seg0 + t0, nq);
      __syncthreads();
      for (int j = warp * kRowsPerWarp; j < nk; j += kWarps * kRowsPerWarp)
        bwd_fold<DP, true>(t, j, 1, min(kRowsPerWarp, nk - j), nq, warp, lane);
    }
  }
  __syncthreads();
  const auto compact = [D](int i) { return static_cast<size_t>(i) * D; };
  store_rows<DP>(dv_c + row0 * D, t.acc1, ft.n_rows, D, 1.f, compact);
  store_rows<DP>(dk_c + row0 * D, t.acc2, ft.n_rows, D, 1.f, compact);
}

// A warp per (token, head), lanes over D: the dense gradients.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_combine_kernel(const float* __restrict__ dq_c, const float* __restrict__ dk_c,
                     const float* __restrict__ dv_c, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, int B, int L, int H, int D, FusedBranches fb) {
  const size_t gw = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= static_cast<size_t>(B) * L * H) return;
  const int h = static_cast<int>(gw % H);
  const int p = static_cast<int>((gw / H) % L);
  const int b = static_cast<int>(gw / (static_cast<size_t>(H) * L));
  const size_t rows0 = (static_cast<size_t>(b) * H + h) * fb.off[fb.n];
  const bool query = in_query_range(fb, p);  // dq is 0 outside the range
  float acc[3][kMaxDimsPerLane];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < kMaxDimsPerLane; ++e) acc[g][e] = 0.f;
  for (int bi = 0; bi < fb.n; ++bi) {
    const int row = covering_row(fb, bi, p, h, H);
    if (row < 0) continue;
    const size_t at = (rows0 + row) * D;
#pragma unroll
    for (int e = 0; e < kMaxDimsPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        if (query) acc[0][e] += dq_c[at + d];
        acc[1][e] += dk_c[at + d];
        acc[2][e] += dv_c[at + d];
      }
    }
  }
  const size_t dst = gw * D;  // (b, p, h) row of a (B, L, H, D) tensor
#pragma unroll
  for (int e = 0; e < kMaxDimsPerLane; ++e) {
    const int d = lane + 32 * e;
    if (d < D) {
      dq[dst + d] = from_float<T>(acc[0][e]);
      dk[dst + d] = from_float<T>(acc[1][e]);
      dv[dst + d] = from_float<T>(acc[2][e]);
    }
  }
}

struct FusedBwdArgs {
  const void *q, *k, *v;
  const unsigned char* mask;
  const void* dmix;
  const float *lse_c, *m_in, *z_in;
  float *w_c, *delta_c, *dq_c, *dk_c, *dv_c;
  void *dq, *dk, *dv;
  int B, L, H, D;
  float scale;
};

template <typename T, bool DELTA>
cudaError_t launch_fused_bwd_prep(const FusedBwdArgs& a, const FusedBranches& fb,
                                  cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(a.B) * a.H * fb.off[fb.n];
  const size_t per_block = DELTA ? kWarps : kThreads;
  fused_bwd_prep_kernel<T, DELTA>
      <<<static_cast<unsigned>((rows + per_block - 1) / per_block), kThreads, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          a.mask, static_cast<const T*>(a.dmix), a.lse_c, a.m_in, a.z_in, a.w_c, a.delta_c, a.B,
          a.L, a.H, a.D, a.scale, fb);
  return cudaGetLastError();
}

// The CUDA-core family: prep, dq, dk/dv, combine.
template <int DP, typename T>
cudaError_t launch_fused_bwd(const FusedBwdArgs& a, const FusedBranches& fb,
                             cudaStream_t stream) {
  auto kq = fused_bwd_dq_kernel<DP, T>;
  auto kkv = fused_bwd_dkv_kernel<DP, T>;
  cudaError_t err = allow_smem(kq, BwdPlan<DP, false>::bytes);
  if (err == cudaSuccess) err = allow_smem(kkv, BwdPlan<DP, true>::bytes);
  if (err == cudaSuccess) err = launch_fused_bwd_prep<T, true>(a, fb, stream);
  if (err != cudaSuccess) return err;
  const auto tq = static_cast<const T*>(a.q);
  const auto tk = static_cast<const T*>(a.k);
  const auto tv = static_cast<const T*>(a.v);
  const auto tdm = static_cast<const T*>(a.dmix);
  const dim3 grid(fb.tile0[fb.n], a.H, a.B);
  kq<<<grid, kThreads, BwdPlan<DP, false>::bytes, stream>>>(
      tq, tk, tv, a.mask, tdm, a.lse_c, a.w_c, a.delta_c, a.dq_c, a.L, a.H, a.D, a.scale, fb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid, kThreads, BwdPlan<DP, true>::bytes, stream>>>(
      tq, tk, tv, a.mask, tdm, a.lse_c, a.w_c, a.delta_c, a.dk_c, a.dv_c, a.L, a.H, a.D,
      a.scale, fb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_compact_combine(a.dq_c, a.dk_c, a.dv_c, a.dq, a.dk, a.dv, a.B, a.L, a.H, a.D,
                                fb, std::is_same<T, float>::value ? 0 : 1, stream);
}

cudaError_t launch_compact_combine(const float* dq_c, const float* dk_c, const float* dv_c,
                                   void* dq, void* dk, void* dv, int B, int L, int H, int D,
                                   const FusedBranches& fb, int dtype, cudaStream_t stream) {
  const size_t slots = static_cast<size_t>(B) * L * H;
  const unsigned blocks = static_cast<unsigned>((slots + kWarps - 1) / kWarps);
  if (dtype == 0)
    fused_combine_kernel<float><<<blocks, kThreads, 0, stream>>>(
        dq_c, dk_c, dv_c, static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), B, L, H, D, fb);
  else
    fused_combine_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        dq_c, dk_c, dv_c, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), B, L, H, D, fb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fused_bwd(int DP, const FusedBwdArgs& a, const FusedBranches& fb,
                               cudaStream_t s) {
  switch (DP) {
    case 16: return launch_fused_bwd<16, T>(a, fb, s);
    case 32: return launch_fused_bwd<32, T>(a, fb, s);
    case 48: return launch_fused_bwd<48, T>(a, fb, s);
    case 64: return launch_fused_bwd<64, T>(a, fb, s);
    case 128: return launch_fused_bwd<128, T>(a, fb, s);
    default: return cudaErrorInvalidValue;
  }
}

// A tensor-core family (1: bf16, 2: fp32): prep, the family's gradient
// core, combine.
inline cudaError_t launch_fused_bwd_compact(const FusedBwdArgs& a, const FusedBranches& fb,
                                            int family, cudaStream_t s) {
  cudaError_t err = family == 2 ? launch_fused_bwd_prep<float, false>(a, fb, s)
                                : launch_fused_bwd_prep<__nv_bfloat16, false>(a, fb, s);
  if (err != cudaSuccess) return err;
  const DilatedBwdCore c{a.q,    a.k,     a.v,       a.dmix, a.mask, a.lse_c, a.w_c, a.delta_c,
                         a.dq_c, a.dk_c,  a.dv_c,    a.B,    a.L,    a.H,     a.scale};
  err = launch_bwd_core(family, c, fb, s);
  if (err != cudaSuccess) return err;
  return launch_compact_combine(a.dq_c, a.dk_c, a.dv_c, a.dq, a.dk, a.dv, a.B, a.L, a.H, a.D,
                                fb, family == 2 ? 0 : 1, s);
}

}  // namespace mt

// q/k/v/dmix/dq/dk/dv (B, L, H, D) contiguous in one dtype (0 = float32,
// 1 = bfloat16); mask (B, L) bytes (1 = valid) or null; lse_c (B, H, M),
// m_in and z_in (B, H, L) as the forward wrote them; w_c and delta_c
// (B, H, M) and dq_c, dk_c, dv_c (B, H, M, D) fp32 scratch; the tensor-core
// families (D = 48, bf16 or fp32) take q/k/v/dmix 16-byte aligned.
// Returns a cudaError_t; 0 means all four kernels were launched.
extern "C" int mt_dilated_fused_bwd(const void* q, const void* k, const void* v, const void* mask,
                                    const void* dmix, const void* lse_c,
                                    const void* m_in, const void* z_in, void* w_c, void* delta_c,
                                    void* dq_c, void* dk_c, void* dv_c, void* dq, void* dk,
                                    void* dv, int B, int L, int H, int D, const int* segments,
                                    const int* ratios, int n_branches, float scale, int dtype,
                                    void* stream) {
  const int DP = mt::padded_head_dim(D);
  mt::FusedBranches fb{};
  if (DP < 0 || B < 1 || B > 65535 || H < 1 || H > 65535 ||
      !mt::make_fused_branches(fb, L, segments, ratios, n_branches))
    return cudaErrorInvalidValue;
  const mt::FusedBwdArgs a{q, k, v, static_cast<const unsigned char*>(mask), dmix,
                           static_cast<const float*>(lse_c), static_cast<const float*>(m_in),
                           static_cast<const float*>(z_in), static_cast<float*>(w_c),
                           static_cast<float*>(delta_c), static_cast<float*>(dq_c),
                           static_cast<float*>(dk_c), static_cast<float*>(dv_c), dq, dk, dv,
                           B, L, H, D, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  const int family = mt::dilated_family(D, dtype);
  if (family != 0) return mt::launch_fused_bwd_compact(a, fb, family, s);
  if (dtype == 0) return mt::dispatch_fused_bwd<float>(DP, a, fb, s);
  if (dtype == 1) return mt::dispatch_fused_bwd<__nv_bfloat16>(DP, a, fb, s);
  return cudaErrorInvalidValue;
}
