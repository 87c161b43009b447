// LongNet dilated attention as per-branch attention plus a mix, forward (K3f).
//
// Replaces: modaltune_tpu/ops/dilated_fused.py::_branch_fwd_call (one Pallas
// TPU kernel per branch: softmax attention over each (segment, head group)'s
// sparse rows, written as a compact (out_b, lse_b)) and ::_mix_call (the
// per-(token, head) softmax(lse) mix of the branches, with the statistics
// m and Z its backward reuses).
//
// Semantics (the plain oracles are ops/dilated_fused.py::
// fused_branch_reference and ::fused_mix_reference; the layout is in
// dilated_fused_common.cuh). Branch kernel: within a (segment, head group)
// every real row attends the real rows whose position is a valid key
// (mask != 0); out_b = softmax(q k^T scale) v and lse_b per row, 0 and
// NEG_INF for a row that is no real position or has no valid key. Mix
// kernel, per (token, head): m = max_b lse_b over the branches that cover
// the slot, Z = sum_b exp(lse_b - m) over those with lse_b > NEG_INF / 2,
// mixed = sum_b exp(lse_b - m) out_b / Z (0 where Z = 0).
//
// Two launches: the branch kernel covers every branch at once (blockIdx.x
// enumerates the 64-row tiles of all branches), the mix kernel every
// (token, head).
//
// What bounds it on the H100: the branch kernel, like K1f
// (dilated_attention_fwd.cu), runs its products on CUDA cores in fp32 and is
// bound by the fp32 arithmetic rate and shared-memory bandwidth; the mix kernel moves
// about three times q's bytes and is bound by device memory.
//
// What the design does about it: q/k/v are read in place in (B, L, H, D)
// with strided rows, so no gathered copy of them is ever written; a block's
// 64 query rows all belong to one (segment, head group), so unlike K1f's
// position tiles every row of the tile takes part in every key tile it
// loads, whatever the ratio. The online softmax, its tiles and the fold are
// K1f's and K2f's (attention_common.cuh).
#include "dilated_fused_common.cuh"

namespace mt {

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
fused_branch_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const unsigned char* __restrict__ mask, T* __restrict__ out_c,
                        float* __restrict__ lse_c, int L, int H, int D, float scale,
                        FusedBranches fb) {
  extern __shared__ float4 smem4[];
  Tiles<DP> t(reinterpret_cast<float*>(smem4));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const FusedTile ft = locate_tile(fb, blockIdx.x, h, H, L);
  const int r = ft.r, nq = ft.n_own;
  const size_t tok = static_cast<size_t>(H) * D;  // stride between positions
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;

  const int qpos0 = ft.first + r * ft.l0;  // position of own row i is qpos0 + r*i
  load_rows<DP, kBlockQ, Plan<DP>::QS>(t.q, q + head0, nq, D, scale, [qpos0, r, tok](int i) {
    return static_cast<size_t>(qpos0 + r * i) * tok;
  });
  t.init_state();

  if (nq > 0) {
    for (int t0 = 0; t0 < ft.n_real; t0 += kBlockK) {
      const int nk = min(kBlockK, ft.n_real - t0);
      const int pos0 = ft.first + r * t0;  // position of key j is pos0 + r*j
      __syncthreads();  // the previous tile is consumed
      const auto row = [pos0, r, tok](int j) { return static_cast<size_t>(pos0 + r * j) * tok; };
      load_rows<DP, kBlockK, Plan<DP>::KS>(t.k, k + head0, nk, D, 1.f, row);
      load_rows<DP, kBlockK, DP>(t.v, v + head0, nk, D, 1.f, row);
      for (int j = threadIdx.x; j < kBlockK; j += kThreads)
        t.bias[j] = (j < nk && (maskb == nullptr || maskb[pos0 + r * j])) ? 0.f : kNegInf;
      __syncthreads();
      for (int i = warp * kRowsPerWarp; i < nq; i += kWarps * kRowsPerWarp)
        fold_rows<DP>(t, i, 1, min(kRowsPerWarp, nq - i), nk, warp, lane);
    }
  }
  __syncthreads();

  // rows past the real ones keep l = 0: out 0, lse NEG_INF
  const size_t row0 =
      (static_cast<size_t>(b) * H + h) * fb.off[fb.n] + ft.seg_row + ft.l0;
  for (int i = warp; i < ft.n_rows; i += kWarps) {
    const float l = t.l[i];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out_c + (row0 + i) * D;
    for (int d = lane; d < D; d += 32) o[d] = from_float<T>(t.acc[i * DP + d] * inv);
    if (lane == 0) lse_c[row0 + i] = l > 0.f ? t.m[i] + logf(l) : kNegInf;
  }
}

// A warp per (token, head), lanes over D.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mix_kernel(const T* __restrict__ out_c, const float* __restrict__ lse_c,
                 T* __restrict__ mixed, float* __restrict__ m_out, float* __restrict__ z_out,
                 int B, int L, int H, int D, FusedBranches fb) {
  const size_t gw = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= static_cast<size_t>(B) * L * H) return;
  const int h = static_cast<int>(gw % H);
  const int p = static_cast<int>((gw / H) % L);
  const int b = static_cast<int>(gw / (static_cast<size_t>(H) * L));
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t rows0 = bh * fb.off[fb.n];

  float lse[kMaxBranches];
  int row[kMaxBranches];
  float m = kNegInf;
#pragma unroll
  for (int bi = 0; bi < kMaxBranches; ++bi) {
    lse[bi] = kNegInf;
    row[bi] = -1;
    if (bi < fb.n) {
      row[bi] = covering_row(fb, bi, p, h, H);
      if (row[bi] >= 0) lse[bi] = lse_c[rows0 + row[bi]];
      m = fmaxf(m, lse[bi]);
    }
  }
  float z = 0.f;
  float acc[kMaxDimsPerLane];
#pragma unroll
  for (int e = 0; e < kMaxDimsPerLane; ++e) acc[e] = 0.f;
#pragma unroll
  for (int bi = 0; bi < kMaxBranches; ++bi) {
    if (bi < fb.n && lse[bi] > kMaskThreshold) {
      const float wb = expf(lse[bi] - m);
      z += wb;
      const T* o = out_c + (rows0 + row[bi]) * D;
#pragma unroll
      for (int e = 0; e < kMaxDimsPerLane; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[e] = fmaf(wb, to_float<T>(o[d]), acc[e]);
      }
    }
  }
  const float inv = z > 0.f ? 1.f / z : 0.f;
  T* dst = mixed + gw * D;  // (b, p, h) row of a (B, L, H, D) tensor
#pragma unroll
  for (int e = 0; e < kMaxDimsPerLane; ++e) {
    const int d = lane + 32 * e;
    if (d < D) dst[d] = from_float<T>(acc[e] * inv);
  }
  if (lane == 0) {
    m_out[bh * L + p] = m;
    z_out[bh * L + p] = z;
  }
}

template <int DP, typename T>
cudaError_t launch_fused_fwd(const void* q, const void* k, const void* v,
                             const unsigned char* mask, void* mixed, void* out_c, float* lse_c,
                             float* m_out, float* z_out, int B, int L, int H, int D, float scale,
                             const FusedBranches& fb, cudaStream_t stream) {
  auto kernel = fused_branch_fwd_kernel<DP, T>;
  cudaError_t err = allow_smem(kernel, Plan<DP>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(fb.tile0[fb.n], H, B);
  kernel<<<grid, kThreads, Plan<DP>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out_c), lse_c, L, H, D, scale, fb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t warps = static_cast<size_t>(B) * L * H;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  fused_mix_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(out_c), lse_c, static_cast<T*>(mixed), m_out, z_out, B, L, H, D, fb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fused_fwd(int DP, const void* q, const void* k, const void* v,
                               const unsigned char* mask, void* mixed, void* out_c, float* lse_c,
                               float* m_out, float* z_out, int B, int L, int H, int D,
                               float scale, const FusedBranches& fb, cudaStream_t s) {
  switch (DP) {
#define MT_CASE(N)                                                                          \
  case N:                                                                                   \
    return launch_fused_fwd<N, T>(q, k, v, mask, mixed, out_c, lse_c, m_out, z_out, B, L, H, \
                                  D, scale, fb, s);
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

// q/k/v/mixed (B, L, H, D) contiguous in one dtype (0 = float32,
// 1 = bfloat16); mask (B, L) bytes (1 = valid) or null; out_c (B, H, M, D)
// in that dtype and lse_c (B, H, M) fp32, M the branches' compact rows
// (ops/dilated_fused.py::total_rows); m_out, z_out (B, H, L) fp32.
// segments/ratios: n_branches host ints.
// Returns a cudaError_t; 0 means both kernels were launched.
extern "C" int mt_dilated_fused_fwd(const void* q, const void* k, const void* v, const void* mask,
                                    void* mixed, void* out_c, void* lse_c, void* m_out,
                                    void* z_out, int B, int L, int H, int D, const int* segments,
                                    const int* ratios, int n_branches, float scale, int dtype,
                                    void* stream) {
  const int DP = mt::padded_head_dim(D);
  mt::FusedBranches fb{};
  if (DP < 0 || B < 1 || B > 65535 || H < 1 || H > 65535 ||
      !mt::make_fused_branches(fb, L, segments, ratios, n_branches))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<const unsigned char*>(mask);
  const auto lc = static_cast<float*>(lse_c);
  const auto mo = static_cast<float*>(m_out);
  const auto zo = static_cast<float*>(z_out);
  if (dtype == 0)
    return mt::dispatch_fused_fwd<float>(DP, q, k, v, m, mixed, out_c, lc, mo, zo, B, L, H, D,
                                         scale, fb, s);
  if (dtype == 1)
    return mt::dispatch_fused_fwd<__nv_bfloat16>(DP, q, k, v, m, mixed, out_c, lc, mo, zo, B, L,
                                                 H, D, scale, fb, s);
  return cudaErrorInvalidValue;
}
