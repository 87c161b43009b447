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
// Two families of the branch kernel (mt::dilated_family), neither with
// atomics; the mix kernel serves both, and K1f's tensor-core family too:
// * bf16 at D = 48 (GigaPath's head size): the tensor-core forward core of
//   dilated_fwd_wgmma.cu, which K1f shares; bound by operations.
// * fp32 at any D and bf16 at any other D: fused_branch_fwd_kernel below,
//   products on CUDA cores in fp32, bound by the fp32 arithmetic rate and
//   shared-memory bandwidth. q/k/v are read in place in (B, L, H, D) with
//   strided rows, so no gathered copy of them is ever written; a block's 64
//   query rows all belong to one (segment, head group), so every row of the
//   tile takes part in every key tile it loads, whatever the ratio. The
//   online softmax, its tiles and the fold are K2f's (attention_common.cuh).
// The mix kernel moves about three times q's bytes and is bound by device
// memory.
//
#include "dilated_wgmma.cuh"

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

// Eight consecutive elements of a row, as fp32: one 16-byte access in bf16,
// two in fp32 (rows of D % 8 == 0 elements from 16-byte aligned bases).
template <typename T>
__device__ __forceinline__ void load8(float (&x)[8], const T* src) {
  if constexpr (sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 f = reinterpret_cast<const float4*>(src)[i];
      x[4 * i] = f.x;
      x[4 * i + 1] = f.y;
      x[4 * i + 2] = f.z;
      x[4 * i + 3] = f.w;
    }
  }
}
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&x)[8]) {
  if constexpr (sizeof(T) == 2) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// A thread per eight elements of a (token, head): D / 8 threads share a
// slot, each finding the covering rows itself. With PLANES (K1's stats)
// also every branch's lse at the slot (MixOut).
template <typename T, bool PLANES>
__global__ void __launch_bounds__(kThreads)
fused_mix_kernel(const T* __restrict__ out_c, const float* __restrict__ lse_c, MixOut mo, int B,
                 int L, int H, int D, FusedBranches fb) {
  const int chunks = D / 8;
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<size_t>(B) * L * H * chunks) return;
  const size_t gw = t / chunks;             // the (b, p, h) slot
  const int c = static_cast<int>(t - gw * chunks);
  const int h = static_cast<int>(gw % H);
  const int p = static_cast<int>((gw / H) % L);
  const int b = static_cast<int>(gw / (static_cast<size_t>(H) * L));
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t rows0 = bh * fb.off[fb.n];

  // a slot outside the query range is covered by no branch: zeros, NEG_INF
  const bool in_range = in_query_range(fb, p);
  float lse[kMaxBranches];
  int row[kMaxBranches];
  float m = kNegInf;
#pragma unroll
  for (int bi = 0; bi < kMaxBranches; ++bi) {
    lse[bi] = kNegInf;
    row[bi] = -1;
    if (bi < fb.n && in_range) {
      row[bi] = covering_row(fb, bi, p, h, H);
      if (row[bi] >= 0) lse[bi] = lse_c[rows0 + row[bi]];
      m = fmaxf(m, lse[bi]);
    }
  }
  float z = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int bi = 0; bi < kMaxBranches; ++bi) {
    if (bi >= fb.n) continue;
    const bool take = lse[bi] > kMaskThreshold;
    const float wb = take ? expf(lse[bi] - m) : 0.f;
    z += wb;
    if constexpr (PLANES) {
      if (c == 0) mo.planes[bh * mo.stride + static_cast<size_t>(bi) * L + p] = lse[bi];
    }
    if (!take) continue;
    float x[8];
    load8(x, out_c + (rows0 + row[bi]) * D + 8 * c);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(wb, x[e], acc[e]);
  }
  const float inv = z > 0.f ? 1.f / z : 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] *= inv;
  // (b, p, h) row of a (B, L, H, D) tensor
  store8(static_cast<T*>(mo.mixed) + gw * D + 8 * c, acc);
  if (c == 0 && mo.m != nullptr) {
    mo.m[bh * mo.stride + p] = m;
    mo.z[bh * mo.stride + p] = z;
  }
}

template <typename T>
cudaError_t launch_mix(const void* out_c, const float* lse_c, const MixOut& o, int B, int L,
                       int H, int D, const FusedBranches& fb, cudaStream_t stream) {
  const size_t threads = static_cast<size_t>(B) * L * H * (D / 8);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (o.planes != nullptr)
    fused_mix_kernel<T, true><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(out_c),
                                                               lse_c, o, B, L, H, D, fb);
  else
    fused_mix_kernel<T, false><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(out_c),
                                                                lse_c, o, B, L, H, D, fb);
  return cudaGetLastError();
}

cudaError_t launch_compact_mix(const void* out_c, const float* lse_c, const MixOut& o, int B,
                               int L, int H, int D, const FusedBranches& fb, int dtype,
                               cudaStream_t stream) {
  if (dtype == 0) return launch_mix<float>(out_c, lse_c, o, B, L, H, D, fb, stream);
  return launch_mix<__nv_bfloat16>(out_c, lse_c, o, B, L, H, D, fb, stream);
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
  const MixOut o{mixed, m_out, z_out, static_cast<size_t>(L), nullptr};
  return launch_mix<T>(out_c, lse_c, o, B, L, H, D, fb, stream);
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
  if (mt::dilated_family(D, dtype) == 1) {
    const mt::DilatedFwdCore c{q, k, v, m, out_c, lc, B, L, H, scale};
    cudaError_t err = mt::launch_dilated_fwd_core(c, fb, s);
    if (err != cudaSuccess) return err;
    const mt::MixOut o{mixed, mo, zo, static_cast<size_t>(L), nullptr};
    return mt::launch_compact_mix(out_c, lc, o, B, L, H, D, fb, dtype, s);
  }
  if (dtype == 0)
    return mt::dispatch_fused_fwd<float>(DP, q, k, v, m, mixed, out_c, lc, mo, zo, B, L, H, D,
                                         scale, fb, s);
  if (dtype == 1)
    return mt::dispatch_fused_fwd<__nv_bfloat16>(DP, q, k, v, m, mixed, out_c, lc, mo, zo, B, L,
                                                 H, D, scale, fb, s);
  return cudaErrorInvalidValue;
}
