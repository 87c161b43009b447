// LongNet multi-branch dilated attention forward, all branches in one launch.
//
// Replaces: modaltune_tpu/ops/dilated_mega.py::_mega_fwd_call (the Pallas TPU
// "mega" kernel: every (segment, ratio) branch plus the softmax(lse) branch
// mix in one kernel).
//
// Semantics (the plain oracle is ops/dilated.py). For q/k/v (B, L, H, D) and
// each branch (w, r): sl = min(w, L); segment n covers positions
// [n*sl, min((n+1)*sl, L)); head h belongs to group g = h / (Hp / r) with
// Hp = round_up(H, r); the query at segment offset o takes part iff
// o % r == g, and attends the valid keys of its segment whose offset is
// congruent to g mod r. Positions past L, and keys with mask == 0, are
// excluded (never attended as zeros). The branches are mixed per (token,
// head) with weights softmax_b(lse_b).
//
// Mix: this kernel uses the identity
//   sum_b softmax_b(lse_b) out_b = sum_b sum_{j in b} e^{s_j} v_j / sum_b sum_{j in b} e^{s_j},
// i.e. the forward mix equals ONE softmax over the concatenation of every
// branch's key set (a key present in two branches counts twice). So a query
// row keeps one running (m, l, acc) and streams branch after branch through
// the same online-softmax update; no per-branch output or lse is written.
// A branch in which the row does not take part contributes nothing, exactly
// as its NEG_INF lse gives it weight 0 in the oracle's mix.
//
// What bounds it on the H100: GigaPath's schedule at L = 10,240 is about
// 6 GFLOP per (batch, head) per layer, 300 GFLOP per layer at B*T = 3. This
// version runs the inner products on CUDA cores in fp32, so it is bound by
// fp32 issue and shared-memory bandwidth, not by device memory (q/k/v of a
// layer are 47 MB in bf16).
//
// What the design does about it: a block owns 64 consecutive query positions
// of one (batch, head). For each branch and each segment the tile touches
// (tiles straddle segment boundaries, e.g. w = 5792), the block gathers the
// segment's residue-class keys in 64-key tiles into shared memory once and
// updates only the rows that take part, found by per-row segment and phase
// arithmetic; K/V tiles are therefore shared by every participating row of
// the block. Tensor-core matmuls, TMA and a per-branch query permutation
// that keeps all 64 rows busy for r > 1 are left for later work.
#include "attention_common.cuh"

namespace mt {

constexpr int kMaxBranches = 8;

struct Branches {
  int n;
  int seg[kMaxBranches];
  int ratio[kMaxBranches];
};

__device__ __forceinline__ int ceil_div_nonneg(int a, int b) { return a <= 0 ? 0 : (a + b - 1) / b; }

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
dilated_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const unsigned char* __restrict__ mask, T* __restrict__ out, int L, int H,
                   int D, float scale, Branches br) {
  extern __shared__ float4 smem4[];
  Tiles<DP> t(reinterpret_cast<float*>(smem4));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = min(kBlockQ, L - p0);
  const size_t tok = static_cast<size_t>(H) * D;  // stride between positions
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;

  load_rows<DP, kBlockQ, Plan<DP>::QS>(t.q, q + head0, nq, D, scale,
                                       [p0, tok](int r) { return (p0 + r) * tok; });
  t.init_state();

  for (int bi = 0; bi < br.n; ++bi) {
    const int sl = min(br.seg[bi], L);
    const int r = br.ratio[bi];
    const int hg = (H + r - 1) / r;  // heads per group: round_up(H, r) / r
    const int g = h / hg;
    for (int n = p0 / sl; n <= (p0 + nq - 1) / sl; ++n) {
      const int s0 = n * sl, s1 = min(s0 + sl, L);
      // participating rows: positions s0 + g + r*u in [max(p0, s0), min(p0 + nq, s1))
      const int u_lo = ceil_div_nonneg(max(p0, s0) - s0 - g, r);
      const int u_hi = ceil_div_nonneg(min(p0 + nq, s1) - s0 - g, r);
      const int n_rows = u_hi - u_lo;
      if (n_rows <= 0) continue;
      const int row0 = s0 + g + r * u_lo - p0;
      const int n_keys = ceil_div_nonneg(s1 - s0 - g, r);
      for (int t0 = 0; t0 < n_keys; t0 += kBlockK) {
        const int nk = min(kBlockK, n_keys - t0);
        const int first = s0 + g + r * t0;  // position of key j is first + r*j
        __syncthreads();  // the previous tile is consumed
        const auto row = [first, r, tok](int j) {
          return static_cast<size_t>(first + r * j) * tok;
        };
        load_rows<DP, kBlockK, Plan<DP>::KS>(t.k, k + head0, nk, D, 1.f, row);
        load_rows<DP, kBlockK, DP>(t.v, v + head0, nk, D, 1.f, row);
        for (int j = threadIdx.x; j < kBlockK; j += kThreads)
          t.bias[j] = (j < nk && (maskb == nullptr || maskb[first + r * j])) ? 0.f : kNegInf;
        __syncthreads();
        for (int i = warp * kRowsPerWarp; i < n_rows; i += kWarps * kRowsPerWarp)
          fold_rows<DP>(t, row0 + r * i, r, min(kRowsPerWarp, n_rows - i), nk, warp, lane);
      }
    }
  }
  __syncthreads();

  for (int i = warp; i < nq; i += kWarps) {
    const float l = t.l[i];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out + head0 + (p0 + i) * tok;
    for (int d = lane; d < D; d += 32) o[d] = from_float<T>(t.acc[i * DP + d] * inv);
  }
}

template <int DP, typename T>
cudaError_t launch_dilated(const void* q, const void* k, const void* v, const unsigned char* mask,
                           void* out, int B, int L, int H, int D, float scale, const Branches& br,
                           cudaStream_t stream) {
  auto kernel = dilated_fwd_kernel<DP, T>;
  cudaError_t err = allow_smem(kernel, Plan<DP>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, Plan<DP>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), L, H, D, scale, br);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dilated(int DP, const void* q, const void* k, const void* v,
                             const unsigned char* m, void* out, int B, int L, int H, int D,
                             float scale, const Branches& br, cudaStream_t s) {
  switch (DP) {
    case 16: return launch_dilated<16, T>(q, k, v, m, out, B, L, H, D, scale, br, s);
    case 32: return launch_dilated<32, T>(q, k, v, m, out, B, L, H, D, scale, br, s);
    case 48: return launch_dilated<48, T>(q, k, v, m, out, B, L, H, D, scale, br, s);
    case 64: return launch_dilated<64, T>(q, k, v, m, out, B, L, H, D, scale, br, s);
    case 128: return launch_dilated<128, T>(q, k, v, m, out, B, L, H, D, scale, br, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mt

// q/k/v/out (B, L, H, D) contiguous; mask (B, L) bytes (1 = valid) or null.
// segments/ratios: n_branches host ints. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t; 0 means the kernel was launched.
extern "C" int mt_dilated_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int L, int H, int D,
                                        const int* segments, const int* ratios, int n_branches,
                                        float scale, int dtype, void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || B < 1 || B > 65535 || L < 1 || H < 1 || H > 65535 || n_branches < 1 ||
      n_branches > mt::kMaxBranches)
    return cudaErrorInvalidValue;
  mt::Branches br{};
  br.n = n_branches;
  for (int i = 0; i < n_branches; ++i) {
    if (segments[i] < 1 || ratios[i] < 1) return cudaErrorInvalidValue;
    br.seg[i] = segments[i];
    br.ratio[i] = ratios[i];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<const unsigned char*>(mask);
  if (dtype == 0) return mt::dispatch_dilated<float>(DP, q, k, v, m, out, B, L, H, D, scale, br, s);
  if (dtype == 1)
    return mt::dispatch_dilated<__nv_bfloat16>(DP, q, k, v, m, out, B, L, H, D, scale, br, s);
  return cudaErrorInvalidValue;
}
