// LongNet multi-branch dilated attention forward, all branches in one launch.
//
// Replaces: modaltune_tpu/ops/dilated_mega.py::_mega_fwd_call (the Pallas TPU
// "mega" kernel: every (segment, ratio) branch plus the softmax(lse) branch
// mix in one kernel, and the stats plane its backward reads).
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
// With stats (training) K1f also writes what the backward needs: stats
// (B*H, n_br + 2, L) = [lse_0 .. lse_{n-1}, m, Z], with m = max_b lse_b and
// Z = sum_b e^{lse_b - m} (lse_b NEG_INF where branch b does not cover the
// slot or the row has no valid key). No branch's own output is kept: the
// backward takes what it needs of it from q, k, v and the stats, as the
// Pallas kernel's backward does.
//
// With a query range [q0, q1) (the Pallas kernel's qrange, the
// sequence-parallel shard's rows; ops/dilated_sp.py) only those query rows
// are computed, against every key; the rows outside come back as rows
// without a valid key (out 0; lse_b, m NEG_INF; Z 0). The grids skip the
// work outside: the tensor-core core runs only the compact tiles of each
// branch that may hold a row of the range (dilated_fused_common.cuh,
// query_tiles) and the mix writes the zeros; the CUDA-core kernel's blocks
// start at q0 and range_fill_kernel writes the rows outside.
//
// Two families (mt::dilated_family), neither with atomics:
// * bf16 at D = 48 (GigaPath's head size, every call of the model), two
//   launches with or without stats: the tensor-core forward core
//   (dilated_fwd_wgmma.cu, which K3f shares) writes every branch's compact
//   out_b and lse_b into scratch (ops/dilated_fused.py's layout, 98 MB at
//   (3, 10240, 16, 48)); K3f's mix kernel (dilated_fused_fwd.cu) writes out
//   and, with stats, the planes above. The branches are attended apart, so
//   the inference variant computes the mix from each branch's (out_b,
//   lse_b) as the training variant does; the union-softmax identity below
//   serves the CUDA-core kernel alone. What bounds it is operations
//   (dilated_fwd_wgmma.cu: 0.268 ms at that shape); compact tiles keep every
//   row of a 64-row wgmma tile in one (segment, head group), where this
//   file's blocks of 64 consecutive positions hold 64 / r rows of a branch
//   of ratio r (2.56 times the products at GigaPath's shape).
// * fp32 at any D and bf16 at any other D: dilated_fwd_kernel, one launch on
//   CUDA cores in fp32, bound by fp32 issue and shared-memory bandwidth. A
//   block owns 64 consecutive query positions of one (batch, head). For each
//   branch and each segment the tile touches (tiles straddle segment
//   boundaries, e.g. w = 5792), the block gathers the segment's
//   residue-class keys in 64-key tiles into shared memory once and updates
//   only the rows that take part, found by per-row segment and phase
//   arithmetic. Without stats it uses the identity
//     sum_b softmax_b(lse_b) out_b = sum_b sum_{j in b} e^{s_j} v_j / sum_b sum_{j in b} e^{s_j},
//   i.e. the mix equals ONE softmax over the concatenation of every branch's
//   key set (a key present in two branches counts twice): a query row keeps
//   one running (m, l, acc) through every branch, and a branch in which the
//   row does not take part contributes nothing, exactly as its NEG_INF lse
//   gives it weight 0 in the oracle's mix. With stats the online softmax
//   runs on branch-local (m_b, l_b, acc_b); when a branch ends, the block
//   writes lse_b and folds o_b = acc_b / l_b into a running mix with the
//   JAX kernel's algebra.
#include "dilated_wgmma.cuh"

namespace mt {

// Extra shared memory of the training variant, after Plan<DP>: the
// branch-local accumulator, its (m_b, l_b), and two per-row coefficients
// of the branch-end mix.
template <int DP>
struct StatsPlan {
  static constexpr int acc_off = Plan<DP>::floats;
  static constexpr int m_off = acc_off + kBlockQ * DP;
  static constexpr int l_off = m_off + kBlockQ;
  static constexpr int coef_off = l_off + kBlockQ;
  static constexpr int floats = coef_off + 2 * kBlockQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int DP, typename T, bool STATS>
__global__ void __launch_bounds__(kThreads)
dilated_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const unsigned char* __restrict__ mask, T* __restrict__ out,
                   float* __restrict__ stats, int L, int H, int D, float scale, Branches br,
                   int q0, int q1) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // t: the union state (inference) or the running branch mix (training:
  // m = max lse_b so far, l = Z, acc = sum_b e^{lse_b - m} o_b).
  Tiles<DP> t(smem);
  // tb: the state the online softmax updates; branch-local in training.
  Tiles<DP> tb = t;
  float* coef = nullptr;
  if constexpr (STATS) {
    tb.acc = smem + StatsPlan<DP>::acc_off;
    tb.m = smem + StatsPlan<DP>::m_off;
    tb.l = smem + StatsPlan<DP>::l_off;
    coef = smem + StatsPlan<DP>::coef_off;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = q0 + blockIdx.x * kBlockQ;   // the blocks cover [q0, q1)
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int nq = min(kBlockQ, q1 - p0);
  const size_t tok = static_cast<size_t>(H) * D;  // stride between positions
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;

  load_rows<DP, kBlockQ, Plan<DP>::QS>(t.q, q + head0, nq, D, scale,
                                       [p0, tok](int r) { return (p0 + r) * tok; });
  t.init_state();
  if constexpr (STATS) tb.init_state();

  for (int bi = 0; bi < br.n; ++bi) {
    const int sl = min(br.seg[bi], L);
    const int r = br.ratio[bi];
    for_each_segment(p0, nq, L, sl, r, head_group(h, H, r),
                     [&](int row0, int n_rows, int first, int n_keys) {
      for (int t0 = 0; t0 < n_keys; t0 += kBlockK) {
        const int nk = min(kBlockK, n_keys - t0);
        const int pos0 = first + r * t0;  // position of key j is pos0 + r*j
        __syncthreads();  // the previous tile is consumed
        const auto row = [pos0, r, tok](int j) {
          return static_cast<size_t>(pos0 + r * j) * tok;
        };
        load_rows<DP, kBlockK, Plan<DP>::KS>(t.k, k + head0, nk, D, 1.f, row);
        load_rows<DP, kBlockK, DP>(t.v, v + head0, nk, D, 1.f, row);
        for (int j = threadIdx.x; j < kBlockK; j += kThreads)
          t.bias[j] = (j < nk && (maskb == nullptr || maskb[pos0 + r * j])) ? 0.f : kNegInf;
        __syncthreads();
        for (int i = warp * kRowsPerWarp; i < n_rows; i += kWarps * kRowsPerWarp)
          fold_rows<DP>(tb, row0 + r * i, r, min(kRowsPerWarp, n_rows - i), nk, warp, lane);
      }
    });
    if constexpr (STATS) {
      __syncthreads();  // every fold of the branch is done
      float* st = stats + (static_cast<size_t>(bh) * (br.n + 2) + bi) * L + p0;
      for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
        const float lb = tb.l[i];
        const float lse = lb > 0.f ? tb.m[i] + logf(lb) : kNegInf;
        const float m_new = fmaxf(t.m[i], lse);
        const float m_safe = fmaxf(m_new, kMaskThreshold);
        const float corr = expf(t.m[i] - m_safe);
        coef[i] = corr;
        // e^{lse - m_safe} o_b = e^{m_b - m_safe} acc_b
        coef[kBlockQ + i] = lb > 0.f ? expf(tb.m[i] - m_safe) : 0.f;
        t.l[i] = t.l[i] * corr + expf(lse - m_safe);
        t.m[i] = m_new;
        tb.m[i] = kNegInf;
        tb.l[i] = 0.f;
        if (i < nq) st[i] = lse;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kBlockQ * DP; e += kThreads) {
        const int i = e / DP;
        t.acc[e] = t.acc[e] * coef[i] + coef[kBlockQ + i] * tb.acc[e];
        tb.acc[e] = 0.f;
      }
    }
  }
  __syncthreads();

  for (int i = warp; i < nq; i += kWarps) {
    const float l = t.l[i];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out + head0 + (p0 + i) * tok;
    for (int d = lane; d < D; d += 32) o[d] = from_float<T>(t.acc[i * DP + d] * inv);
    if constexpr (STATS) {
      if (lane == 0) {
        float* st = stats + static_cast<size_t>(bh) * (br.n + 2) * L + p0 + i;
        st[static_cast<size_t>(br.n) * L] = t.m[i];
        st[static_cast<size_t>(br.n + 1) * L] = l;
      }
    }
  }
}

template <int DP, typename T, bool STATS>
cudaError_t launch_dilated(const void* q, const void* k, const void* v, const unsigned char* mask,
                           void* out, float* stats, int B, int L, int H, int D,
                           float scale, const Branches& br, int q0, int q1, cudaStream_t stream) {
  auto kernel = dilated_fwd_kernel<DP, T, STATS>;
  const size_t bytes = STATS ? StatsPlan<DP>::bytes : Plan<DP>::bytes;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((q1 - q0 + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), stats, L, H, D, scale, br, q0, q1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_range_fill<T>(out, stats, B, L, H, D, br.n, q0, q1, stream);
}

template <typename T, bool STATS>
cudaError_t dispatch_dilated(int DP, const void* q, const void* k, const void* v,
                             const unsigned char* m, void* out, float* st, int B, int L,
                             int H, int D, float scale, const Branches& br, int q0, int q1,
                             cudaStream_t s) {
  switch (DP) {
#define MT_CASE(N)                                                                        \
  case N:                                                                                 \
    return launch_dilated<N, T, STATS>(q, k, v, m, out, st, B, L, H, D, scale, br, q0,     \
                                       q1, s);
    MT_CASE(16)
    MT_CASE(32)
    MT_CASE(48)
    MT_CASE(64)
    MT_CASE(128)
#undef MT_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core family: the forward core into compact scratch, then the
// mix, which writes out and, with stats, K1's planes.
inline cudaError_t launch_dilated_fwd_wgmma(const void* q, const void* k, const void* v,
                                            const unsigned char* mask, void* out, float* stats,
                                            void* out_c, float* lse_c, int B, int L, int H,
                                            float scale, const FusedBranches& fb,
                                            cudaStream_t stream) {
  const DilatedFwdCore c{q, k, v, mask, out_c, lse_c, B, L, H, scale};
  const cudaError_t err = launch_dilated_fwd_core(c, fb, stream);
  if (err != cudaSuccess) return err;
  const int n = fb.n;
  const size_t plane = static_cast<size_t>(L);
  const MixOut o{out,
                 stats == nullptr ? nullptr : stats + n * plane,
                 stats == nullptr ? nullptr : stats + (n + 1) * plane,
                 (n + 2) * plane,
                 stats};
  return launch_compact_mix(out_c, lse_c, o, B, L, H, kWgmmaD, fb, 1, stream);
}

template <typename T>
cudaError_t dispatch_dilated(int DP, const void* q, const void* k, const void* v,
                             const unsigned char* m, void* out, float* st, int B, int L,
                             int H, int D, float scale, const Branches& br, int q0, int q1,
                             cudaStream_t s) {
  if (st == nullptr)
    return dispatch_dilated<T, false>(DP, q, k, v, m, out, st, B, L, H, D, scale, br, q0, q1,
                                      s);
  return dispatch_dilated<T, true>(DP, q, k, v, m, out, st, B, L, H, D, scale, br, q0, q1, s);
}

}  // namespace mt

// q/k/v/out (B, L, H, D) contiguous; mask (B, L) bytes (1 = valid) or null.
// stats (B*H, n_branches + 2, L) fp32, or null (inference).
// segments/ratios: n_branches host ints. dtype: 0 = float32, 1 = bfloat16.
// The tensor-core family (mt::dilated_family: bf16, D = 48; q/k/v 16-byte
// aligned) takes compact scratch out_c (B, H, M, 48) bf16 and lse_c (B, H, M)
// fp32, M the compact rows of a head (ops/dilated_fused.py::total_rows);
// the CUDA-core kernels take them null.
// [q0, q1): the query range (K1's q_token_range; 0, L: every row). Only the
// query tiles that meet it are computed; every slot outside it gets out 0,
// with stats lse_b and m NEG_INF and Z 0 (a row without a valid key). An
// empty range or one outside [0, L) is refused.
// Returns a cudaError_t; 0 means every kernel was launched.
extern "C" int mt_dilated_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, void* stats, void* out_c,
                                        void* lse_c, int B, int L, int H, int D,
                                        const int* segments, const int* ratios, int n_branches,
                                        float scale, int dtype, int q0, int q1, void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || B < 1 || B > 65535 || L < 1 || H < 1 || H > 65535 || n_branches < 1 ||
      n_branches > mt::kMaxBranches || q0 < 0 || q1 > L || q0 >= q1)
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
  const auto st = static_cast<float*>(stats);
  if (mt::dilated_family(D, dtype) == 1) {
    mt::FusedBranches fb{};
    if (out_c == nullptr || lse_c == nullptr ||
        !mt::make_fused_branches(fb, L, segments, ratios, n_branches) ||
        !mt::set_query_range(fb, L, q0, q1))
      return cudaErrorInvalidValue;
    return mt::launch_dilated_fwd_wgmma(q, k, v, m, out, st, out_c,
                                        static_cast<float*>(lse_c), B, L, H, scale, fb, s);
  }
  if (dtype == 0)
    return mt::dispatch_dilated<float>(DP, q, k, v, m, out, st, B, L, H, D, scale, br, q0, q1,
                                       s);
  if (dtype == 1)
    return mt::dispatch_dilated<__nv_bfloat16>(DP, q, k, v, m, out, st, B, L, H, D, scale, br,
                                               q0, q1, s);
  return cudaErrorInvalidValue;
}
