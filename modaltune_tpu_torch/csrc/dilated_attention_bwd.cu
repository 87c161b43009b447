// LongNet multi-branch dilated attention backward (K1b).
//
// Replaces: modaltune_tpu/ops/dilated_mega.py::_mega_bwd_call (the Pallas TPU
// kernel that recomputes every branch's probabilities from the saved
// per-branch lse and demixes the output gradient with stop-gradient weights).
//
// Semantics (the plain oracle is autograd through ops/dilated.py). The
// forward (dilated_attention_fwd.cu, training variant) saved stats
// (B*H, n_br + 2, L) = [lse_0 .. lse_{n-1}, m, Z], and nothing else: the
// Pallas kernel's residuals are q, k, v, the mask and this plane. With dmix
// the gradient of the mixed output and the mix weights taken as constants,
// for each branch b:
//   w_b     = exp(lse_b - m) / Z on rows with a valid lse_b, else 0
//   dO_b    = dmix * w_b
//   P_b     = exp(s - lse_b)  (0 for a masked key; a row without a valid key
//                              uses +|NEG_INF/2| in lse's place)
//   delta_b = rowsum(P_b * (dO_b v^T))   (= rowsum(dO_b * o_b), o_b never
//                                         kept)
//   dS_b    = P_b * (dO_b v^T - delta_b)
// and dq, dk, dv sum dS_b k * scale, dS_b^T q * scale and P_b^T dO_b over
// the branches, each over the branch's (segment, residue class) pairs.
//
// Three families (mt::dilated_family), none with atomics:
// * at D = 48 (GigaPath's head size), four launches: a prep kernel
//   (dilated_bwd_compact_prep_kernel) reads the stats plane at every
//   compact row of ops/dilated_fused.py's layout (dilated_fused_common.cuh)
//   and writes lse_b and w_b there, (B, H, M) fp32 each; a tensor-core
//   gradient core, which K3b shares, takes delta_b from P and dP in its dq
//   kernel and writes fp32 compact dq, dk, dv, (B, H, M, D) each; K3b's
//   combine sums them into dense gradients in branch order. The core is
//   dilated_bwd_wgmma.cu at bf16 (family 1) and the 3xTF32 core
//   dilated_bwd_tf32.cu at fp32 (family 2). Compact tiles keep every row of
//   a 64-row tile in one (segment, head group); this file's CUDA-core
//   blocks of 64 consecutive positions hold 64 / r rows of a branch of
//   ratio r, 2.56 times the products at GigaPath's shape.
// * fp32 and bf16 at any other D, three launches on CUDA cores: a
//   prep kernel writes w_b and delta_b (B*H, n_br, L) fp32 (a warp per
//   (token, head), delta_b rebuilt over the row's keys by window_pdp, a
//   lane a key); the dq kernel's block owns 64 query positions of one
//   (batch, head) and streams, for every branch and segment, the
//   residue-class keys, exactly as the forward does; the dk/dv kernel's
//   block owns 64 key positions and streams their queries, found with the
//   same segment and phase arithmetic (for_each_segment): the relation
//   "shares a segment and a residue class mod r" is symmetric.
//
// With the forward's query range [q0, q1) dq is 0 outside it and dk/dv sum
// over the range's queries alone (this shard's partial dk/dv). The stats
// give the rows outside lse NEG_INF, so w = delta = 0 and they add
// nothing; the dq grids cover only the range's tiles (the combine, or
// range_fill_kernel, writes dq = 0 elsewhere) and the dk/dv kernels stream
// only the query tiles of a (segment, head group) that hold a row of the
// range.
//
// What bounds it on the H100: five products per query-key pair (q.k and
// dmix.v in both kernels, dS k in one, P dmix and dS q in the other) against
// the forward's two: operations (dilated_bwd_wgmma.cu, which also counts
// what delta adds; at fp32 each product is three TF32 products,
// dilated_bwd_tf32.cu). The CUDA-core kernels run them in fp32 and are bound by
// the fp32 instruction rate and shared-memory bandwidth
// (attention_bwd_common.cuh); their delta prep repeats the dq kernel's q.k
// and dmix.v.
#include "attention_bwd_common.cuh"
#include "dilated_wgmma.cuh"

namespace mt {

template <typename T>
__global__ void __launch_bounds__(kThreads)
dilated_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ mask,
                        const T* __restrict__ dmix, const float* __restrict__ stats,
                        float* __restrict__ w, float* __restrict__ delta, int B, int L, int H,
                        int D, float scale, Branches br) {
  __shared__ float qd[kWarps][2 * 32 * kMaxDimsPerLane];
  const size_t gw = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32, nbr = br.n;
  if (gw >= static_cast<size_t>(B) * L * H) return;
  const int h = static_cast<int>(gw % H);
  const int l = static_cast<int>((gw / H) % L);
  const int b = static_cast<int>(gw / (static_cast<size_t>(H) * L));
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* st = stats + bh * (nbr + 2) * L + l;
  const float m = st[static_cast<size_t>(nbr) * L];
  const float z = st[static_cast<size_t>(nbr + 1) * L];
  const float zs = z > 0.f ? z : 1.f;
  const size_t tok = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;
  for (int bi = 0; bi < nbr; ++bi) {
    const float lse = st[static_cast<size_t>(bi) * L];
    float wb = 0.f, db = 0.f;
    if (lse > kMaskThreshold) {   // the row takes part in the branch
      const int sl = min(br.seg[bi], L), r = br.ratio[bi];
      const int s0 = l / sl * sl, g = head_group(h, H, r);
      wb = expf(lse - m) / zs;
      db = wb * window_pdp(q + head0 + l * tok, dmix + head0 + l * tok, k + head0, v + head0,
                           tok, maskb, s0 + g, r, ceil_div_nonneg(min(s0 + sl, L) - s0 - g, r),
                           lse, scale, D, qd[threadIdx.x / 32]);
    }
    if (lane == 0) {
      w[(bh * nbr + bi) * L + l] = wb;
      delta[(bh * nbr + bi) * L + l] = db;
    }
  }
}

// K1's stats plane at every compact row (a thread per row): lse_b (NEG_INF
// where the row is no real position or lies outside the query range) and
// w_b, each (B, H, M) fp32; the tensor-core families' prep.
__global__ void __launch_bounds__(kThreads)
dilated_bwd_compact_prep_kernel(const float* __restrict__ stats, float* __restrict__ lse_c,
                                float* __restrict__ w_c, int B, int L, int H, FusedBranches fb) {
  const size_t gw = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int M = fb.off[fb.n], nbr = fb.n;
  if (gw >= static_cast<size_t>(B) * H * M) return;
  const int row = static_cast<int>(gw % M);
  const size_t bh = gw / M;
  const int h = static_cast<int>(bh % H);
  int bi = 0;
  while (bi + 1 < nbr && row >= fb.off[bi + 1]) ++bi;
  const int m = fb.m[bi], sl = fb.seg[bi], r = fb.ratio[bi];
  const int seg = (row - fb.off[bi]) / m, l = (row - fb.off[bi]) - seg * m;
  const int o = l * r + head_group(h, H, r);
  const int p = seg * sl + o;
  float lse = kNegInf, wb = 0.f;   // P = 0 for this row
  if (o < sl && p < L && in_query_range(fb, p)) {
    const float* st = stats + bh * (nbr + 2) * L + p;
    lse = st[static_cast<size_t>(bi) * L];
    if (lse > kMaskThreshold) {
      const float z = st[static_cast<size_t>(nbr + 1) * L];
      wb = expf(lse - st[static_cast<size_t>(nbr) * L]) / (z > 0.f ? z : 1.f);
    }
  }
  lse_c[gw] = lse;
  w_c[gw] = wb;
}

// A tensor-core family (1: bf16, 2: fp32): the compact prep, the family's
// gradient core, the combine. rows_c (3, B, H, M) (lse, w, delta) and
// grads_c (3, B, H, M, 48) fp32 scratch.
inline cudaError_t launch_dilated_bwd_compact(const void* q, const void* k, const void* v,
                                              const unsigned char* mask, const void* dmix,
                                              const float* stats, float* rows_c,
                                              float* grads_c, void* dq, void* dk, void* dv,
                                              int B, int L, int H, float scale,
                                              const FusedBranches& fb, int family,
                                              cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(B) * H * fb.off[fb.n];
  float *lse_c = rows_c, *w_c = rows_c + rows, *delta_c = rows_c + 2 * rows;
  float *dq_c = grads_c, *dk_c = grads_c + rows * kWgmmaD, *dv_c = dk_c + rows * kWgmmaD;
  dilated_bwd_compact_prep_kernel<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                                    kThreads, 0, stream>>>(stats, lse_c, w_c, B, L, H, fb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const DilatedBwdCore c{q, k, v, dmix, mask, lse_c, w_c, delta_c, dq_c, dk_c, dv_c,
                         B, L, H, scale};
  err = launch_bwd_core(family, c, fb, stream);
  if (err != cudaSuccess) return err;
  return launch_compact_combine(dq_c, dk_c, dv_c, dq, dk, dv, B, L, H, kWgmmaD, fb,
                                family == 2 ? 0 : 1, stream);
}

// The bf16 tensor-core family's K1b in two parts over a token range [r0, r1),
// for a sequence-parallel rank whose query rows and keys are that range
// (ops/dilated_sp.py); fb covers the whole sequence. Part 0: the prep onto
// the range's rows, the dq kernel on their tiles, the combine: dq of the
// range (0 elsewhere), dk and dv 0, and in rows_c's third plane delta of
// every compact row, 0 but in the range's query tiles. Part 1, given every
// row's delta there and the whole stats plane: the prep onto every row, the
// dk/dv kernel on the key tiles of the range over every query tile, the
// combine: dk and dv of the range's keys as the whole call sums them (other
// keys of those tiles too, the rest 0), dq 0.
inline cudaError_t launch_dilated_bwd_part(const void* q, const void* k, const void* v,
                                           const unsigned char* mask, const void* dmix,
                                           const float* stats, float* rows_c, float* grads_c,
                                           void* dq, void* dk, void* dv, int B, int L, int H,
                                           float scale, const FusedBranches& fb, int part,
                                           int r0, int r1, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(B) * H * fb.off[fb.n];
  float *lse_c = rows_c, *w_c = rows_c + rows, *delta_c = rows_c + 2 * rows;
  float *dq_c = grads_c, *dk_c = grads_c + rows * kWgmmaD, *dv_c = dk_c + rows * kWgmmaD;
  FusedBranches fr = fb;
  if (!set_query_range(fr, L, r0, r1)) return cudaErrorInvalidValue;
  const FusedBranches& prep_rows = part == 0 ? fr : fb;
  cudaError_t err = cudaMemsetAsync(grads_c, 0, 3 * rows * kWgmmaD * sizeof(float), stream);
  if (err == cudaSuccess && part == 0)
    err = cudaMemsetAsync(delta_c, 0, rows * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  dilated_bwd_compact_prep_kernel<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                                    kThreads, 0, stream>>>(stats, lse_c, w_c, B, L, H,
                                                           prep_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const DilatedBwdCore c{q, k, v, dmix, mask, lse_c, w_c, delta_c, dq_c, dk_c, dv_c,
                         B, L, H, scale};
  if (part == 0) {
    err = launch_dilated_bwd_dq(c, fr, stream);
  } else {   // the range's key tiles, each over every query tile
    FusedBranches fk = query_tiles(fr, L);
    fk.q0 = 0;
    fk.q1 = L;
    err = launch_dilated_bwd_dkv(c, fk, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_compact_combine(dq_c, dk_c, dv_c, dq, dk, dv, B, L, H, kWgmmaD,
                                part == 0 ? fr : fb, 1, stream);
}

// Per-branch row statistics of query positions pos(i), i < n, into the
// tile's lse/w/delta arrays (rows past n get values that zero P).
template <int DP, bool DUAL, typename Pos>
__device__ __forceinline__ void load_row_stats(const BwdTiles<DP, DUAL>& t, const float* stats,
                                               const float* w, const float* delta, size_t bh,
                                               int nbr, int bi, int L, int n, Pos pos) {
  const float* st = stats + (bh * (nbr + 2) + bi) * L;
  const float* wb = w + (bh * nbr + bi) * L;
  const float* db = delta + (bh * nbr + bi) * L;
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    const bool in = i < n;
    const int p = in ? pos(i) : 0;
    t.lse[i] = in ? lse_for_bwd(st[p]) : -kMaskThreshold;
    t.w[i] = in ? wb[p] : 0.f;
    t.delta[i] = in ? db[p] : 0.f;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
dilated_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const unsigned char* __restrict__ mask, const T* __restrict__ dmix,
                      const float* __restrict__ stats, const float* __restrict__ w,
                      const float* __restrict__ delta, T* __restrict__ dq, int L, int H, int D,
                      float scale, Branches br, int q0, int q1) {
  extern __shared__ float4 smem4[];
  BwdTiles<DP, false> t(reinterpret_cast<float*>(smem4));
  constexpr int S = BwdPlan<DP, false>::S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = q0 + blockIdx.x * kBlockQ;   // the blocks cover [q0, q1)
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nq = min(kBlockQ, q1 - p0);
  const size_t tok = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;
  const auto own = [p0, tok](int i) { return (p0 + i) * tok; };

  load_rows<DP, kBlockQ, S>(t.a1, q + head0, nq, D, scale, own);
  load_rows<DP, kBlockQ, S>(t.a2, dmix + head0, nq, D, 1.f, own);
  t.zero_acc();

  for (int bi = 0; bi < br.n; ++bi) {
    const int sl = min(br.seg[bi], L);
    const int r = br.ratio[bi];
    __syncthreads();  // the previous branch's folds are done with lse/w/delta
    load_row_stats(t, stats, w, delta, bh, br.n, bi, L, nq, [p0](int i) { return p0 + i; });
    for_each_segment(p0, nq, L, sl, r, head_group(h, H, r),
                     [&](int row0, int n_rows, int first, int n_keys) {
      for (int t0 = 0; t0 < n_keys; t0 += kBlockK) {
        const int nk = min(kBlockK, n_keys - t0);
        const int pos0 = first + r * t0;  // position of key j is pos0 + r*j
        __syncthreads();  // the previous tile is consumed
        const auto row = [pos0, r, tok](int j) {
          return static_cast<size_t>(pos0 + r * j) * tok;
        };
        load_rows<DP, kBlockK, S>(t.b1, k + head0, nk, D, 1.f, row);
        load_rows<DP, kBlockK, S>(t.b2, v + head0, nk, D, 1.f, row);
        for (int j = threadIdx.x; j < kBlockK; j += kThreads)
          t.bias[j] = (j < nk && (maskb == nullptr || maskb[pos0 + r * j])) ? 0.f : kNegInf;
        __syncthreads();
        for (int i = warp * kRowsPerWarp; i < n_rows; i += kWarps * kRowsPerWarp)
          bwd_fold<DP, false>(t, row0 + r * i, r, min(kRowsPerWarp, n_rows - i), nk, warp, lane);
      }
    });
  }
  __syncthreads();
  store_rows<DP>(dq + head0, t.acc1, nq, D, scale, own);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
dilated_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const unsigned char* __restrict__ mask, const T* __restrict__ dmix,
                       const float* __restrict__ stats, const float* __restrict__ w,
                       const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                       int L, int H, int D, float scale, Branches br, int q0, int q1) {
  extern __shared__ float4 smem4[];
  BwdTiles<DP, true> t(reinterpret_cast<float*>(smem4));
  constexpr int S = BwdPlan<DP, true>::S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nk = min(kBlockK, L - p0);
  const size_t tok = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * L * tok + static_cast<size_t>(h) * D;
  const unsigned char* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;
  const auto own = [p0, tok](int i) { return (p0 + i) * tok; };

  load_rows<DP, kBlockK, S>(t.a1, k + head0, nk, D, 1.f, own);
  load_rows<DP, kBlockK, S>(t.a2, v + head0, nk, D, 1.f, own);
  // a masked key gets no probability in any branch, so zero gradients
  for (int j = threadIdx.x; j < kBlockK; j += kThreads)
    t.bias[j] = (j < nk && (maskb == nullptr || maskb[p0 + j])) ? 0.f : kNegInf;
  t.zero_acc();

  for (int bi = 0; bi < br.n; ++bi) {
    const int sl = min(br.seg[bi], L);
    const int r = br.ratio[bi];
    for_each_segment(p0, nk, L, sl, r, head_group(h, H, r),
                     [&](int row0, int n_rows, int first, int n_queries) {
      // only the queries at positions of [q0, q1): first + r u, u in [u_lo, u_hi)
      const int u_lo = ceil_div_nonneg(q0 - first, r);
      const int u_hi = min(n_queries, ceil_div_nonneg(q1 - first, r));
      for (int t0 = u_lo; t0 < u_hi; t0 += kBlockQ) {
        const int nq = min(kBlockQ, u_hi - t0);
        const int pos0 = first + r * t0;  // position of query i is pos0 + r*i
        __syncthreads();  // the previous tile is consumed
        const auto row = [pos0, r, tok](int i) {
          return static_cast<size_t>(pos0 + r * i) * tok;
        };
        load_rows<DP, kBlockQ, S>(t.b1, q + head0, nq, D, scale, row);
        load_rows<DP, kBlockQ, S>(t.b2, dmix + head0, nq, D, 1.f, row);
        load_row_stats(t, stats, w, delta, bh, br.n, bi, L, nq,
                       [pos0, r](int i) { return pos0 + r * i; });
        __syncthreads();
        for (int j = warp * kRowsPerWarp; j < n_rows; j += kWarps * kRowsPerWarp)
          bwd_fold<DP, true>(t, row0 + r * j, r, min(kRowsPerWarp, n_rows - j), nq, warp, lane);
      }
    });
  }
  __syncthreads();
  store_rows<DP>(dv + head0, t.acc1, nk, D, 1.f, own);
  store_rows<DP>(dk + head0, t.acc2, nk, D, 1.f, own);
}

template <int DP, typename T>
cudaError_t launch_dilated_bwd(const void* q, const void* k, const void* v,
                               const unsigned char* mask, const void* dmix, const float* stats,
                               float* w, float* delta, void* dq, void* dk, void* dv, int B, int L,
                               int H, int D, float scale, const Branches& br, int q0, int q1,
                               cudaStream_t stream) {
  auto kq = dilated_bwd_dq_kernel<DP, T>;
  auto kkv = dilated_bwd_dkv_kernel<DP, T>;
  cudaError_t err = allow_smem(kq, BwdPlan<DP, false>::bytes);
  if (err == cudaSuccess) err = allow_smem(kkv, BwdPlan<DP, true>::bytes);
  if (err != cudaSuccess) return err;
  const auto tq = static_cast<const T*>(q);
  const auto tk = static_cast<const T*>(k);
  const auto tv = static_cast<const T*>(v);
  const auto tdm = static_cast<const T*>(dmix);
  const size_t warps = static_cast<size_t>(B) * L * H;
  const unsigned prep_blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  dilated_bwd_prep_kernel<T><<<prep_blocks, kThreads, 0, stream>>>(
      tq, tk, tv, mask, tdm, stats, w, delta, B, L, H, D, scale, br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dq on the blocks of the query range, 0 elsewhere; dk/dv on every block
  const dim3 grid_q((q1 - q0 + kBlockQ - 1) / kBlockQ, H, B);
  kq<<<grid_q, kThreads, BwdPlan<DP, false>::bytes, stream>>>(
      tq, tk, tv, mask, tdm, stats, w, delta, static_cast<T*>(dq), L, H, D, scale, br, q0, q1);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_range_fill<T>(dq, nullptr, B, L, H, D, 0, q0, q1, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  kkv<<<grid, kThreads, BwdPlan<DP, true>::bytes, stream>>>(
      tq, tk, tv, mask, tdm, stats, w, delta, static_cast<T*>(dk), static_cast<T*>(dv), L, H, D,
      scale, br, q0, q1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dilated_bwd(int DP, const void* q, const void* k, const void* v,
                                 const unsigned char* m, const void* dmix, const float* stats,
                                 float* w, float* delta, void* dq, void* dk, void* dv, int B,
                                 int L, int H, int D, float scale, const Branches& br, int q0,
                                 int q1, cudaStream_t s) {
  switch (DP) {
#define MT_CASE(N)                                                                           \
  case N:                                                                                    \
    return launch_dilated_bwd<N, T>(q, k, v, m, dmix, stats, w, delta, dq, dk, dv, B, L, H, \
                                    D, scale, br, q0, q1, s);
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

// q/k/v/dmix/dq/dk/dv (B, L, H, D) contiguous in one dtype (0 = float32,
// 1 = bfloat16); mask (B, L) bytes (1 = valid) or null; stats as the
// forward wrote them. fp32 scratch by family (mt::dilated_family):
// the CUDA-core kernels take w and delta (B*H, n_branches, L); the
// tensor-core families (D = 48, bf16 or fp32; q/k/v/dmix 16-byte aligned)
// take rows_c (3, B, H, M) and grads_c (3, B, H, M, D), M the compact rows of a head
// (ops/dilated_fused.py::total_rows). [q0, q1) is the forward's query range
// (0, L: every row): dq is 0 outside it, and dk/dv sum over its queries
// alone, this shard's part of the whole gradient; an empty range or one
// outside [0, L) is refused. Returns a cudaError_t; 0 means every kernel was
// launched.
extern "C" int mt_dilated_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* mask, const void* dmix, const void* stats,
                                        void* w, void* delta, void* rows_c, void* grads_c,
                                        void* dq, void* dk, void* dv, int B, int L, int H, int D,
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
  const auto st = static_cast<const float*>(stats);
  const int family = mt::dilated_family(D, dtype);
  if (family != 0) {
    mt::FusedBranches fb{};
    if (rows_c == nullptr || grads_c == nullptr ||
        !mt::make_fused_branches(fb, L, segments, ratios, n_branches) ||
        !mt::set_query_range(fb, L, q0, q1))
      return cudaErrorInvalidValue;
    return mt::launch_dilated_bwd_compact(q, k, v, m, dmix, st, static_cast<float*>(rows_c),
                                          static_cast<float*>(grads_c), dq, dk, dv, B, L, H,
                                          scale, fb, family, s);
  }
  if (w == nullptr || delta == nullptr) return cudaErrorInvalidValue;
  const auto wf = static_cast<float*>(w);
  const auto df = static_cast<float*>(delta);
  if (dtype == 0)
    return mt::dispatch_dilated_bwd<float>(DP, q, k, v, m, dmix, st, wf, df, dq, dk, dv, B, L, H,
                                           D, scale, br, q0, q1, s);
  if (dtype == 1)
    return mt::dispatch_dilated_bwd<__nv_bfloat16>(DP, q, k, v, m, dmix, st, wf, df, dq, dk, dv,
                                                   B, L, H, D, scale, br, q0, q1, s);
  return cudaErrorInvalidValue;
}

// K1b in two parts over the token range [r0, r1) (launch_dilated_bwd_part),
// the bf16 tensor-core family only (D = 48; q/k/v/dmix 16-byte aligned):
// the arguments of mt_dilated_attention_bwd without w and delta, and part
// (0 or 1). Returns a cudaError_t; 0 means every kernel was launched.
extern "C" int mt_dilated_attention_bwd_part(const void* q, const void* k, const void* v,
                                             const void* mask, const void* dmix,
                                             const void* stats, void* rows_c, void* grads_c,
                                             void* dq, void* dk, void* dv, int B, int L, int H,
                                             int D, const int* segments, const int* ratios,
                                             int n_branches, float scale, int dtype, int part,
                                             int r0, int r1, void* stream) {
  mt::FusedBranches fb{};
  if (mt::dilated_family(D, dtype) != 1 || B < 1 || B > 65535 || H < 1 || H > 65535 ||
      (part != 0 && part != 1) || rows_c == nullptr || grads_c == nullptr ||
      !mt::make_fused_branches(fb, L, segments, ratios, n_branches))
    return cudaErrorInvalidValue;
  return mt::launch_dilated_bwd_part(q, k, v, static_cast<const unsigned char*>(mask), dmix,
                                     static_cast<const float*>(stats),
                                     static_cast<float*>(rows_c), static_cast<float*>(grads_c),
                                     dq, dk, dv, B, L, H, scale, fb, part, r0, r1,
                                     static_cast<cudaStream_t>(stream));
}
