// Flash attention forward with the 2-D ALiBi bias computed per tile (K4f):
// the attention of the TITAN backbone's blocks.
//
// Replaces: modaltune_tpu/ops/alibi_flash.py::_fwd_kernel and
// ::_fwd_kernel_ah (the Pallas TPU kernels launched by _fwd_pallas, one head
// per grid step, and _fwd_pallas_ah, all heads per grid step: one function
// in two TPU tilings, and this kernel is the counterpart of both).
//
// Computes, for every batch row b, head h and query i:
//   s_j  = (q_i . k_j) * scale
//          - slope[h] * ||c_i - c_j||_2 * (1 - cls_i) * (1 - cls_j)
//          + bias[b, j]
//   out  = sum_j softmax(s)_j v_j        (a key with bias <= NEG_INF/2 gets
//                                          exactly zero weight)
//   lse  = log sum_j exp(s_j)            (NEG_INF and out = 0 when every key
//                                          of the row is masked)
// with coords[b, i] = [row, col, is_cls]. Layout q/k/v/out (B, H, N, D),
// coords (B, N, 3) fp32, slopes (H,) fp32, bias (B, N) fp32 or null, lse
// (B, H, N) fp32, all contiguous; q/k/v fp32 or bf16, fp32 statistics and
// accumulation.
//
// What bounds it on the H100: operations. At the TITAN geometry (3 task rows
// x 12 heads, N = 16,384, D = 64) the two products are 4 N^2 D x 36 = 2.47
// TFLOP against 0.3 GB of q/k/v/out, so the tensor cores' 989 TFLOP/s bound
// it at 2.5 ms. That bound leaves out what the function needs beside the
// products: one exp per (pair, head) and one sqrt per pair, on the
// special-function units (16 results a clock and SM), and the handful of
// fp32 instructions that turn a product into a weight. They, not the
// products, set the pace, so the design spends on them first.
//
// What the design does about it. The dense (H, N, N) bias (12.9 GB in fp32 at
// this size) is never built; two kernels share the function:
// * bf16 at D = 64, the model's path: alibi_fwd_wg_kernel on the Hopper frame
//   (attention_wgmma.cuh). A block is a producer warpgroup, whose one working
//   lane streams k and v tiles with TMA through a ring of four stages, and W
//   consumer warpgroups of 64 query rows that run S = q k^T and O += P v as
//   wgmma products. S stays in registers: each thread knows the (row, key) of
//   the 32 scores it holds, applies scale, ALiBi term and key term there,
//   keeps the online softmax's max and sum per row (shared with the three
//   other threads of its quad by shuffles), rescales O in registers and packs
//   P to bf16 as the register operand of the second product. A block loops
//   over a group of G heads for every key tile: the distance tile
//   dist * not_cls depends on (batch row, query, key) only, is computed once
//   per tile pair while the first head's product runs, and each head adds
//   -slope_h times it with one FMA. exp is exp2 with log2(e) folded into the
//   scale and the slopes, sqrt is sqrt.approx. Key tiles without a valid key
//   (the wrapper flags the live ones per batch row) are never loaded; a
//   masked key inside a live tile has the key term -inf and gets weight 0.
//   The grid is (N / 64 / W, H / G, B), built with G = 3 and W = 2.
// * fp32 (tests and oracles), and bf16 at any other D <= 128 (no model of the
//   package has one): alibi_fwd_kernel is K2f's design on CUDA cores with
//   fp32 arithmetic and IEEE sqrt, four rows per warp. The Hopper frame
//   serves D = 64 alone, where a row of a tile is exactly one 128-byte
//   swizzled line.
#include "alibi_tf32.cuh"
#include "attention_wgmma.cuh"

namespace mt {

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
alibi_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ coords, const float* __restrict__ slopes,
                 const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
                 int H, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Tiles<DP> t(smem);
  float* qc = smem + Plan<DP>::floats;  // [3][kBlockQ]
  float* kc = qc + 3 * kBlockQ;         // [3][kBlockK]
  const AlibiTerm term{qc, kc};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, N - q0);

  const T* qb = q + (static_cast<size_t>(bh) * N + q0) * D;
  const T* kb = k + static_cast<size_t>(bh) * N * D;
  const T* vb = v + static_cast<size_t>(bh) * N * D;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;

  load_rows<DP, kBlockQ, Plan<DP>::QS>(t.q, qb, nq, D, scale,
                                       [D](int r) { return static_cast<size_t>(r) * D; });
  load_coords(qc, cb, q0, nq, slopes[bh % H]);
  t.init_state();

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    const int nk = min(kBlockK, N - k0);
    __syncthreads();  // the previous tile is consumed
    const auto row = [D, k0](int j) { return static_cast<size_t>(k0 + j) * D; };
    load_rows<DP, kBlockK, Plan<DP>::KS>(t.k, kb, nk, D, 1.f, row);
    load_rows<DP, kBlockK, DP>(t.v, vb, nk, D, 1.f, row);
    load_coords(kc, cb, k0, nk, 1.f);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads)
      t.bias[j] = (j < nk && biasb != nullptr) ? biasb[k0 + j] : 0.f;
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nq; r0 += kWarps * kRowsPerWarp)
      fold_rows<DP>(t, r0, 1, min(kRowsPerWarp, nq - r0), nk, warp, lane, term);
  }
  __syncthreads();

  for (int r = warp; r < nq; r += kWarps) {
    const float l = t.l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out + (static_cast<size_t>(bh) * N + q0 + r) * D;
    for (int d = lane; d < D; d += 32) o[d] = from_float<T>(t.acc[r * DP + d] * inv);
    if (lane == 0) lse[static_cast<size_t>(bh) * N + q0 + r] = l > 0.f ? t.m[r] + logf(l) : kNegInf;
  }
}

// bf16 at head dimension 64 on the Hopper frame (attention_wgmma.cuh). A block
// owns 64 * W query rows of one batch row and G heads; a ring stage is the k
// and v tiles of one (live key tile, head) pair with the tile's coordinate
// planes and key terms behind them. Shared memory: the W * G q tiles, the
// ring, the barriers.
template <int G, int W>
struct AlibiFwdWg {
  static constexpr int kStages = 4;
  static constexpr int kThreads = (W + 1) * wg::kWgThreads;
  static constexpr int kPlanes = 2 * wg::kTileBytes;              // y, x, w planes
  static constexpr int kKeyAdd = kPlanes + 3 * wg::kRowBytes;     // 0 / -inf per key
  static constexpr int kStageBytes = kKeyAdd + wg::kRowBytes;
  static constexpr int kQBytes = W * G * wg::kTileBytes;
  static constexpr int kRing = kQBytes;
  static constexpr int kBars = kRing + kStages * kStageBytes;
  static constexpr size_t bytes = 1024 + kBars + (2 * kStages + 1) * sizeof(uint64_t);
  static_assert(kStageBytes % 1024 == 0, "a stage keeps its tiles 1024-byte aligned");
  static_assert(bytes <= 232448 / (W == 1 ? 2 : 1), "over the shared memory of the blocks");
};

template <int G, int W>
__global__ void __launch_bounds__(AlibiFwdWg<G, W>::kThreads, W == 1 ? 2 : 1)
alibi_fwd_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const wg::SideInputs side,
                    const float* __restrict__ slopes, bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int N, float scale2) {
  using P = AlibiFwdWg<G, W>;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_wg) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = smem + P::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + P::kStages;
  uint64_t* q_bar = empty + P::kStages;

  const int n_tiles = (N + wg::kTile - 1) / wg::kTile, NP = n_tiles * wg::kTile;
  const int b = blockIdx.z, h0 = blockIdx.y * G, gn = min(G, H - h0);
  const int q0 = blockIdx.x * (wg::kTile * W);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 4 * W);
    }
    wg::mbar_init(q_bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * W) {
    // ---- producer: one lane keeps the ring full ----
    wg::give_registers<wg::kProducerRegs>();
    if (threadIdx.x != W * wg::kWgThreads) return;
    wg::mbar_expect(q_bar, W * gn * wg::kTileBytes);
    for (int w = 0; w < W; ++w)
      for (int g = 0; g < gn; ++g)
        wg::tma_tile(smem + (w * G + g) * wg::kTileBytes, &map_q, q_bar, q0 + wg::kTile * w,
                     b * H + h0 + g);
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
  const int n_live = wg::count_live(side.tile_live + b * n_tiles, n_tiles);
  float own[2][3];
  wg::own_coords(own, side.coords_t + static_cast<size_t>(b) * 3 * NP, NP, my_q0 + ln.row0);
  float nslope[G], o[G][32], m_run[G][2], l_run[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    nslope[g] = g < gn ? -slopes[h0 + g] * wg::kLog2e : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[g][i] = 0.f;
    m_run[g][0] = m_run[g][1] = kNegInf;
    l_run[g][0] = l_run[g][1] = 0.f;
  }
  wg::mbar_wait(q_bar, 0);

  wg::Ring r;
  float dnc[32];
  for (int t = 0; t < n_live; ++t) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= gn) continue;
      wg::mbar_wait(full + r.stage, r.phase);
      const unsigned char* st = ring + r.stage * P::kStageBytes;
      float s[32];
      wg::wgmma_fence();
      wg::product_ss(s, wg::tile_desc(smem + (w * G + g) * wg::kTileBytes), wg::tile_desc(st));
      wg::wgmma_commit();
      // the distance tile of this (query tile, key tile) pair, once for the
      // G heads, while the tensor cores work on the first head's scores
      if (g == 0)
        wg::distance_tile(dnc, own, reinterpret_cast<const float*>(st + P::kPlanes), ln.col0);
      const float* key_add = reinterpret_cast<const float*>(st + P::kKeyAdd);
      wg::wgmma_wait<0>();
      wg::hold(s);

      // scores in log2 units; a masked key's term is -inf, so its weight is 0
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 ka = *reinterpret_cast<const float2*>(key_add + 8 * j + ln.col0);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          s[i] = fmaf(s[i], scale2, fmaf(nslope[g], dnc[i], ka.x));
          s[i + 1] = fmaf(s[i + 1], scale2, fmaf(nslope[g], dnc[i + 1], ka.y));
          tmax[rr] = fmaxf(tmax[rr], fmaxf(s[i], s[i + 1]));
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        // never below NEG_INF, so finite; the row sum stays a per-thread
        // partial until the end (the rescale is the same for the quad)
        const float m_new = fmaxf(m_run[g][rr], wg::quad_max(tmax[rr]));
        const float c_old = wg::exp2_fast(m_run[g][rr] - m_new);
        m_run[g][rr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * rr;
          s[i] = wg::exp2_fast(s[i] - m_new);
          s[i + 1] = wg::exp2_fast(s[i + 1] - m_new);
          sum += s[i] + s[i + 1];
          o[g][i] *= c_old;
          o[g][i + 1] *= c_old;
        }
        l_run[g][rr] = l_run[g][rr] * c_old + sum;
      }
      uint32_t p[16];
      wg::pack_tile(p, s);
      wg::wgmma_fence();
      wg::product_rs(o[g], p, wg::tile_desc(st + wg::kTileBytes));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::hold(o[g]);
      wg::hold(p);
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
      const float l = wg::quad_sum(l_run[g][rr]);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int row = my_q0 + ln.row0 + 8 * rr;
      if (row >= N) continue;
      bf16* orow = out + (bh * N + row) * wg::kD + ln.col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[g][i] * inv, o[g][i + 1] * inv);
      }
      if (ln.col0 == 0)
        lse[bh * N + row] = l > 0.f ? (m_run[g][rr] + log2f(l)) * wg::kLn2 : kNegInf;
    }
  }
}

// The Hopper kernel as it is built: G = 3 heads share a distance tile (more
// spill), W = 2 consumer warpgroups a block; the card's readings of the other
// pairs are in PERF.md.
constexpr int kFwdHeads = 3, kFwdWarpgroups = 2;

inline cudaError_t launch_alibi_wg(const void* q, const void* k, const void* v,
                            const wg::SideInputs& side, const float* slopes, void* out,
                            float* lse, int B, int H, int N, float scale, cudaStream_t stream) {
  constexpr int G = kFwdHeads, W = kFwdWarpgroups;
  using P = AlibiFwdWg<G, W>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = wg::make_tile_map(&map_q, q, B * H, N);
  if (err == cudaSuccess) err = wg::make_tile_map(&map_k, k, B * H, N);
  if (err == cudaSuccess) err = wg::make_tile_map(&map_v, v, B * H, N);
  auto kernel = alibi_fwd_wg_kernel<G, W>;
  if (err == cudaSuccess) err = allow_smem(kernel, P::bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + wg::kTile - 1) / wg::kTile;
  const dim3 grid((n_tiles + W - 1) / W, (H + G - 1) / G, B);
  kernel<<<grid, P::kThreads, P::bytes, stream>>>(map_q, map_k, map_v, side, slopes,
                                                  static_cast<bf16*>(out), lse, H, N,
                                                  scale * wg::kLog2e);
  return cudaGetLastError();
}

template <int DP, typename T>
cudaError_t launch_alibi(const void* q, const void* k, const void* v, const float* coords,
                         const float* slopes, const float* bias, void* out, float* lse, int B,
                         int H, int N, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Plan<DP>::bytes + sizeof(float) * 3 * (kBlockQ + kBlockK);
  static_assert(bytes <= 232448, "over the H100's shared memory per block");
  auto kernel = alibi_fwd_kernel<DP, T>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), coords,
      slopes, bias, static_cast<T*>(out), lse, H, N, D, scale);
  return cudaGetLastError();
}

// The CUDA-core kernel at the padded head dimension DP.
template <typename T>
cudaError_t dispatch_alibi(int DP, const void* q, const void* k, const void* v,
                           const float* coords, const float* slopes, const float* bias,
                           void* out, float* lse, int B, int H, int N, int D, float scale,
                           cudaStream_t s) {
  switch (DP) {
#define MT_CASE(W) \
  case W: return launch_alibi<W, T>(q, k, v, coords, slopes, bias, out, lse, B, H, N, D, scale, s);
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

// The family that serves (D, dtype) (0 = float32, 1 = bfloat16): 0 the
// CUDA-core kernels, 1 the bf16 Hopper frame (attention_wgmma.cuh), 2 the
// fp32 3xTF32 family (alibi_tf32.cuh). ops/alibi_flash.py asks it.
extern "C" int mt_alibi_family(int D, int dtype) { return mt::alibi_family(D, dtype); }

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no masking). At D = 64
// bf16 runs on the Hopper frame and fp32 on the 3xTF32 family; both need the
// side inputs (see wg::SideInputs); every other case ignores them. Returns a
// cudaError_t; 0 means the kernel was launched.
extern "C" int mt_alibi_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* coords, const void* slopes, const void* bias,
                                      void* out, void* lse, int B, int H, int N, int D,
                                      float scale, int dtype, const void* coords_t,
                                      const void* key_add, const void* tile_live,
                                      void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || B < 1 || H < 1 || B * H > 65535 || N < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const float*>(coords);
  const auto sl = static_cast<const float*>(slopes);
  const auto bs = static_cast<const float*>(bias);
  const auto l = static_cast<float*>(lse);
  const int fam = mt::alibi_family(D, dtype);
  if (fam != mt::kAlibiCudaCores) {
    if (coords_t == nullptr || key_add == nullptr || tile_live == nullptr)
      return cudaErrorInvalidValue;
    const mt::wg::SideInputs side{static_cast<const float*>(coords_t),
                                  static_cast<const float*>(key_add),
                                  static_cast<const int*>(tile_live)};
    if (fam == mt::kAlibiTf32x3)
      return mt::launch_alibi_tf32_fwd(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), side, sl,
                                       static_cast<float*>(out), l, B, H, N, scale, s);
    return mt::launch_alibi_wg(q, k, v, side, sl, out, l, B, H, N, scale, s);
  }
  if (dtype == 0)
    return mt::dispatch_alibi<float>(DP, q, k, v, c, sl, bs, out, l, B, H, N, D, scale, s);
  if (dtype == 1)
    return mt::dispatch_alibi<__nv_bfloat16>(DP, q, k, v, c, sl, bs, out, l, B, H, N, D, scale,
                                             s);
  return cudaErrorInvalidValue;
}
