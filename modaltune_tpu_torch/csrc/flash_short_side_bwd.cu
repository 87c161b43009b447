// Flash attention backward with an additive key bias (K2b), the short-side
// family: bf16 at head dimension 16 with one side of at most 128 rows
// (flash_short_side.cuh has the frame). flash_attention_bwd.cu's entry point
// picks it; fp32 at these shapes runs flash_short_side_tf32_bwd.cu, the rest
// that file's CUDA-core kernels.
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the Pallas TPU kernels launched by _bwd_pallas), for the
// adapter's attentions.
//
// Computes, from the forward's out and lse, for every bh:
//   delta = rowsum(dout * out)
//   P  = exp(q k^T * scale + bias - lse)   (0 for a key with bias <= NEG_INF/2;
//                                           a row whose keys are all masked
//                                           gets zero gradients)
//   dS = P * (dout v^T - delta)
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dout
//
// What bounds it on the H100: bytes. At the adapter's long shapes a call
// reads q, k, v, dout, out and writes three gradients, 50-80 MB, for about 3
// GFLOP: 15-23 us of HBM time.
//
// What the design does about it: one kernel makes the resident side's
// gradient in full and the long side's as a partial per chunk, a second
// kernel adds the partials in chunk order (no atomics).
// * Short keys (Injector): the block streams tiles of q, dout and out; a
//   warp takes delta, P and dS of 16 query rows against every resident key
//   and stores their dq; P and dS go to shared memory as hi and lo bf16
//   planes, from which the warps add P^T dout and dS^T q of the tile to the
//   chunk's partial dv and dk, split over the warps by (dk or dv, 16 keys).
// * Short queries (Extractor): the block holds q, dout, lse and delta of the
//   resident queries and streams tiles of k and v; a warp takes P^T and dS^T
//   of 16 keys against every resident query and stores their dk and dv; dS
//   goes to shared memory (hi and lo), from which the warps add dS k of the
//   tile to the chunk's partial dq, split over the warps by 16 queries. A
//   chunk whose keys are all masked writes zero dk, dv and partial dq and
//   skips its tiles.
#include "flash_short_side.cuh"

namespace mt {
namespace ss {

struct BwdArgs {
  const bf16 *q, *k, *v;
  const float* bias;
  const bf16 *dout, *out;
  const float* lse;
  bf16 *dq, *dk, *dv;
  int BH, Lq, Lk, C;
  float scale, scale2;  // softmax scale, and times log2(e)
  float* work;
  cudaStream_t stream;
};

// Row r of a (.., 16) bf16 tile at `a` dotted with the same row at `b`: the
// four threads of a quad take four columns each.
__device__ __forceinline__ float quad_row_dot(const bf16* a, const bf16* b, int r, int t4) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a + r * kD + 4 * t4);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b + r * kD + 4 * t4);
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 p = __bfloat1622float2(a2[i]), o = __bfloat1622float2(b2[i]);
    x = fmaf(p.x, o.x, fmaf(p.y, o.y, x));
  }
  return wg::quad_sum(x);
}

// Store two bf16 pairs of an accumulator pair (rows g + 8 h) to a row of a
// (.., 16) array: columns 2 t4 and 8 + 2 t4.
__device__ __forceinline__ void store_row(bf16* row, const float (&lo)[4], const float (&hi)[4],
                                          int h, int t4, float mul) {
  uint32_t* r32 = reinterpret_cast<uint32_t*>(row);
  r32[t4] = wg::pack_bf16(lo[2 * h] * mul, lo[2 * h + 1] * mul);
  r32[4 + t4] = wg::pack_bf16(hi[2 * h] * mul, hi[2 * h + 1] * mul);
}

__device__ __forceinline__ void store_partial(float* row, const float (&lo)[4], const float (&hi)[4],
                                              int h, int t4) {
  float2* r2 = reinterpret_cast<float2*>(row);
  r2[t4] = make_float2(lo[2 * h], lo[2 * h + 1]);
  r2[4 + t4] = make_float2(hi[2 * h], hi[2 * h + 1]);
}

// Shared-memory plan of the short-keys kernel, in bytes from the base.
template <int KT>
struct KeysPlan {
  static constexpr int KP = KT * 16;
  static constexpr int PS = (KP + 8) * 2;  // a P / dS row: ldmatrix.trans without conflicts
  static constexpr int buf_off = Ring<3>::kBytes;  // planes P hi, P lo, dS hi, dS lo
  static constexpr int k_off = buf_off + 4 * kTile * PS;
  static constexpr int v_off = k_off + KP * kResStride;
  static constexpr int kadd_off = v_off + KP * kResStride;
  static constexpr int bar_off = kadd_off + KP * 4;
  static constexpr int lrow_off = bar_off + kStages * 8;  // + the chunk's rows, 4 bytes each
};

// Block (chunk, bh), four warps. Streams the chunk's 64-row tiles of q, dout
// and out; K, V and the key terms are resident. Stores dq of its rows and
// writes the chunk's partial dv and dk of every resident key to `work`
// ([2][BH][C][KP][16], dv first).
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_short_keys_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            const bf16* __restrict__ dout, const bf16* __restrict__ out,
                            const float* __restrict__ lse, bf16* __restrict__ dq,
                            float* __restrict__ work, int Lq, int Lk, float scale, float scale2,
                            int C) {
  using P = KeysPlan<KT>;
  constexpr int KP = P::KP, kUnits = (2 * KT + kWarps - 1) / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring<3> ring{reinterpret_cast<bf16*>(smem), reinterpret_cast<uint64_t*>(smem + P::bar_off)};
  float* kadd = reinterpret_cast<float*>(smem + P::kadd_off);
  float* lrow = reinterpret_cast<float*>(smem + P::lrow_off);
  const uint32_t bufaddr = wg::smem_u32(smem + P::buf_off);
  const uint32_t kaddr = wg::smem_u32(smem + P::k_off), vaddr = wg::smem_u32(smem + P::v_off);
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lq);
  const size_t qrow0 = static_cast<size_t>(bh) * Lq;
  const bf16* const src[3] = {q + qrow0 * kD, dout + qrow0 * kD, out + qrow0 * kD};

  load_resident(smem + P::k_off, k + static_cast<size_t>(bh) * Lk * kD, Lk, KP);
  load_resident(smem + P::v_off, v + static_cast<size_t>(bh) * Lk * kD, Lk, KP);
  const float* bb = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh) * Lk;
  for (int j = threadIdx.x; j < KP; j += blockDim.x) kadd[j] = key_term(bb, j, Lk, wg::kLog2e);
  for (int i = threadIdx.x; i < ch.tiles * kTile; i += blockDim.x)
    lrow[i] = lse2_for_bwd(lse + qrow0, ch.row0 + i, Lq);
  ring.init();
  if (threadIdx.x == 0)
    for (int t = 0; t < min(kStages, ch.tiles); ++t)
      ring.issue(t, src, ch.row0 + t * kTile, min(kTile, ch.rows - t * kTile));

  float acc[kUnits][2][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    zero(acc[u][0]);
    zero(acc[u][1]);
  }
  const int rl = 16 * warp + g;  // the warp's rows of a tile: rl and rl + 8

  for (int t = 0; t < ch.tiles; ++t) {
    ring.wait(t);
    // delta, P and dS of the warp's 16 rows against every key
    const float delta[2] = {quad_row_dot(ring.tile(t, 1), ring.tile(t, 2), rl, t4),
                            quad_row_dot(ring.tile(t, 1), ring.tile(t, 2), rl + 8, t4)};
    const float lr[2] = {lrow[t * kTile + rl], lrow[t * kTile + rl + 8]};
    uint32_t aq[4], ado[4];
    ldsm(aq, rows_first(ring.addr(t, 0), kRowBytes, 16 * warp, 0));
    ldsm(ado, rows_first(ring.addr(t, 1), kRowBytes, 16 * warp, 0));
    float s[2 * KT][4], dp[2 * KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t b[4];
      ldsm(b, cols_first(kaddr, kResStride, 16 * j, 0));
      zero(s[2 * j]);
      zero(s[2 * j + 1]);
      mma(s[2 * j], aq, b[0], b[1]);
      mma(s[2 * j + 1], aq, b[2], b[3]);
      ldsm(b, cols_first(vaddr, kResStride, 16 * j, 0));
      zero(dp[2 * j]);
      zero(dp[2 * j + 1]);
      mma(dp[2 * j], ado, b[0], b[1]);
      mma(dp[2 * j + 1], ado, b[2], b[3]);
    }
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      const float2 ka = *reinterpret_cast<const float2*>(kadd + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            wg::exp2_fast(fmaf(s[n][e], scale2, (e & 1 ? ka.y : ka.x) - lr[e >> 1]));
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta[e >> 1]);
      }
    }
    // dq = dS K * scale, complete: the sum runs over the resident keys
    float dqa[2][4];
    zero(dqa[0]);
    zero(dqa[1]);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t ah[4], al[4], b[4];
      split_a(ah, al, dp[2 * j], dp[2 * j + 1]);
      ldsm_t(b, rows_first(kaddr, kResStride, 16 * j, 0));
      mma2(dqa[0], ah, al, b[0], b[1]);
      mma2(dqa[1], ah, al, b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ch.row0 + t * kTile + rl + 8 * h;
      if (row < Lq) store_row(dq + (qrow0 + row) * kD, dqa[0], dqa[1], h, t4, scale);
    }
    // P and dS of the tile as hi and lo bf16 planes, [row][key]
    constexpr int kPlane = kTile * P::PS;
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* b32 = reinterpret_cast<uint32_t*>(smem + P::buf_off + (rl + 8 * h) * P::PS +
                                                    (8 * n + 2 * t4) * 2);
        split_pair(s[n][2 * h], s[n][2 * h + 1], b32[0], b32[kPlane / 4]);
        split_pair(dp[n][2 * h], dp[n][2 * h + 1], b32[2 * kPlane / 4], b32[3 * kPlane / 4]);
      }
    __syncthreads();
    // the warp's units u: dv (P^T dout) or dk (dS^T q) of keys 16 (u / 2) ..
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = warp + kWarps * i;
      if (u < 2 * KT) {
        const bool is_dk = u & 1;
        const uint32_t hi = bufaddr + (is_dk ? 2 : 0) * kPlane, bbase = ring.addr(t, is_dk ? 0 : 1);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t ah[4], al[4], b[4];
          ldsm_t(ah, cols_first(hi, P::PS, 16 * kk, 16 * (u / 2)));
          ldsm_t(al, cols_first(hi + kPlane, P::PS, 16 * kk, 16 * (u / 2)));
          ldsm_t(b, rows_first(bbase, kRowBytes, 16 * kk, 0));
          mma2(acc[i][0], ah, al, b[0], b[1]);
          mma2(acc[i][1], ah, al, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage and the P / dS buffers are free
    if (threadIdx.x == 0 && t + kStages < ch.tiles)
      ring.issue(t + kStages, src, ch.row0 + (t + kStages) * kTile,
                 min(kTile, ch.rows - (t + kStages) * kTile));
  }

  const size_t part = static_cast<size_t>(bh) * C + blockIdx.x;
  const size_t plane = static_cast<size_t>(gridDim.y) * C * KP * kD;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = warp + kWarps * i;
    if (u < 2 * KT) {
      float* base = work + (u & 1) * plane + part * KP * kD;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_partial(base + (16 * (u / 2) + g + 8 * h) * kD, acc[i][0], acc[i][1], h, t4);
    }
  }
}

// Shared-memory plan of the short-queries kernel, in bytes from the base.
template <int QT>
struct QueriesPlan {
  static constexpr int QP = QT * 16;
  static constexpr int SS = (QP + 8) * 2;  // a dS row
  static constexpr int ds_off = Ring<2>::kBytes;  // planes dS hi, dS lo
  static constexpr int q_off = ds_off + 2 * kTile * SS;
  static constexpr int do_off = q_off + QP * kResStride;
  static constexpr int lq_off = do_off + QP * kResStride;
  static constexpr int delta_off = lq_off + QP * 4;
  static constexpr int bar_off = delta_off + QP * 4;
  static constexpr int kadd_off = bar_off + kStages * 8;  // + the chunk's keys, 4 bytes each
};

// Block (chunk, bh), four warps. q, dout, lse and delta of the resident
// queries are held; the chunk's 64-key tiles of k and v stream. Stores dk, dv
// of its keys and writes the chunk's partial dq of every resident query
// ([BH][C][QP][16]) to `work`.
template <int QT>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_short_queries_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ bias,
                               const bf16* __restrict__ dout, const bf16* __restrict__ out,
                               const float* __restrict__ lse, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, float* __restrict__ work, int Lq, int Lk,
                               float scale, float scale2, int C) {
  using P = QueriesPlan<QT>;
  constexpr int QP = P::QP, kUnits = (QT + kWarps - 1) / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring<2> ring{reinterpret_cast<bf16*>(smem), reinterpret_cast<uint64_t*>(smem + P::bar_off)};
  float* lq2 = reinterpret_cast<float*>(smem + P::lq_off);
  float* delta = reinterpret_cast<float*>(smem + P::delta_off);
  float* kadd = reinterpret_cast<float*>(smem + P::kadd_off);
  const uint32_t dsaddr = wg::smem_u32(smem + P::ds_off);
  const uint32_t qaddr = wg::smem_u32(smem + P::q_off), doaddr = wg::smem_u32(smem + P::do_off);
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lk);
  const size_t qrow0 = static_cast<size_t>(bh) * Lq, krow0 = static_cast<size_t>(bh) * Lk;
  const bf16* const src[2] = {k + krow0 * kD, v + krow0 * kD};

  load_resident(smem + P::q_off, q + qrow0 * kD, Lq, QP);
  load_resident(smem + P::do_off, dout + qrow0 * kD, Lq, QP);
  for (int i = threadIdx.x; i < QP; i += blockDim.x) {
    lq2[i] = lse2_for_bwd(lse + qrow0, i, Lq);
    float x = 0.f;
    if (i < Lq) {
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(dout + (qrow0 + i) * kD);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(out + (qrow0 + i) * kD);
#pragma unroll
      for (int c = 0; c < kD / 2; ++c) {
        const float2 a = __bfloat1622float2(d2[c]), b = __bfloat1622float2(o2[c]);
        x = fmaf(a.x, b.x, fmaf(a.y, b.y, x));
      }
    }
    delta[i] = x;
  }
  const float* bb = bias == nullptr ? nullptr : bias + krow0;
  int any = 0;
  for (int j = threadIdx.x; j < ch.tiles * kTile; j += blockDim.x) {
    kadd[j] = key_term(bb, ch.row0 + j, Lk, wg::kLog2e);
    any |= kadd[j] != -INFINITY;
  }
  ring.init();
  const bool live = __syncthreads_or(any);
  const int tiles = live ? ch.tiles : 0;
  if (!live) {  // every key of the chunk is masked: zero dk and dv
    uint4* dk4 = reinterpret_cast<uint4*>(dk + (krow0 + ch.row0) * kD);
    uint4* dv4 = reinterpret_cast<uint4*>(dv + (krow0 + ch.row0) * kD);
    for (int i = threadIdx.x; i < ch.rows * 2; i += blockDim.x)
      dk4[i] = dv4[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0)
    for (int t = 0; t < min(kStages, tiles); ++t)
      ring.issue(t, src, ch.row0 + t * kTile, min(kTile, ch.rows - t * kTile));

  float dqa[kUnits][2][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    zero(dqa[u][0]);
    zero(dqa[u][1]);
  }
  const int kl = 16 * warp + g;  // the warp's keys of a tile: kl and kl + 8

  for (int t = 0; t < tiles; ++t) {
    ring.wait(t);
    // P^T and dS^T of the warp's 16 keys against every resident query
    uint32_t ak[4], av[4];
    ldsm(ak, rows_first(ring.addr(t, 0), kRowBytes, 16 * warp, 0));
    ldsm(av, rows_first(ring.addr(t, 1), kRowBytes, 16 * warp, 0));
    float s[2 * QT][4], dp[2 * QT][4];
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      uint32_t b[4];
      ldsm(b, cols_first(qaddr, kResStride, 16 * j, 0));
      zero(s[2 * j]);
      zero(s[2 * j + 1]);
      mma(s[2 * j], ak, b[0], b[1]);
      mma(s[2 * j + 1], ak, b[2], b[3]);
      ldsm(b, cols_first(doaddr, kResStride, 16 * j, 0));
      zero(dp[2 * j]);
      zero(dp[2 * j + 1]);
      mma(dp[2 * j], av, b[0], b[1]);
      mma(dp[2 * j + 1], av, b[2], b[3]);
    }
    const float kr[2] = {kadd[t * kTile + kl], kadd[t * kTile + kl + 8]};
#pragma unroll
    for (int n = 0; n < 2 * QT; ++n) {
      // the queries 8 n + 2 t4 and + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lq2 + 8 * n + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            wg::exp2_fast(fmaf(s[n][e], scale2, kr[e >> 1] - (e & 1 ? l2.y : l2.x)));
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - (e & 1 ? d2.y : d2.x));
      }
    }
    // dv = P^T dout and dk = dS^T q * scale of the warp's keys, complete
    float dva[2][4], dka[2][4];
    zero(dva[0]);
    zero(dva[1]);
    zero(dka[0]);
    zero(dka[1]);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      uint32_t ah[4], al[4], b[4];
      split_a(ah, al, s[2 * j], s[2 * j + 1]);
      ldsm_t(b, rows_first(doaddr, kResStride, 16 * j, 0));
      mma2(dva[0], ah, al, b[0], b[1]);
      mma2(dva[1], ah, al, b[2], b[3]);
      split_a(ah, al, dp[2 * j], dp[2 * j + 1]);
      ldsm_t(b, rows_first(qaddr, kResStride, 16 * j, 0));
      mma2(dka[0], ah, al, b[0], b[1]);
      mma2(dka[1], ah, al, b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = ch.row0 + t * kTile + kl + 8 * h;
      if (key < Lk) {
        store_row(dv + (krow0 + key) * kD, dva[0], dva[1], h, t4, 1.f);
        store_row(dk + (krow0 + key) * kD, dka[0], dka[1], h, t4, scale);
      }
    }
    // dS of the tile as hi and lo bf16 planes, [key][query]
    constexpr int kPlane = kTile * P::SS;
#pragma unroll
    for (int n = 0; n < 2 * QT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* d32 = reinterpret_cast<uint32_t*>(smem + P::ds_off + (kl + 8 * h) * P::SS +
                                                    (8 * n + 2 * t4) * 2);
        split_pair(dp[n][2 * h], dp[n][2 * h + 1], d32[0], d32[kPlane / 4]);
      }
    __syncthreads();
    // the warp's units: partial dq of queries 16 u .. += dS K over the tile
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = warp + kWarps * i;
      if (u < QT) {
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t ah[4], al[4], b[4];
          ldsm_t(ah, cols_first(dsaddr, P::SS, 16 * kk, 16 * u));
          ldsm_t(al, cols_first(dsaddr + kPlane, P::SS, 16 * kk, 16 * u));
          ldsm_t(b, rows_first(ring.addr(t, 0), kRowBytes, 16 * kk, 0));
          mma2(dqa[i][0], ah, al, b[0], b[1]);
          mma2(dqa[i][1], ah, al, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage and the dS buffer are free
    if (threadIdx.x == 0 && t + kStages < tiles)
      ring.issue(t + kStages, src, ch.row0 + (t + kStages) * kTile,
                 min(kTile, ch.rows - (t + kStages) * kTile));
  }

  float* base = work + (static_cast<size_t>(bh) * C + blockIdx.x) * QP * kD;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = warp + kWarps * i;
    if (u < QT)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_partial(base + (16 * u + g + 8 * h) * kD, dqa[i][0], dqa[i][1], h, t4);
  }
}

template <int KT>
cudaError_t bwd_short_keys(const BwdArgs& a) {
  using P = KeysPlan<KT>;
  auto kernel = flash_bwd_short_keys_kernel<KT>;
  const size_t smem = P::lrow_off + max_chunk_rows(a.Lq, a.C) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.C, a.BH), kWarps * 32, smem, a.stream>>>(a.q, a.k, a.v, a.bias, a.dout, a.out,
                                                           a.lse, a.dq, a.work, a.Lq, a.Lk,
                                                           a.scale, a.scale2, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.BH * a.Lk * kD;
  flash_bwd_sum_kernel<bf16><<<dim3((n + 255) / 256, 2), 256, 0, a.stream>>>(
      a.work, a.dv, a.dk, 1.f, a.scale, a.BH, a.Lk, P::KP, a.C);
  return cudaGetLastError();
}

template <int QT>
cudaError_t bwd_short_queries(const BwdArgs& a) {
  using P = QueriesPlan<QT>;
  auto kernel = flash_bwd_short_queries_kernel<QT>;
  const size_t smem = P::kadd_off + max_chunk_rows(a.Lk, a.C) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.C, a.BH), kWarps * 32, smem, a.stream>>>(a.q, a.k, a.v, a.bias, a.dout, a.out,
                                                           a.lse, a.dk, a.dv, a.work, a.Lq, a.Lk,
                                                           a.scale, a.scale2, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.BH * a.Lq * kD;
  flash_bwd_sum_kernel<bf16><<<dim3((n + 255) / 256, 1), 256, 0, a.stream>>>(
      a.work, a.dq, a.dq, a.scale, a.scale, a.BH, a.Lq, P::QP, a.C);
  return cudaGetLastError();
}

using BwdFn = cudaError_t (*)(const BwdArgs&);
constexpr BwdFn kBwdShortKeys[8] = {bwd_short_keys<1>, bwd_short_keys<2>, bwd_short_keys<3>,
                                    bwd_short_keys<4>, bwd_short_keys<5>, bwd_short_keys<6>,
                                    bwd_short_keys<7>, bwd_short_keys<8>};
constexpr BwdFn kBwdShortQueries[8] = {
    bwd_short_queries<1>, bwd_short_queries<2>, bwd_short_queries<3>, bwd_short_queries<4>,
    bwd_short_queries<5>, bwd_short_queries<6>, bwd_short_queries<7>, bwd_short_queries<8>};

cudaError_t launch_bwd(int fam, const bf16* q, const bf16* k, const bf16* v, const float* bias,
                       const bf16* dout, const bf16* out, const float* lse, bf16* dq, bf16* dk,
                       bf16* dv, int BH, int Lq, int Lk, float scale, int chunks, float* work,
                       cudaStream_t stream) {
  const BwdArgs a{q,  k,  v,  bias, dout,   out,   lse,   dq,   dk,
                  dv, BH, Lq, Lk,   chunks, scale, scale * wg::kLog2e, work, stream};
  if (out == nullptr || work == nullptr) return cudaErrorInvalidValue;
  if (fam == kShortKeys) {
    if (!chunks_valid(Lq, chunks)) return cudaErrorInvalidValue;
    return kBwdShortKeys[pad16(Lk) / 16 - 1](a);
  }
  if (fam != kShortQueries || !chunks_valid(Lk, chunks)) return cudaErrorInvalidValue;
  return kBwdShortQueries[pad16(Lq) / 16 - 1](a);
}

}  // namespace ss
}  // namespace mt
