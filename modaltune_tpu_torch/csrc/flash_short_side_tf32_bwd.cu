// Flash attention backward with an additive key bias (K2b), the short-side
// family at fp32: fp32 at head dimension 16 with one side of at most 128
// rows (flash_short_side_tf32.cuh has the frame), every adapter attention
// under an fp32 backbone (the CLI's --bf16 0). flash_attention_bwd.cu's
// entry point picks it.
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the Pallas TPU kernels launched by _bwd_pallas) at fp32,
// where their dots run at Precision.HIGHEST (exact fp32), for the adapter's
// attentions.
//
// Computes, from the forward's out and lse, for every bh:
//   delta = rowsum(dout * out)             (here, not in torch)
//   P  = exp(q k^T * scale + bias - lse)   (0 for a key with bias <= NEG_INF/2;
//                                           a row whose keys are all masked
//                                           gets zero gradients)
//   dS = P * (dout v^T - delta)
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dout
//
// What bounds it on the H100: bytes. At the adapter's long shapes (36 x
// 10,239 rows against 65) a call reads q, k, v, dout, out and writes three
// gradients, about 96 MB, 0.0288 ms at 3.35 TB/s; its five products at fp32
// accuracy are three TF32 products each, 0.023 ms at 495 TFLOP/s. The
// CUDA-core kernels of flash_attention_bwd.cu, which served these calls
// before with delta made in torch, read 1.59 and 1.34 card ms at the
// Injector and the Extractor (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).
//
// What the design does about it: the bf16 family's plan. One kernel makes
// the resident side's gradient in full and the long side's as a partial
// per chunk; flash_bwd_sum_kernel<float> adds the partials in chunk order
// (no atomics). Every product is 3xTF32; products over the streamed tiles
// or the resident rows sum 32 of their inner index a fresh fragment.
// * Short keys (Injector): K and V are resident as TF32 hi and lo planes,
//   V less vbar, the mean of the valid keys' v rows; the block streams tiles
//   of q, dout and out; a warp takes delta, P and dS of 16 query rows
//   against every key and stores their dq (dS k over the resident keys); P
//   and dS go to shared memory in fp32, from which the
//   warps add P^T dout and dS^T q of the tile (two fresh halves of 32
//   queries) to the chunk's partial dv and dk, split over the warps by (dk
//   or dv, 16 keys).
// * Short queries (Extractor): q and dout are resident as TF32 planes, with
//   lse and delta (made from dout and out at the block's start); the block
//   streams tiles of k and v; a warp takes S^T and dS^T of 16 keys against
//   every resident query and stores their dk and dv (P^T dout, dS^T q over
//   the resident queries); dS^T goes to shared memory, from which the warps
//   add dS k of the tile (two fresh halves of 32 keys) to the chunk's
//   partial dq, split over the warps by 16 queries. A chunk whose keys are
//   all masked writes zero dk, dv and partial dq and skips its tiles.
// * Short keys take dP - delta as dout.(v - vbar) - dout.(out - vbar): the
//   same value for any vbar, since P sums to 1. On an fp32 train step's
//   Injector the keys' v rows lie close together, so dP and delta agree to
//   three or four digits and dS is what is left of their difference; the
//   3xTF32 error of dP (about 2^-21 of |dout| |v|) then read 5.9e-5 of a
//   dq row's scale against the plain version in fp64, past the fp32 limit
//   (the plain version's own fp32 rounding read 3.1e-5 there; NVIDIA H100
//   80GB HBM3, 700 W, k2_fp32_precision.py on chip_smoke.py's per-branch
//   fp32 step). Less vbar, the products' error shrinks with |v - vbar|:
//   7.5e-6 in that script's emulation on the same inputs.
#include "flash_short_side_tf32.cuh"

namespace mt {
namespace sst {

constexpr int kBwdStages = 2;   // the tile multiplied and the next

struct BwdArgs {
  const float *q, *k, *v;
  const float* bias;
  const float *dout, *out;
  const float* lse;
  float *dq, *dk, *dv;
  int BH, Lq, Lk, C;
  float scale, scale2;  // softmax scale, and times log2(e)
  float* work;
  cudaStream_t stream;
};

// The transposed 16 x 32 register tile of rows r0 + g (+ 8) and columns
// [c0, c0 + 32) of a [column][row] fp32 array at x (`stride` floats a
// column), in the C layout (x[4 j + 2 rr + e]: row g + 8 rr, column
// 8 j + 2 t + e): P^T, dS^T or dS read back from shared memory.
__device__ __forceinline__ void transposed(float (&xr)[16], const float* x, int stride, int r0,
                                           int c0, int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        xr[4 * j + 2 * rr + e] = x[(c0 + 8 * j + 2 * t + e) * stride + r0 + g + 8 * rr];
}

// Shared memory of the short-keys kernel, in 4-byte words: the K and V
// planes (hi, lo), the key terms, vbar, the P and dS planes of a query tile
// ([query][key], PS floats a row), the ring of (q, dout, out) tiles, then
// the chunk's rows' lse in base 2.
template <int KT>
struct KeysBwdPlan {
  static constexpr int KP = KT * 16, PS = KP + 4;
  static constexpr int plane = KP * kStride;
  static constexpr int kadd = 4 * plane;
  static constexpr int vbar = kadd + KP;
  static constexpr int pds = vbar + kD;
  static constexpr int stage = 3 * kTileFloats;
  static constexpr int ring = pds + 2 * kTile * PS;
  static constexpr int lrow = ring + kBwdStages * stage;
  static_assert(ring % 4 == 0, "16-byte stages");
};

// Block (chunk, bh), four warps. Streams the chunk's 64-row tiles of q, dout
// and out; K, V and the key terms are resident. Stores dq of its rows and
// writes the chunk's partial dv and dk of every resident key to `work`
// ([2][BH][C][KP][16], dv first).
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_short_keys_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ bias,
                                 const float* __restrict__ dout, const float* __restrict__ out,
                                 const float* __restrict__ lse, float* __restrict__ dq,
                                 float* __restrict__ work, int Lq, int Lk, float scale,
                                 float scale2, int C) {
  using P = KeysBwdPlan<KT>;
  constexpr int KP = P::KP, PS = P::PS, kUnits = (2 * KT + kWarps - 1) / kWarps;
  extern __shared__ float4 smem_sst[];
  float* const base = reinterpret_cast<float*>(smem_sst);
  uint32_t* const khi = reinterpret_cast<uint32_t*>(base);
  uint32_t* const klo = khi + P::plane;
  uint32_t* const vhi = klo + P::plane;
  uint32_t* const vlo = vhi + P::plane;
  float* const kadd = base + P::kadd;
  float* const vbar = base + P::vbar;
  float* const pp = base + P::pds;   // P, [query][key]
  float* const dsp = pp + kTile * PS;  // dS
  float* const ring = base + P::ring;
  float* const lrow = base + P::lrow;
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lq);
  const size_t qrow0 = static_cast<size_t>(bh) * Lq;
  const size_t c0 = (qrow0 + ch.row0) * kD;
  const auto issue = [&](int t) {
    if (t < ch.tiles) {
      float* st = ring + t % kBwdStages * P::stage;
      const size_t at = c0 + static_cast<size_t>(t) * kTile * kD;
      const int n = ch.rows - t * kTile;
      load_tile(st, q + at, n);
      load_tile(st + kTileFloats, dout + at, n);
      load_tile(st + 2 * kTileFloats, out + at, n);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kBwdStages - 1; ++t) issue(t);

  const size_t krow0 = static_cast<size_t>(bh) * Lk;
  const float* bb = bias == nullptr ? nullptr : bias + krow0;
  for (int j = threadIdx.x; j < KP; j += blockDim.x) kadd[j] = ss::key_term(bb, j, Lk, wg::kLog2e);
  split_resident(khi, klo, k + krow0 * kD, Lk, KP);
  __syncthreads();   // the key terms are in
  if (threadIdx.x < kD) {   // vbar: the valid keys' mean v row (0 if none)
    float sum = 0.f;
    int n = 0;
    for (int j = 0; j < Lk; ++j)
      if (kadd[j] != -INFINITY) {
        sum += v[(krow0 + j) * kD + threadIdx.x];
        ++n;
      }
    vbar[threadIdx.x] = n > 0 ? sum / n : 0.f;
  }
  __syncthreads();
  split_resident(vhi, vlo, v + krow0 * kD, Lk, KP, vbar);
  for (int i = threadIdx.x; i < ch.tiles * kTile; i += blockDim.x)
    lrow[i] = ss::lse2_for_bwd(lse + qrow0, ch.row0 + i, Lq);

  float acc[kUnits][8] = {};
  const int rl = 16 * warp + g;  // the warp's rows of a tile: rl and rl + 8

  for (int t = 0; t < ch.tiles; ++t) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();   // tile t is in; no warp still reads tile t - 1's stage or planes
    issue(t + kBwdStages - 1);
    const float* qt = ring + t % kBwdStages * P::stage;
    const float* dt = qt + kTileFloats;
    const float* ot = dt + kTileFloats;
    // delta = dout.(out - vbar) of the warp's two rows: each thread of a
    // quad four columns
    const float4 m = *reinterpret_cast<const float4*>(vbar + 4 * t4);
    float delta[2], lr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(dt + (rl + 8 * h) * kStride + 4 * t4);
      const float4 b = *reinterpret_cast<const float4*>(ot + (rl + 8 * h) * kStride + 4 * t4);
      delta[h] = wg::quad_sum(
          fmaf(a.w, b.w - m.w, fmaf(a.z, b.z - m.z, fmaf(a.y, b.y - m.y, a.x * (b.x - m.x)))));
      lr[h] = lrow[t * kTile + rl + 8 * h];
    }
    // P and dS of the warp's 16 rows against every key (dp = dout.(v - vbar))
    float s[8 * KT], dp[8 * KT];
    {
      const float* q16 = qt + 16 * warp * kStride;
      const float* d16 = dt + 16 * warp * kStride;
      const Frag qa[2] = {tile_frag(q16, 0, g, t4), tile_frag(q16, 1, g, t4)};
      plane_scores<2 * KT>(s, qa, khi, klo, g, t4);
      const Frag da[2] = {tile_frag(d16, 0, g, t4), tile_frag(d16, 1, g, t4)};
      plane_scores<2 * KT>(dp, da, vhi, vlo, g, t4);
    }
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      const float2 ka = *reinterpret_cast<const float2*>(kadd + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        const float p = wg::exp2_fast(fmaf(s[i], scale2, (e & 1 ? ka.y : ka.x) - lr[e >> 1]));
        s[i] = p;
        dp[i] = p * (dp[i] - delta[e >> 1]);
      }
    }
    // dq = dS K * scale, complete: the sum runs over the resident keys
    float dqa[8] = {};
    plane_product<2 * KT>(dqa, dp, khi, klo, g, t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ch.row0 + t * kTile + rl + 8 * h;
      if (row < Lq) store_row(dq + (qrow0 + row) * kD, dqa, h, t4, scale);
    }
    // P and dS of the tile to shared memory, [query][key]
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (rl + 8 * h) * PS + 8 * n + 2 * t4;
        *reinterpret_cast<float2*>(pp + at) = make_float2(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]);
        *reinterpret_cast<float2*>(dsp + at) =
            make_float2(dp[4 * n + 2 * h], dp[4 * n + 2 * h + 1]);
      }
    __syncthreads();
    // the warp's units u: dv (P^T dout) or dk (dS^T q) of keys 16 (u / 2) ..
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = warp + kWarps * i;
      if (u < 2 * KT) {
        const bool is_dk = u & 1;
        const float* x = is_dk ? dsp : pp;
        const float* b = is_dk ? qt : dt;
#pragma unroll
        for (int hq = 0; hq < kTile; hq += kGroup) {   // a fresh fragment a half
          float xr[16];
          transposed(xr, x, PS, 16 * (u / 2), hq, g, t4);
          tf32::product<2, kGroup / 8>(acc[i], xr,
                                       [&](int j, int m, uint32_t(&bh2)[2], uint32_t(&bl2)[2]) {
                                         tile_rows(b, hq + 8 * j, m, g, t4, bh2, bl2);
                                       });
        }
      }
    }
  }
  cp_async_wait<0>();

  const size_t part = static_cast<size_t>(bh) * C + blockIdx.x;
  const size_t plane = static_cast<size_t>(gridDim.y) * C * KP * kD;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = warp + kWarps * i;
    if (u < 2 * KT) {
      float* dst = work + (u & 1) * plane + part * KP * kD;
#pragma unroll
      for (int h = 0; h < 2; ++h) store_row(dst + (16 * (u / 2) + g + 8 * h) * kD, acc[i], h, t4, 1.f);
    }
  }
}

// Shared memory of the short-queries kernel, in 4-byte words: the q and
// dout planes (hi, lo), the resident queries' lse in base 2 and delta, the
// dS^T plane of a key tile ([key][query], SS floats a row), the ring of
// (k, v) tiles, then the chunk's key terms.
template <int QT>
struct QueriesBwdPlan {
  static constexpr int QP = QT * 16, SS = QP + 4;
  static constexpr int plane = QP * kStride;
  static constexpr int lq2 = 4 * plane;
  static constexpr int delta = lq2 + QP;
  static constexpr int ds = delta + QP;
  static constexpr int stage = 2 * kTileFloats;
  static constexpr int ring = ds + kTile * SS;
  static constexpr int kadd = ring + kBwdStages * stage;
  static_assert(ring % 4 == 0, "16-byte stages");
};

// Block (chunk, bh), four warps. q and dout of the resident queries are
// held as planes, with their lse and delta; the chunk's 64-key tiles of k
// and v stream. Stores dk, dv of its keys and writes the chunk's partial dq
// of every resident query ([BH][C][QP][16]) to `work`.
template <int QT>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_short_queries_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ bias,
                                    const float* __restrict__ dout, const float* __restrict__ out,
                                    const float* __restrict__ lse, float* __restrict__ dk,
                                    float* __restrict__ dv, float* __restrict__ work, int Lq,
                                    int Lk, float scale, float scale2, int C) {
  using P = QueriesBwdPlan<QT>;
  constexpr int QP = P::QP, SS = P::SS, kUnits = (QT + kWarps - 1) / kWarps;
  extern __shared__ float4 smem_sst[];
  float* const base = reinterpret_cast<float*>(smem_sst);
  uint32_t* const qhi = reinterpret_cast<uint32_t*>(base);
  uint32_t* const qlo = qhi + P::plane;
  uint32_t* const dhi = qlo + P::plane;
  uint32_t* const dlo = dhi + P::plane;
  float* const lq2 = base + P::lq2;
  float* const delta = base + P::delta;
  float* const dsp = base + P::ds;   // dS^T, [key][query]
  float* const ring = base + P::ring;
  float* const kadd = base + P::kadd;
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lk);
  const size_t qrow0 = static_cast<size_t>(bh) * Lq, krow0 = static_cast<size_t>(bh) * Lk;
  const size_t c0 = (krow0 + ch.row0) * kD;

  const float* bb = bias == nullptr ? nullptr : bias + krow0;
  int any = 0;
  for (int j = threadIdx.x; j < ch.tiles * kTile; j += blockDim.x) {
    kadd[j] = ss::key_term(bb, ch.row0 + j, Lk, wg::kLog2e);
    any |= kadd[j] != -INFINITY;
  }
  const bool live = __syncthreads_or(any);
  const int tiles = live ? ch.tiles : 0;
  const auto issue = [&](int t) {
    if (t < tiles) {
      float* st = ring + t % kBwdStages * P::stage;
      const size_t at = c0 + static_cast<size_t>(t) * kTile * kD;
      load_tile(st, k + at, ch.rows - t * kTile);
      load_tile(st + kTileFloats, v + at, ch.rows - t * kTile);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kBwdStages - 1; ++t) issue(t);
  if (!live) {  // every key of the chunk is masked: zero dk and dv
    float4* dk4 = reinterpret_cast<float4*>(dk + c0);
    float4* dv4 = reinterpret_cast<float4*>(dv + c0);
    for (int i = threadIdx.x; i < ch.rows * kChunks; i += blockDim.x)
      dk4[i] = dv4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  split_resident(qhi, qlo, q + qrow0 * kD, Lq, QP);
  split_resident(dhi, dlo, dout + qrow0 * kD, Lq, QP);
  for (int i = threadIdx.x; i < QP; i += blockDim.x) {
    lq2[i] = ss::lse2_for_bwd(lse + qrow0, i, Lq);
    float x = 0.f;
    if (i < Lq) {
      const float4* d4 = reinterpret_cast<const float4*>(dout + (qrow0 + i) * kD);
      const float4* o4 = reinterpret_cast<const float4*>(out + (qrow0 + i) * kD);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 a = d4[c], b = o4[c];
        x = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, x))));
      }
    }
    delta[i] = x;
  }

  float dqa[kUnits][8] = {};
  const int kl = 16 * warp + g;  // the warp's keys of a tile: kl and kl + 8

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();   // tile t is in; no warp still reads tile t - 1's stage or dS^T
    issue(t + kBwdStages - 1);
    const float* kt = ring + t % kBwdStages * P::stage;
    const float* vt = kt + kTileFloats;
    // S^T and dP^T of the warp's 16 keys against every resident query
    float s[8 * QT], dp[8 * QT];
    {
      const Frag ka[2] = {tile_frag(kt + 16 * warp * kStride, 0, g, t4),
                          tile_frag(kt + 16 * warp * kStride, 1, g, t4)};
      plane_scores<2 * QT>(s, ka, qhi, qlo, g, t4);
      const Frag va[2] = {tile_frag(vt + 16 * warp * kStride, 0, g, t4),
                          tile_frag(vt + 16 * warp * kStride, 1, g, t4)};
      plane_scores<2 * QT>(dp, va, dhi, dlo, g, t4);
    }
    const float kr[2] = {kadd[t * kTile + kl], kadd[t * kTile + kl + 8]};
#pragma unroll
    for (int n = 0; n < 2 * QT; ++n) {
      // the queries 8 n + 2 t4 and + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lq2 + 8 * n + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        const float p = wg::exp2_fast(fmaf(s[i], scale2, kr[e >> 1] - (e & 1 ? l2.y : l2.x)));
        s[i] = p;
        dp[i] = p * (dp[i] - (e & 1 ? d2.y : d2.x));
      }
    }
    // dv = P^T dout and dk = dS^T q * scale of the warp's keys, complete
    float dva[8] = {}, dka[8] = {};
    plane_product<2 * QT>(dva, s, dhi, dlo, g, t4);
    plane_product<2 * QT>(dka, dp, qhi, qlo, g, t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = ch.row0 + t * kTile + kl + 8 * h;
      if (key < Lk) {
        store_row(dv + (krow0 + key) * kD, dva, h, t4, 1.f);
        store_row(dk + (krow0 + key) * kD, dka, h, t4, scale);
      }
    }
    // dS^T of the tile to shared memory, [key][query]
#pragma unroll
    for (int n = 0; n < 2 * QT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dsp + (kl + 8 * h) * SS + 8 * n + 2 * t4) =
            make_float2(dp[4 * n + 2 * h], dp[4 * n + 2 * h + 1]);
    __syncthreads();
    // the warp's units: partial dq of queries 16 u .. += dS k over the tile
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = warp + kWarps * i;
      if (u < QT) {
#pragma unroll
        for (int hk = 0; hk < kTile; hk += kGroup) {   // a fresh fragment a half
          float xr[16];
          transposed(xr, dsp, SS, 16 * u, hk, g, t4);
          tf32::product<2, kGroup / 8>(dqa[i], xr,
                                       [&](int j, int m, uint32_t(&bh2)[2], uint32_t(&bl2)[2]) {
                                         tile_rows(kt, hk + 8 * j, m, g, t4, bh2, bl2);
                                       });
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = work + (static_cast<size_t>(bh) * C + blockIdx.x) * QP * kD;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = warp + kWarps * i;
    if (u < QT)
#pragma unroll
      for (int h = 0; h < 2; ++h) store_row(dst + (16 * u + g + 8 * h) * kD, dqa[i], h, t4, 1.f);
  }
}

template <int KT>
cudaError_t bwd_short_keys(const BwdArgs& a) {
  using P = KeysBwdPlan<KT>;
  auto kernel = flash_bwd_short_keys_tf32_kernel<KT>;
  const size_t smem = 4 * (P::lrow + static_cast<size_t>(ss::max_chunk_rows(a.Lq, a.C)));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.C, a.BH), kWarps * 32, smem, a.stream>>>(a.q, a.k, a.v, a.bias, a.dout, a.out,
                                                           a.lse, a.dq, a.work, a.Lq, a.Lk,
                                                           a.scale, a.scale2, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.BH * a.Lk * kD;
  ss::flash_bwd_sum_kernel<float><<<dim3((n + 255) / 256, 2), 256, 0, a.stream>>>(
      a.work, a.dv, a.dk, 1.f, a.scale, a.BH, a.Lk, P::KP, a.C);
  return cudaGetLastError();
}

template <int QT>
cudaError_t bwd_short_queries(const BwdArgs& a) {
  using P = QueriesBwdPlan<QT>;
  auto kernel = flash_bwd_short_queries_tf32_kernel<QT>;
  const size_t smem = 4 * (P::kadd + static_cast<size_t>(ss::max_chunk_rows(a.Lk, a.C)));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.C, a.BH), kWarps * 32, smem, a.stream>>>(a.q, a.k, a.v, a.bias, a.dout, a.out,
                                                           a.lse, a.dk, a.dv, a.work, a.Lq, a.Lk,
                                                           a.scale, a.scale2, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.BH * a.Lq * kD;
  ss::flash_bwd_sum_kernel<float><<<dim3((n + 255) / 256, 1), 256, 0, a.stream>>>(
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

cudaError_t launch_bwd(int fam, const float* q, const float* k, const float* v, const float* bias,
                       const float* dout, const float* out, const float* lse, float* dq,
                       float* dk, float* dv, int BH, int Lq, int Lk, float scale, int chunks,
                       float* work, cudaStream_t stream) {
  if (out == nullptr || work == nullptr) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(out) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorMisalignedAddress;   // cp.async and float4 accesses of 16-byte chunks
  const BwdArgs a{q,  k,  v,  bias, dout,   out,   lse,   dq,   dk,
                  dv, BH, Lq, Lk,   chunks, scale, scale * wg::kLog2e, work, stream};
  if (fam == ss::kShortKeysTf32) {
    if (!ss::chunks_valid(Lq, chunks)) return cudaErrorInvalidValue;
    return kBwdShortKeys[ss::pad16(Lk) / 16 - 1](a);
  }
  if (fam != ss::kShortQueriesTf32 || !ss::chunks_valid(Lk, chunks)) return cudaErrorInvalidValue;
  return kBwdShortQueries[ss::pad16(Lq) / 16 - 1](a);
}

}  // namespace sst
}  // namespace mt
