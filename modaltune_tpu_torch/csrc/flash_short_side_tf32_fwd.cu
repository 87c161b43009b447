// Flash attention forward with an additive key bias (K2f), the short-side
// family at fp32: fp32 at head dimension 16 with one side of at most 128
// rows (flash_short_side_tf32.cuh has the frame), every adapter attention
// under an fp32 backbone (the CLI's --bf16 0). flash_attention_fwd.cu's
// entry point picks it.
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _fwd_pallas) at fp32, where its dots run at
// Precision.HIGHEST (exact fp32), for the adapter's attentions.
//
// What bounds it on the H100: bytes. At the adapter's long shapes (36 x
// 10,239 rows against 65) a call moves about 49 MB, 0.0146 ms at
// 3.35 TB/s; its two products at fp32 accuracy are three TF32 products
// each, 0.009 ms at 495 TFLOP/s. The CUDA-core kernel of
// flash_attention_fwd.cu, which served these calls before, read 0.24 and
// 1.17 card ms at the Injector and the Extractor, with 72 blocks for 132
// SMs at the Extractor (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).
//
// What the design does about it: the bf16 family's plan, the 65-row side
// resident in every block (split once into TF32 hi and lo planes) and the
// long side split into C chunks of 64-row tiles streamed once by cp.async,
// so BH x C blocks fill the card whatever side is long.
// * Short keys (Injector, prompt self-attention): a warp holds the scores
//   of 16 query rows against all keys in registers, so the softmax is one
//   pass and out and lse are stored directly; O = P v sums 32 keys a fresh
//   fragment.
// * Short queries (Extractor): a warp runs the online softmax of 16
//   resident query rows (their q split into registers once) over its
//   chunk's keys, O += P v in two fresh halves of 32 keys a tile, and
//   writes the partial (acc, m, l) in fp32; flash_fwd_combine_kernel<float>
//   merges the C partials of each row in chunk order. A chunk whose keys are
//   all masked skips its tiles.
#include "flash_short_side_tf32.cuh"

namespace mt {
namespace sst {

constexpr int kFwdStages = 3;   // tiles in flight: the one multiplied and two ahead

struct FwdArgs {
  const float *q, *k, *v;
  const float* bias;
  float* out;
  float* lse;
  int BH, Lq, Lk, C;
  float scale2;  // softmax scale * log2(e)
  float* work;
  cudaStream_t stream;
};

// Shared memory of the short-keys kernel, in 4-byte words: the K and V
// planes (hi, lo), the key terms, then the ring of q tiles.
template <int KT>
struct KeysFwdPlan {
  static constexpr int KP = KT * 16;
  static constexpr int plane = KP * kStride;
  static constexpr int kadd = 4 * plane;
  static constexpr int ring = kadd + KP;
  static constexpr size_t bytes = 4 * (ring + kFwdStages * kTileFloats);
  static_assert(ring % 4 == 0, "16-byte stages");
};

// Block (chunk, bh), four warps; warp w owns rows 16w .. 16w + 15 of each
// 64-row query tile.
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_short_keys_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ bias,
                                 float* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                                 float scale2, int C) {
  using P = KeysFwdPlan<KT>;
  constexpr int KP = P::KP;
  extern __shared__ float4 smem_sst[];
  float* const base = reinterpret_cast<float*>(smem_sst);
  uint32_t* const khi = reinterpret_cast<uint32_t*>(base);
  uint32_t* const klo = khi + P::plane;
  uint32_t* const vhi = klo + P::plane;
  uint32_t* const vlo = vhi + P::plane;
  float* const kadd = base + P::kadd;
  float* const ring = base + P::ring;
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lq);
  const size_t qrow0 = static_cast<size_t>(bh) * Lq;
  const float* const qc = q + (qrow0 + ch.row0) * kD;
  const auto issue = [&](int t) {   // tile t of the chunk into its stage
    if (t < ch.tiles)
      load_tile(ring + t % kFwdStages * kTileFloats, qc + static_cast<size_t>(t) * kTile * kD,
                ch.rows - t * kTile);
    cp_async_commit();
  };
  for (int t = 0; t < kFwdStages - 1; ++t) issue(t);

  const size_t krow0 = static_cast<size_t>(bh) * Lk;
  split_resident(khi, klo, k + krow0 * kD, Lk, KP);
  split_resident(vhi, vlo, v + krow0 * kD, Lk, KP);
  const float* bb = bias == nullptr ? nullptr : bias + krow0;
  for (int j = threadIdx.x; j < KP; j += blockDim.x) kadd[j] = ss::key_term(bb, j, Lk, wg::kLog2e);

  for (int t = 0; t < ch.tiles; ++t) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();   // tile t is in; no warp still reads the stage issue() refills
    issue(t + kFwdStages - 1);
    const float* qt = ring + t % kFwdStages * kTileFloats + 16 * warp * kStride;
    float s[8 * KT];   // s[4 n + 2 h + e]: row g + 8 h, key 8 n + 2 t4 + e
    {
      const Frag qa[2] = {tile_frag(qt, 0, g, t4), tile_frag(qt, 1, g, t4)};
      plane_scores<2 * KT>(s, qa, khi, klo, g, t4);
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      const float2 ka = *reinterpret_cast<const float2*>(kadd + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * n + e] = fmaf(s[4 * n + e], scale2, e & 1 ? ka.y : ka.x);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = wg::quad_max(mx[h]);
#pragma unroll
    for (int i = 0; i < 8 * KT; ++i) {
      s[i] = wg::exp2_fast(s[i] - mx[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
    float o[8] = {};
    plane_product<2 * KT>(o, s, vhi, vlo, g, t4);   // O = P v
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lh = wg::quad_sum(l[h]);
      const int row = ch.row0 + t * kTile + 16 * warp + g + 8 * h;
      if (row < Lq) {
        store_row(out + (qrow0 + row) * kD, o, h, t4, lh > 0.f ? 1.f / lh : 0.f);
        if (t4 == 0) lse[qrow0 + row] = lh > 0.f ? (mx[h] + log2f(lh)) * wg::kLn2 : kNegInf;
      }
    }
  }
  cp_async_wait<0>();
}

// Shared memory of the short-queries kernel, in floats: the ring of k and v
// tiles, then the chunk's key terms.
struct QueriesFwdPlan {
  static constexpr int stage = 2 * kTileFloats;
  static constexpr int kadd = kFwdStages * stage;
};

// Block (chunk, bh), QT warps; warp w owns resident query rows 16w ..
// 16w + 15 (its q split into TF32 hi and lo registers, zero past Lq) and
// streams the chunk's 64-key tiles of k and v. Writes the partial (acc, m,
// l) of every resident row to `work`: acc [BH][C][QP][16], then m and l
// [BH][C][QP] each.
template <int QT>
__global__ void __launch_bounds__(QT * 32)
flash_fwd_short_queries_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ bias,
                                    float* __restrict__ work, int Lq, int Lk, float scale2,
                                    int C) {
  constexpr int QP = QT * 16;
  extern __shared__ float4 smem_sst[];
  float* const ring = reinterpret_cast<float*>(smem_sst);
  float* const kadd = ring + QueriesFwdPlan::kadd;
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lk);
  const size_t krow0 = static_cast<size_t>(bh) * Lk;
  const size_t c0 = (krow0 + ch.row0) * kD;

  const float* bb = bias == nullptr ? nullptr : bias + krow0;
  int any = 0;
  for (int j = threadIdx.x; j < ch.tiles * kTile; j += blockDim.x) {
    kadd[j] = ss::key_term(bb, ch.row0 + j, Lk, wg::kLog2e);
    any |= kadd[j] != -INFINITY;
  }
  const int tiles = __syncthreads_or(any) ? ch.tiles : 0;  // a dead chunk skips its tiles
  const auto issue = [&](int t) {
    if (t < tiles) {
      float* st = ring + t % kFwdStages * QueriesFwdPlan::stage;
      const size_t at = c0 + static_cast<size_t>(t) * kTile * kD;
      load_tile(st, k + at, ch.rows - t * kTile);
      load_tile(st + kTileFloats, v + at, ch.rows - t * kTile);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kFwdStages - 1; ++t) issue(t);

  const float* qb = q + static_cast<size_t>(bh) * Lq * kD;
  const int r0 = 16 * warp + g;
  const auto qval = [&](int r, int c) { return r < Lq ? qb[r * kD + c] : 0.f; };
  Frag qa[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    split(qval(r0, 8 * kk + t4), qa[kk].hi[0], qa[kk].lo[0]);
    split(qval(r0 + 8, 8 * kk + t4), qa[kk].hi[1], qa[kk].lo[1]);
    split(qval(r0, 8 * kk + t4 + 4), qa[kk].hi[2], qa[kk].lo[2]);
    split(qval(r0 + 8, 8 * kk + t4 + 4), qa[kk].hi[3], qa[kk].lo[3]);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[8] = {};

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();
    issue(t + kFwdStages - 1);
    const float* kt = ring + t % kFwdStages * QueriesFwdPlan::stage;
    const float* vt = kt + kTileFloats;
    float s[32];   // s[4 n + 2 h + e]: row g + 8 h, key 8 n + 2 t4 + e of the tile
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = s[4 * n + 1] = s[4 * n + 2] = s[4 * n + 3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bh2[2], bl2[2];
        tile_cols(kt, 8 * n, kk, g, t4, bh2, bl2);
        mma3(s + 4 * n, qa[kk].hi, qa[kk].lo, bh2, bl2);
      }
    }
    float mn[2] = {m[0], m[1]};
    const float* kterm = kadd + t * kTile + 2 * t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ka = *reinterpret_cast<const float2*>(kterm + 8 * n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * n + e] = fmaf(s[4 * n + e], scale2, e & 1 ? ka.y : ka.x);
        mn[e >> 1] = fmaxf(mn[e >> 1], s[4 * n + e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mn[h] = wg::quad_max(mn[h]);
      corr[h] = wg::exp2_fast(m[h] - mn[h]);
      m[h] = mn[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = wg::exp2_fast(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int hk = 0; hk < kTile; hk += kGroup)   // O += P v, a fresh fragment a half
      tf32::product<2, kGroup / 8>(o, s + hk / 2,
                                   [&](int j, int mm, uint32_t(&bh2)[2], uint32_t(&bl2)[2]) {
                                     tile_rows(vt, hk + 8 * j, mm, g, t4, bh2, bl2);
                                   });
  }
  cp_async_wait<0>();

  const size_t part = static_cast<size_t>(bh) * C + blockIdx.x;
  const size_t planes = static_cast<size_t>(gridDim.y) * C * QP;
  float* acc = work + part * QP * kD;
  float* ms = work + planes * kD + part * QP;
  float* ls = ms + planes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    store_row(acc + row * kD, o, h, t4, 1.f);
    const float lh = wg::quad_sum(l[h]);
    if (t4 == 0) {
      ms[row] = m[h];
      ls[row] = lh;
    }
  }
}

template <int KT>
cudaError_t fwd_short_keys(const FwdArgs& a) {
  auto kernel = flash_fwd_short_keys_tf32_kernel<KT>;
  cudaError_t err = allow_smem(kernel, KeysFwdPlan<KT>::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.C, a.BH), kWarps * 32, KeysFwdPlan<KT>::bytes, a.stream>>>(
      a.q, a.k, a.v, a.bias, a.out, a.lse, a.Lq, a.Lk, a.scale2, a.C);
  return cudaGetLastError();
}

template <int QT>
cudaError_t fwd_short_queries(const FwdArgs& a) {
  auto kernel = flash_fwd_short_queries_tf32_kernel<QT>;
  const size_t smem =
      4 * (QueriesFwdPlan::kadd + static_cast<size_t>(ss::max_chunk_rows(a.Lk, a.C)));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.C, a.BH), QT * 32, smem, a.stream>>>(a.q, a.k, a.v, a.bias, a.work, a.Lq, a.Lk,
                                                       a.scale2, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.BH * a.Lq * kD;
  ss::flash_fwd_combine_kernel<float><<<(n + 255) / 256, 256, 0, a.stream>>>(
      a.work, a.out, a.lse, a.BH, a.Lq, QT * 16, a.C);
  return cudaGetLastError();
}

using FwdFn = cudaError_t (*)(const FwdArgs&);
constexpr FwdFn kFwdShortKeys[8] = {fwd_short_keys<1>, fwd_short_keys<2>, fwd_short_keys<3>,
                                    fwd_short_keys<4>, fwd_short_keys<5>, fwd_short_keys<6>,
                                    fwd_short_keys<7>, fwd_short_keys<8>};
constexpr FwdFn kFwdShortQueries[8] = {
    fwd_short_queries<1>, fwd_short_queries<2>, fwd_short_queries<3>, fwd_short_queries<4>,
    fwd_short_queries<5>, fwd_short_queries<6>, fwd_short_queries<7>, fwd_short_queries<8>};

cudaError_t launch_fwd(int fam, const float* q, const float* k, const float* v, const float* bias,
                       float* out, float* lse, int BH, int Lq, int Lk, float scale, int chunks,
                       float* work, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorMisalignedAddress;   // cp.async and float4 loads read 16-byte chunks
  const FwdArgs a{q, k, v, bias, out, lse, BH, Lq, Lk, chunks, scale * wg::kLog2e, work, stream};
  if (fam == ss::kShortKeysTf32) {
    if (!ss::chunks_valid(Lq, chunks)) return cudaErrorInvalidValue;
    return kFwdShortKeys[ss::pad16(Lk) / 16 - 1](a);
  }
  if (fam != ss::kShortQueriesTf32 || !ss::chunks_valid(Lk, chunks) || work == nullptr)
    return cudaErrorInvalidValue;
  return kFwdShortQueries[ss::pad16(Lq) / 16 - 1](a);
}

}  // namespace sst
}  // namespace mt
