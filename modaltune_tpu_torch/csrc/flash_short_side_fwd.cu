// Flash attention forward with an additive key bias (K2f), the short-side
// family: bf16 at head dimension 16 with one side of at most 128 rows
// (flash_short_side.cuh has the frame). flash_attention_fwd.cu's entry point
// picks it; fp32 at these shapes runs flash_short_side_tf32_fwd.cu, the rest
// that file's CUDA-core kernels.
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _fwd_pallas), for the adapter's attentions.
//
// What bounds it on the H100: bytes. At the adapter's long shapes (36 x
// 10,239 or 16,383 rows against 65) a call moves 25-40 MB and does about
// 1 GFLOP, so the floor is 8-12 us of HBM time; the CUDA-core kernels took
// 40-160 times that, with 72 blocks for 132 SMs at the Extractor shape.
//
// What the design does about it: the 65-row side is resident in every block
// and the long side is split into C chunks of 64-row tiles streamed once
// through a 4-stage ring of bulk copies, so BH x C blocks fill the card
// whatever side is long. Products are mma.sync on the tensor cores.
// * Short keys (Injector, prompt self-attention): a warp holds the scores of
//   16 query rows against all keys in registers, so the softmax is one pass
//   and out and lse are stored directly.
// * Short queries (Extractor): a warp runs the online softmax of 16 resident
//   query rows over its chunk's keys and writes the partial (acc, m, l) in
//   fp32; flash_fwd_combine_kernel merges the C partials of each row in chunk
//   order. A chunk whose keys are all masked skips its tiles.
#include "flash_short_side.cuh"

namespace mt {
namespace ss {

struct FwdArgs {
  const bf16 *q, *k, *v;
  const float* bias;
  bf16* out;
  float* lse;
  int BH, Lq, Lk, C;
  float scale2;  // softmax scale * log2(e)
  float* work;
  cudaStream_t stream;
};

// Block (chunk, bh), four warps; warp w owns rows 16w .. 16w + 15 of each
// 64-row query tile. K, V (KT * 16 rows, zero past Lk) and the key terms
// (-inf past Lk) are resident.
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_short_keys_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                            float scale2, int C) {
  constexpr int KP = KT * 16;
  __shared__ __align__(128) bf16 ring_tiles[Ring<1>::kBytes / 2];
  __shared__ __align__(16) unsigned char kres[KP * kResStride];
  __shared__ __align__(16) unsigned char vres[KP * kResStride];
  __shared__ __align__(16) float kadd[KP];
  __shared__ uint64_t full[kStages];
  const Ring<1> ring{ring_tiles, full};
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lq);
  const size_t qrow0 = static_cast<size_t>(bh) * Lq;
  const bf16* const src[1] = {q + qrow0 * kD};

  load_resident(kres, k + static_cast<size_t>(bh) * Lk * kD, Lk, KP);
  load_resident(vres, v + static_cast<size_t>(bh) * Lk * kD, Lk, KP);
  const float* bb = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh) * Lk;
  for (int j = threadIdx.x; j < KP; j += blockDim.x) kadd[j] = key_term(bb, j, Lk, wg::kLog2e);
  ring.init();
  if (threadIdx.x == 0)
    for (int t = 0; t < min(kStages, ch.tiles); ++t)
      ring.issue(t, src, ch.row0 + t * kTile, min(kTile, ch.rows - t * kTile));
  const uint32_t kaddr = wg::smem_u32(kres), vaddr = wg::smem_u32(vres);

  for (int t = 0; t < ch.tiles; ++t) {
    ring.wait(t);
    uint32_t a[4];
    ldsm(a, rows_first(ring.addr(t, 0), kRowBytes, 16 * warp, 0));
    float s[2 * KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t b[4];
      ldsm(b, cols_first(kaddr, kResStride, 16 * j, 0));
      zero(s[2 * j]);
      zero(s[2 * j + 1]);
      mma(s[2 * j], a, b[0], b[1]);
      mma(s[2 * j + 1], a, b[2], b[3]);
    }
    // s[n][e]: row g + 8 (e / 2), key 8 n + 2 t4 + e % 2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      const float2 ka = *reinterpret_cast<const float2*>(kadd + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fmaf(s[n][e], scale2, e & 1 ? ka.y : ka.x);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = wg::quad_max(mx[h]);
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = wg::exp2_fast(s[n][e] - mx[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    float o[2][4];
    zero(o[0]);
    zero(o[1]);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t ph[4], pl[4], b[4];
      split_a(ph, pl, s[2 * j], s[2 * j + 1]);
      ldsm_t(b, rows_first(vaddr, kResStride, 16 * j, 0));
      mma2(o[0], ph, pl, b[0], b[1]);
      mma2(o[1], ph, pl, b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lh = wg::quad_sum(l[h]);
      const int row = ch.row0 + t * kTile + 16 * warp + g + 8 * h;
      if (row < Lq) {
        const float inv = lh > 0.f ? 1.f / lh : 0.f;
        uint32_t* o32 = reinterpret_cast<uint32_t*>(out + (qrow0 + row) * kD);
        o32[t4] = wg::pack_bf16(o[0][2 * h] * inv, o[0][2 * h + 1] * inv);
        o32[4 + t4] = wg::pack_bf16(o[1][2 * h] * inv, o[1][2 * h + 1] * inv);
        if (t4 == 0) lse[qrow0 + row] = lh > 0.f ? (mx[h] + log2f(lh)) * wg::kLn2 : kNegInf;
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (threadIdx.x == 0 && t + kStages < ch.tiles)
      ring.issue(t + kStages, src, ch.row0 + (t + kStages) * kTile,
                 min(kTile, ch.rows - (t + kStages) * kTile));
  }
}

// Block (chunk, bh), QT warps; warp w owns resident query rows 16w .. 16w + 15
// (its Q fragment in registers, zero past Lq) and streams the chunk's 64-key
// tiles of K and V. Writes the partial (acc, m, l) of every resident row to
// `work`: acc [BH][C][QP][16], then m and l [BH][C][QP] each.
template <int QT>
__global__ void __launch_bounds__(QT * 32)
flash_fwd_short_queries_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ bias,
                               float* __restrict__ work, int Lq, int Lk, float scale2, int C) {
  constexpr int QP = QT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring<2> ring{reinterpret_cast<bf16*>(smem),
                     reinterpret_cast<uint64_t*>(smem + Ring<2>::kBytes)};
  float* kadd = reinterpret_cast<float*>(smem + Ring<2>::kBytes + kStages * 8);
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Chunk ch(blockIdx.x, C, Lk);
  const size_t krow0 = static_cast<size_t>(bh) * Lk;
  const bf16* const src[2] = {k + krow0 * kD, v + krow0 * kD};

  const float* bb = bias == nullptr ? nullptr : bias + krow0;
  int any = 0;
  for (int j = threadIdx.x; j < ch.tiles * kTile; j += blockDim.x) {
    kadd[j] = key_term(bb, ch.row0 + j, Lk, wg::kLog2e);
    any |= kadd[j] != -INFINITY;
  }
  ring.init();
  const int tiles = __syncthreads_or(any) ? ch.tiles : 0;  // a dead chunk skips its tiles
  if (threadIdx.x == 0)
    for (int t = 0; t < min(kStages, tiles); ++t)
      ring.issue(t, src, ch.row0 + t * kTile, min(kTile, ch.rows - t * kTile));

  const bf16* qb = q + static_cast<size_t>(bh) * Lq * kD;
  const auto qword = [&](int r, int c) {
    return r < Lq ? *reinterpret_cast<const uint32_t*>(qb + r * kD + c) : 0u;
  };
  const int r0 = 16 * warp + g;
  const uint32_t a[4] = {qword(r0, 2 * t4), qword(r0 + 8, 2 * t4), qword(r0, 2 * t4 + 8),
                         qword(r0 + 8, 2 * t4 + 8)};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[2][4];
  zero(o[0]);
  zero(o[1]);

  for (int t = 0; t < tiles; ++t) {
    ring.wait(t);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      ldsm(b, cols_first(ring.addr(t, 0), kRowBytes, 16 * j, 0));
      zero(s[2 * j]);
      zero(s[2 * j + 1]);
      mma(s[2 * j], a, b[0], b[1]);
      mma(s[2 * j + 1], a, b[2], b[3]);
    }
    float mn[2] = {m[0], m[1]};
    const float* kt = kadd + t * kTile + 2 * t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ka = *reinterpret_cast<const float2*>(kt + 8 * n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fmaf(s[n][e], scale2, e & 1 ? ka.y : ka.x);
        mn[e >> 1] = fmaxf(mn[e >> 1], s[n][e]);
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
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = wg::exp2_fast(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[0][e] *= corr[e >> 1];
      o[1][e] *= corr[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ph[4], pl[4], b[4];
      split_a(ph, pl, s[2 * j], s[2 * j + 1]);
      ldsm_t(b, rows_first(ring.addr(t, 1), kRowBytes, 16 * j, 0));
      mma2(o[0], ph, pl, b[0], b[1]);
      mma2(o[1], ph, pl, b[2], b[3]);
    }
    __syncthreads();
    if (threadIdx.x == 0 && t + kStages < tiles)
      ring.issue(t + kStages, src, ch.row0 + (t + kStages) * kTile,
                 min(kTile, ch.rows - (t + kStages) * kTile));
  }

  const size_t part = static_cast<size_t>(bh) * C + blockIdx.x;
  const size_t planes = static_cast<size_t>(gridDim.y) * C * QP;
  float* acc = work + part * QP * kD;
  float* ms = work + planes * kD + part * QP;
  float* ls = ms + planes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    float2* a2 = reinterpret_cast<float2*>(acc + row * kD);
    a2[t4] = make_float2(o[0][2 * h], o[0][2 * h + 1]);
    a2[4 + t4] = make_float2(o[1][2 * h], o[1][2 * h + 1]);
    const float lh = wg::quad_sum(l[h]);
    if (t4 == 0) {
      ms[row] = m[h];
      ls[row] = lh;
    }
  }
}

template <int KT>
cudaError_t fwd_short_keys(const FwdArgs& a) {
  flash_fwd_short_keys_kernel<KT><<<dim3(a.C, a.BH), kWarps * 32, 0, a.stream>>>(
      a.q, a.k, a.v, a.bias, a.out, a.lse, a.Lq, a.Lk, a.scale2, a.C);
  return cudaGetLastError();
}

template <int QT>
cudaError_t fwd_short_queries(const FwdArgs& a) {
  auto kernel = flash_fwd_short_queries_kernel<QT>;
  const size_t smem = Ring<2>::kBytes + kStages * 8 + max_chunk_rows(a.Lk, a.C) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.C, a.BH), QT * 32, smem, a.stream>>>(a.q, a.k, a.v, a.bias, a.work, a.Lq, a.Lk,
                                                       a.scale2, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.BH * a.Lq * kD;
  flash_fwd_combine_kernel<bf16><<<(n + 255) / 256, 256, 0, a.stream>>>(a.work, a.out, a.lse, a.BH,
                                                                        a.Lq, QT * 16, a.C);
  return cudaGetLastError();
}

using FwdFn = cudaError_t (*)(const FwdArgs&);
constexpr FwdFn kFwdShortKeys[8] = {fwd_short_keys<1>, fwd_short_keys<2>, fwd_short_keys<3>,
                                    fwd_short_keys<4>, fwd_short_keys<5>, fwd_short_keys<6>,
                                    fwd_short_keys<7>, fwd_short_keys<8>};
constexpr FwdFn kFwdShortQueries[8] = {
    fwd_short_queries<1>, fwd_short_queries<2>, fwd_short_queries<3>, fwd_short_queries<4>,
    fwd_short_queries<5>, fwd_short_queries<6>, fwd_short_queries<7>, fwd_short_queries<8>};

cudaError_t launch_fwd(int fam, const bf16* q, const bf16* k, const bf16* v, const float* bias,
                       bf16* out, float* lse, int BH, int Lq, int Lk, float scale, int chunks,
                       float* work, cudaStream_t stream) {
  const FwdArgs a{q, k, v, bias, out, lse, BH, Lq, Lk, chunks, scale * wg::kLog2e, work, stream};
  if (fam == kShortKeys) {
    if (!chunks_valid(Lq, chunks)) return cudaErrorInvalidValue;
    return kFwdShortKeys[pad16(Lk) / 16 - 1](a);
  }
  if (fam != kShortQueries || !chunks_valid(Lk, chunks) || work == nullptr)
    return cudaErrorInvalidValue;
  return kFwdShortQueries[pad16(Lq) / 16 - 1](a);
}

}  // namespace ss
}  // namespace mt
