// The ALiBi flash attention backward (K4b) at fp32 on Hopper's tensor cores:
// the 3xTF32 family, fp32 at head dimension 64 (alibi_tf32.cuh).
//
// Replaces: modaltune_tpu/ops/alibi_flash.py::_bwd_pallas and
// ::_bwd_pallas_ah (the Pallas TPU kernels _dq_kernel, _dkv_kernel and their
// all-heads variants) on TITAN's calls at fp32, where their dots run at
// Precision.HIGHEST.
//
// Computes, from the forward's out and lse, for every batch row b and head h:
//   vbar    = the mean of the valid keys' v rows (0 without one)
//   delta_i = dout_i.(out_i - vbar)          (fp32, made by the dq kernel)
//   P_ij  = exp(s_ij - lse_i)   (s the forward's scores; 0 for a masked key,
//                                a key past N or a row whose lse is NEG_INF)
//   dS_ij = P_ij (dout_i.(v_j - vbar) - delta_i)
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij dout_i
// in fp32, every product at fp32 accuracy. The plain oracle is
// ops/alibi_flash.py::alibi_attention_backward_reference.
//
// What bounds it on the H100: operations. At fp32 accuracy each of the five
// products is three TF32 products: 3 x 10 pairs D flop at 495 TFLOP/s, 22.0
// ms at TITAN's (3, 12, 16384, 64) with 12 % of the keys masked, where the
// CUDA-core kernels of alibi_attention_bwd.cu (with delta made in torch)
// read 778.89 ms on the card against 196.32 ms for autograd through
// scaled_dot_product_attention on the dense bias (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py). The kernels run seven products (q.k and dout.v in
// both) and the distance term of every pair twice.
//
// The design: the key-bias 3xTF32 backward's (flash_tf32_bwd.cu) at D = 64
// with the ALiBi term per score.
// * Three kernels without atomics, so two runs give the same bits: vbar (a
//   block a (b, h)); the dq kernel, whose block owns 64 query rows and
//   streams the batch row's live key tiles; the dk/dv kernel, launched after
//   it on the same stream, whose block owns 64 key rows and streams every
//   query tile. A block is four warps of 16 own rows; every thread loads its
//   share of the next tile with 16-byte cp.async (zero-filled past N) into
//   the other stage of a two-stage ring while the current one is multiplied.
// * delta and lse2: the dq kernel reads its rows' dout and out from device
//   memory (a quad a row, sixteen columns a thread) before its first stage
//   and writes delta and lse in base 2 (+1e30 for a dead row and past N) of
//   every query of its tile into the scratch; the dk/dv kernel streams them
//   with the queries' coordinates in each stage. No delta is made in torch.
// * dP - delta is taken as dout.(v - vbar) - dout.(out - vbar), the same
//   value for any vbar, since a live row's P sums to 1 (the key-bias 3xTF32
//   families take it so): where a plane's v rows lie close together, as on
//   an fp32 train step's inputs, 3xTF32's error of dout.v is about 2^-21 of
//   |dout| |v|, of dout.(v - vbar) only of |dout| |v - vbar|. Each thread
//   takes vbar off the v chunks it loaded itself once their cp.async group
//   is complete, so centering costs no barrier (rows past N become -vbar,
//   their P is 0).
// * P and dS are split into TF32 hi + lo in registers, and a stage is
//   multiplied in two halves of 32 keys (queries in the dk/dv kernel), each
//   product of dq, dk and dv summed in fresh fragments (the tensor cores
//   accumulate by truncation).
// * Masking without a branch: a key's term is 0 or -inf, a query's lse2 is
//   lse log2(e) or +1e30, so P is exactly 0 for every masked pair; the dq
//   kernel never loads a dead key tile, a dk/dv block whose key tile is dead
//   writes zeros.
// * Shared memory: two own tiles of 68-float rows, then two stages of two
//   tiles and four (dq) or five (dk/dv) planes: 106,496 and 107,008 bytes,
//   two blocks an SM.
#include "alibi_tf32.cuh"

namespace mt {
namespace atf {

template <int PLANES>
struct BwdSmem {
  static constexpr int kRing = 2 * kTileFloats;
  static constexpr int kPlanes = 2 * kTileFloats;   // in a stage
  static constexpr int kStageFloats = kPlanes + PLANES * kTile;
  static constexpr size_t bytes = sizeof(float) * (kRing + 2 * kStageFloats);
  static_assert(kStageFloats % 4 == 0, "16-byte stages");
  static_assert(2 * bytes <= 232448, "two blocks an SM");
};
using DqSmem = BwdSmem<4>;    // keys' y, x, is_cls, term
using DkvSmem = BwdSmem<5>;   // queries' y, x, is_cls, lse2, delta

// dq += dS k in one group of output columns, dv += P^T dout and dk += dS^T q
// in two (fewer registers beside the two accumulators).
constexpr int kDqProductGroups = 1;
constexpr int kDkvProductGroups = 2;

constexpr int kVbarGroups = 8;   // the vbar kernel's block: 8 row groups of 64 threads

// vbar of (b, h) = blockIdx.x: the mean of its valid keys' v rows (0
// without one), thread (g, c) summing column c over the rows g, g + 8, ...,
// the groups' sums added in order.
__global__ void __launch_bounds__(kVbarGroups * kD)
alibi_bwd_vbar_tf32_kernel(const float* __restrict__ v, const float* __restrict__ key_add,
                           float* __restrict__ vbar, int H, int N) {
  __shared__ float sums[kVbarGroups][kD];
  __shared__ int counts[kVbarGroups];
  const int c = threadIdx.x % kD, g = threadIdx.x / kD;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * N;
  const float* kadd_b = key_add + static_cast<size_t>(blockIdx.x / H) * tiles_of(N) * kTile;
  float sum = 0.f;
  int n = 0;
#pragma unroll 4
  for (int j = g; j < N; j += kVbarGroups)
    if (kadd_b[j] == 0.f) {
      sum += v[(row0 + j) * kD + c];
      ++n;
    }
  sums[g][c] = sum;
  if (c == 0) counts[g] = n;
  __syncthreads();
  if (g == 0) {
    float total = 0.f;
    int valid = 0;
    for (int i = 0; i < kVbarGroups; ++i) {
      total += sums[i][c];
      valid += counts[i];
    }
    vbar[static_cast<size_t>(blockIdx.x) * kD + c] = valid > 0 ? total / valid : 0.f;
  }
}

// v less vbar in the chunks of a tile that this thread's load_tile filled,
// once their cp.async group is complete (so no barrier comes before it).
__device__ __forceinline__ void center_tile(float* d, const float* vbar) {
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i, row = c / kChunks, ch = c % kChunks;
    float4* x = reinterpret_cast<float4*>(d + row * kStride + 4 * ch);
    const float4 m = __ldg(reinterpret_cast<const float4*>(vbar) + ch);
    const float4 y = *x;
    *x = make_float4(y.x - m.x, y.y - m.y, y.z - m.z, y.w - m.w);
  }
}

// dq, delta and lse2: the own rows are queries (their q and dout tiles stay
// in shared memory; lse2 and delta in registers); a stage is a live key
// tile's k and v with the keys' planes.
__global__ void __launch_bounds__(kThreads, 2)
alibi_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const wg::SideInputs side,
                         const float* __restrict__ slopes, const float* __restrict__ dout,
                         const float* __restrict__ out, const float* __restrict__ lse,
                         const float* __restrict__ vbar_all, float* __restrict__ delta_out,
                         float* __restrict__ lse2_out, float* __restrict__ dq, int H, int N,
                         float scale) {
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row0 = bh * N;
  const int n_tiles = tiles_of(N), NP = n_tiles * kTile;
  const size_t own_row0 = row0 + static_cast<size_t>(t0) * kTile;
  const int n_own = min(kTile, N - t0 * kTile);
  const float* kb = k + row0 * kD;
  const float* vb = v + row0 * kD;
  const float* planes_b = side.coords_t + static_cast<size_t>(b) * 3 * NP;
  const float* kadd_b = side.key_add + static_cast<size_t>(b) * NP;
  const int* live = side.tile_live + static_cast<size_t>(b) * n_tiles;
  const auto plane = [&](int p) { return p < 3 ? planes_b + p * NP : kadd_b; };
  const float* vbar = vbar_all + bh * kD;
  extern __shared__ float4 smem_atf[];
  float* own = reinterpret_cast<float*>(smem_atf);
  float* ring = own + DqSmem::kRing;
  load_tile(own, q + row0 * kD, N, t0);
  load_tile(own + kTileFloats, dout + row0 * kD, N, t0);
  int t = next_live(live, 0, n_tiles);
  if (t < n_tiles) {
    load_tile(ring, kb, N, t);
    load_tile(ring + kTileFloats, vb, N, t);
    load_planes<4>(ring + DqSmem::kPlanes, plane, t);
  }
  cp_async_commit();

  const wg::Lane ln;
  const Own mine(planes_b, NP, t0, ln);
  const float scale2 = scale * wg::kLog2e;
  const float nslope2 = -slopes[h] * wg::kLog2e;
  // delta = dout.(out - vbar) of the thread's two rows, a quad a row
  float delta[2], lse2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    const bool real = row < n_own;
    float sum = 0.f;
    if (real) {
      const size_t at = (own_row0 + row) * kD + ln.col0;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(dout + at + 8 * j);
        const float2 o = *reinterpret_cast<const float2*>(out + at + 8 * j);
        const float2 m = *reinterpret_cast<const float2*>(vbar + ln.col0 + 8 * j);
        sum = fmaf(a.x, o.x - m.x, fmaf(a.y, o.y - m.y, sum));
      }
    }
    delta[rr] = wg::quad_sum(sum);   // the whole warp shuffles
    const float l = real ? lse[own_row0 + row] : 0.f;
    lse2[rr] = real && l > kMaskThreshold ? l * wg::kLog2e : 1e30f;
    if (ln.col0 == 0) {   // every query of the tile, 0 and +1e30 past N
      const size_t at = bh * NP + static_cast<size_t>(t0) * kTile + row;
      delta_out[at] = delta[rr];
      lse2_out[at] = lse2[rr];
    }
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int stage = 0; t < n_tiles; stage ^= 1) {
    __syncthreads();   // no warp still reads the stage the next tile fills
    const int next = next_live(live, t + 1, n_tiles);
    if (next < n_tiles) {
      float* nst = ring + (stage ^ 1) * DqSmem::kStageFloats;
      load_tile(nst, kb, N, next);
      load_tile(nst + kTileFloats, vb, N, next);
      load_planes<4>(nst + DqSmem::kPlanes, plane, next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    float* st = ring + stage * DqSmem::kStageFloats;
    center_tile(st + kTileFloats, vbar);   // v - vbar
    __syncthreads();
#pragma unroll 1
    for (int hh = 0; hh < kTile; hh += kHalf) {   // keys [hh, hh + 32) of the tile
      const float* kh = st + hh * kStride;
      const float* pl = st + DqSmem::kPlanes + hh;
      float s[16], dp[16];
      scores(s, own, kh, ln);                                         // q k^T
      scores(dp, own + kTileFloats, st + kTileFloats + hh * kStride, ln);   // dout (v - vbar)^T
      logits(s, mine, pl, scale2, nslope2, ln,
             [&](int rr, int c) { return pl[3 * kTile + c] - lse2[rr]; });
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          s[i] = wg::exp2_fast(s[i]) * (dp[i] - delta[rr]);            // dS
          s[i + 1] = wg::exp2_fast(s[i + 1]) * (dp[i + 1] - delta[rr]);
        }
      product<kDqProductGroups>(acc, s, kh, ln);                      // dq += dS k
    }
    t = next;
  }
  cp_async_wait<0>();
  store_rows(dq + own_row0 * kD, acc, n_own, scale, ln);
}

// dk/dv: the own rows are keys (their k and v - vbar tiles stay in shared
// memory, their key terms in registers); a stage is a query tile's q and
// dout with the queries' planes, lse2 and delta. The score tiles are
// computed transposed, S^T = k q^T and dP^T = (v - vbar) dout^T, and P^T and
// dS^T feed dv += P^T dout and dk += dS^T q from registers.
__global__ void __launch_bounds__(kThreads, 2)
alibi_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const wg::SideInputs side,
                          const float* __restrict__ slopes, const float* __restrict__ dout,
                          const float* __restrict__ vbar_all, const float* __restrict__ delta,
                          const float* __restrict__ lse2_all, float* __restrict__ dk,
                          float* __restrict__ dv, int H, int N, float scale) {
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row0 = bh * N;
  const int n_tiles = tiles_of(N), NP = n_tiles * kTile;
  const size_t own_row0 = row0 + static_cast<size_t>(t0) * kTile;
  const int n_own = min(kTile, N - t0 * kTile);
  if (__ldg(side.tile_live + static_cast<size_t>(b) * n_tiles + t0) == 0) {
    zero_rows(dk + own_row0 * kD, n_own);   // every own key masked
    zero_rows(dv + own_row0 * kD, n_own);
    return;
  }
  const float* qb = q + row0 * kD;
  const float* db = dout + row0 * kD;
  const float* planes_b = side.coords_t + static_cast<size_t>(b) * 3 * NP;
  const float* lse2_b = lse2_all + bh * NP;
  const float* delta_b = delta + bh * NP;
  const auto plane = [&](int p) {
    return p < 3 ? planes_b + p * NP : (p == 3 ? lse2_b : delta_b);
  };
  extern __shared__ float4 smem_atf[];
  float* own = reinterpret_cast<float*>(smem_atf);
  float* ring = own + DkvSmem::kRing;
  load_tile(own, k + row0 * kD, N, t0);
  load_tile(own + kTileFloats, v + row0 * kD, N, t0);
  load_tile(ring, qb, N, 0);
  load_tile(ring + kTileFloats, db, N, 0);
  load_planes<5>(ring + DkvSmem::kPlanes, plane, 0);
  cp_async_commit();

  const wg::Lane ln;
  const Own mine(planes_b, NP, t0, ln);
  const float scale2 = scale * wg::kLog2e;
  const float nslope2 = -slopes[h] * wg::kLog2e;
  float kterm[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kterm[rr] = side.key_add[static_cast<size_t>(b) * NP + t0 * kTile + ln.row0 + 8 * rr];
  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int t = 0, stage = 0; t < n_tiles; ++t, stage ^= 1) {
    __syncthreads();   // no warp still reads the stage the next tile fills
    const bool more = t + 1 < n_tiles;
    if (more) {
      float* nst = ring + (stage ^ 1) * DkvSmem::kStageFloats;
      load_tile(nst, qb, N, t + 1);
      load_tile(nst + kTileFloats, db, N, t + 1);
      load_planes<5>(nst + DkvSmem::kPlanes, plane, t + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    if (t == 0)   // the own tiles came in the first group
      center_tile(own + kTileFloats, vbar_all + bh * kD);   // v - vbar
    __syncthreads();
    const float* st = ring + stage * DkvSmem::kStageFloats;
#pragma unroll 1
    for (int hh = 0; hh < kTile; hh += kHalf) {   // queries [hh, hh + 32) of the tile
      const float* qh = st + hh * kStride;
      const float* dh = st + kTileFloats + hh * kStride;
      const float* pl = st + DkvSmem::kPlanes + hh;
      float s[16], dp[16];
      scores(s, own, qh, ln);                   // k q^T
      scores(dp, own + kTileFloats, dh, ln);    // (v - vbar) dout^T
      logits(s, mine, pl, scale2, nslope2, ln,
             [&](int rr, int c) { return kterm[rr] - pl[3 * kTile + c]; });
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int c = 8 * j + ln.col0;
        const float2 dl = *reinterpret_cast<const float2*>(pl + 4 * kTile + c);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          const float p0 = wg::exp2_fast(s[i]), p1 = wg::exp2_fast(s[i + 1]);
          dp[i] = p0 * (dp[i] - dl.x);           // dS^T
          dp[i + 1] = p1 * (dp[i + 1] - dl.y);
          s[i] = p0;                             // P^T
          s[i + 1] = p1;
        }
      }
      product<kDkvProductGroups>(acc_dv, s, dh, ln);    // dv += P^T dout
      product<kDkvProductGroups>(acc_dk, dp, qh, ln);   // dk += dS^T q
    }
  }
  cp_async_wait<0>();
  store_rows(dk + own_row0 * kD, acc_dk, n_own, scale, ln);
  store_rows(dv + own_row0 * kD, acc_dv, n_own, 1.f, ln);
}

}  // namespace atf

cudaError_t launch_alibi_tf32_bwd(const float* q, const float* k, const float* v,
                                  const wg::SideInputs& side, const float* slopes,
                                  const float* dout, const float* out, const float* lse,
                                  float* work, float* dq, float* dk, float* dv, int B, int H,
                                  int N, float scale, cudaStream_t stream) {
  const void* rows[11] = {q, k, v, dout, out, work, dq, dk, dv, side.coords_t, side.key_add};
  for (const void* p : rows)   // 16-byte loads and stores
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  const int BH = B * H, NP = atf::tiles_of(N) * atf::kTile;
  float* vbar = work;                                           // (B H, 64), then
  float* delta = vbar + static_cast<size_t>(BH) * atf::kD;      // (B H, NP), then
  float* lse2 = delta + static_cast<size_t>(BH) * NP;           // (B H, NP)
  auto kq = atf::alibi_bwd_dq_tf32_kernel;
  auto kkv = atf::alibi_bwd_dkv_tf32_kernel;
  cudaError_t err = allow_smem(kq, atf::DqSmem::bytes);
  if (err == cudaSuccess) err = allow_smem(kkv, atf::DkvSmem::bytes);
  if (err != cudaSuccess) return err;
  atf::alibi_bwd_vbar_tf32_kernel<<<BH, atf::kVbarGroups * atf::kD, 0, stream>>>(
      v, side.key_add, vbar, H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(atf::tiles_of(N), H, B);
  kq<<<grid, atf::kThreads, atf::DqSmem::bytes, stream>>>(q, k, v, side, slopes, dout, out, lse,
                                                          vbar, delta, lse2, dq, H, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid, atf::kThreads, atf::DkvSmem::bytes, stream>>>(q, k, v, side, slopes, dout, vbar,
                                                            delta, lse2, dk, dv, H, N, scale);
  return cudaGetLastError();
}

}  // namespace mt
