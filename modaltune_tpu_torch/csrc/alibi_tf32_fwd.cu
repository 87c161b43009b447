// The ALiBi flash attention forward (K4f) at fp32 on Hopper's tensor cores:
// the 3xTF32 family, fp32 at head dimension 64 (alibi_tf32.cuh).
//
// Replaces: modaltune_tpu/ops/alibi_flash.py::_fwd_pallas and
// ::_fwd_pallas_ah (the Pallas TPU kernels _fwd_kernel and _fwd_kernel_ah)
// on TITAN's calls at fp32, where their dots run at Precision.HIGHEST.
//
// Computes, for every batch row b, head h and query i:
//   s_j  = (q_i . k_j) * scale - slope_h * ||c_i - c_j|| * (1 - cls_i)(1 - cls_j)
//          (a key that is masked or past N gets exactly zero weight)
//   out  = sum_j softmax(s)_j v_j,   lse = log sum_j exp(s_j)
// (NEG_INF and out 0 when every key of the batch row is masked) in fp32,
// every product at fp32 accuracy. The plain oracle is
// ops/alibi_flash.py::alibi_attention_reference.
//
// What bounds it on the H100: operations. At fp32 accuracy each of the two
// products is three TF32 products: 3 x 4 pairs D flop at 495 TFLOP/s dense
// TF32, 8.80 ms at TITAN's (3, 12, 16384, 64) with 12 % of the keys masked,
// where the CUDA-core kernel of alibi_attention_fwd.cu read 258.58 ms on the
// card against scaled_dot_product_attention's 100.38 ms on the dense bias
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py). Beside the products the
// function needs a sqrt and an exp a pair, which the design keeps on the
// special-function and fp32 units while the tensor cores work.
//
// The design: the key-bias 3xTF32 forward's (flash_tf32_fwd.cu) at D = 64
// with the ALiBi term per score.
// * One kernel, no atomics, so two runs give the same bits: a block is four
//   warps of 16 own rows of one 64-row query tile of a (b, h) and streams the
//   batch row's live key tiles (the side inputs' flags) through a two-stage
//   ring of cp.async loads; a dead key tile is never loaded.
// * The own q tile is split into its TF32 hi + lo A fragments once, into
//   registers (64 a thread), and is not read again.
// * A stage is a key tile's k and v rows and its keys' planes row, col,
//   is_cls and term. It is multiplied in two halves of 32 keys: S = q k^T
//   (3xTF32), the distance term with an IEEE sqrt and the key term folded
//   into the base-2 logit (atf::logits), the online softmax in registers
//   (the running max shared in a quad, O rescaled), then O += P v with P
//   split hi + lo in registers and S's C fragments reused as A fragments,
//   into fresh fragments that fp32 adds add to O.
// * Shared memory: the own tile, then two stages of a k and a v tile and
//   four planes: 89,088 bytes, two blocks an SM.
#include "alibi_tf32.cuh"

namespace mt {
namespace atf {

struct FwdSmem {
  static constexpr int kPlanes = 2 * kTileFloats;   // in a stage: y, x, is_cls, term
  static constexpr int kStageFloats = kPlanes + 4 * kTile;
  static constexpr int kRing = kTileFloats;
  static constexpr size_t bytes = sizeof(float) * (kRing + 2 * kStageFloats);
  static_assert(kStageFloats % 4 == 0, "16-byte stages");
  static_assert(2 * bytes <= 232448, "two blocks an SM");
};

// O += P v takes its 64 output columns in one group.
constexpr int kFwdProductGroups = 1;

// The running max, sum and O of the thread's two rows over the logits s of
// a half (base 2): P into s.
__device__ __forceinline__ void online_softmax(float (&s)[16], float (&o)[32], float (&m_run)[2],
                                               float (&l_run)[2]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
      tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
    // never below NEG_INF, so finite: a row of masked keys keeps weight 0
    const float m_new = fmaxf(m_run[rr], wg::quad_max(tmax));
    const float c_old = wg::exp2_fast(m_run[rr] - m_new);
    m_run[rr] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const int i = 4 * j + 2 * rr;
      s[i] = wg::exp2_fast(s[i] - m_new);
      s[i + 1] = wg::exp2_fast(s[i + 1] - m_new);
      sum += s[i] + s[i + 1];
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j + 2 * rr] *= c_old;
      o[4 * j + 2 * rr + 1] *= c_old;
    }
    l_run[rr] = l_run[rr] * c_old + sum;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
alibi_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const wg::SideInputs side,
                      const float* __restrict__ slopes, float* __restrict__ out,
                      float* __restrict__ lse, int H, int N, float scale2) {
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * N;
  const int n_tiles = tiles_of(N), NP = n_tiles * kTile;
  const float* kb = k + row0 * kD;
  const float* vb = v + row0 * kD;
  const float* planes_b = side.coords_t + static_cast<size_t>(b) * 3 * NP;
  const float* kadd_b = side.key_add + static_cast<size_t>(b) * NP;
  const int* live = side.tile_live + static_cast<size_t>(b) * n_tiles;
  const auto plane = [&](int p) { return p < 3 ? planes_b + p * NP : kadd_b; };
  extern __shared__ float4 smem_atf[];
  float* own = reinterpret_cast<float*>(smem_atf);
  float* ring = own + FwdSmem::kRing;
  load_tile(own, q + row0 * kD, N, t0);
  cp_async_commit();
  int t = next_live(live, 0, n_tiles);
  if (t < n_tiles) {
    load_tile(ring, kb, N, t);
    load_tile(ring + kTileFloats, vb, N, t);
    load_planes<4>(ring + FwdSmem::kPlanes, plane, t);
  }
  cp_async_commit();
  cp_async_wait<1>();   // the own tile
  __syncthreads();

  const wg::Lane ln;
  const Own mine(planes_b, NP, t0, ln);
  const float nslope2 = -slopes[h] * wg::kLog2e;
  Frag qf[kD / 8];
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) qf[kk] = row_frag(own, kk, ln);
  float o[32], m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int stage = 0; t < n_tiles; stage ^= 1) {
    __syncthreads();   // no warp still reads the stage the next tile fills
    const int next = next_live(live, t + 1, n_tiles);
    if (next < n_tiles) {
      float* nst = ring + (stage ^ 1) * FwdSmem::kStageFloats;
      load_tile(nst, kb, N, next);
      load_tile(nst + kTileFloats, vb, N, next);
      load_planes<4>(nst + FwdSmem::kPlanes, plane, next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = ring + stage * FwdSmem::kStageFloats;
#pragma unroll 1
    for (int hh = 0; hh < kTile; hh += kHalf) {   // keys [hh, hh + 32) of the tile
      const float* kh = st + hh * kStride;
      const float* pl = st + FwdSmem::kPlanes + hh;
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) scores_step(s, qf[kk], kh, kk, ln);   // q k^T
      logits(s, mine, pl, scale2, nslope2, ln,
             [&](int, int c) { return pl[3 * kTile + c]; });   // the key's 0 or -inf
      online_softmax(s, o, m_run, l_run);
      product<kFwdProductGroups>(o, s, st + kTileFloats + hh * kStride, ln);   // O += P v
    }
    t = next;
  }
  cp_async_wait<0>();

  // rows past N are not written; a row without a valid key: 0, NEG_INF
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = wg::quad_sum(l_run[rr]);   // the whole warp shuffles
    const int row = t0 * kTile + ln.row0 + 8 * rr;
    if (row >= N) continue;
    const bool alive = l > 0.f;
    const float inv = alive ? 1.f / l : 0.f;
    float* orow = out + (row0 + row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[i] * inv, o[i + 1] * inv);
    }
    if (ln.col0 == 0) lse[row0 + row] = alive ? (m_run[rr] + log2f(l)) * wg::kLn2 : kNegInf;
  }
}

}  // namespace atf

cudaError_t launch_alibi_tf32_fwd(const float* q, const float* k, const float* v,
                                  const wg::SideInputs& side, const float* slopes, float* out,
                                  float* lse, int B, int H, int N, float scale,
                                  cudaStream_t stream) {
  const void* rows[6] = {q, k, v, out, side.coords_t, side.key_add};
  for (const void* p : rows)   // cp.async reads 16-byte chunks
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  const cudaError_t err = allow_smem(atf::alibi_fwd_tf32_kernel, atf::FwdSmem::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(atf::tiles_of(N), H, B);
  atf::alibi_fwd_tf32_kernel<<<grid, atf::kThreads, atf::FwdSmem::bytes, stream>>>(
      q, k, v, side, slopes, out, lse, H, N, scale * wg::kLog2e);
  return cudaGetLastError();
}

}  // namespace mt
