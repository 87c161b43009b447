// The 3xTF32 family of the ALiBi flash attention kernels (K4f, K4b): fp32
// q/k/v at head dimension 64, TITAN's attention under an fp32 backbone (the
// CLI's --bf16 0): 6 K4f and 6 K4b a train step at (3, 12, 16384, 64).
//
// The kernels (alibi_tf32_fwd.cu, alibi_tf32_bwd.cu) are the key-bias
// 3xTF32 family's (flash_tf32.cuh) at D = 64 with the ALiBi term made per
// score: blocks of four warps of 16 own rows of one 64-row tile of a
// (batch row, head), rows of 64 floats padded to 68 in shared memory, a
// two-stage cp.async ring of the batch row's live key tiles, every product as
// three TF32 mma.sync m16n8k8 (tf32x3.cuh) summed a half tile (32 keys or
// queries) at a time in fresh fragments, because the tensor cores accumulate
// by truncation. This is a sibling of dilated_tf32.cuh's frame, not a
// template of it: that frame's constants, accumulators and stores are the
// D = 48 cores', and those keep their bits.
//
// The side inputs are the bf16 family's (wg::SideInputs, made once a forward
// by ops/alibi_flash.py and kept for its backward): the lane-major
// coordinate planes (row, col, is_cls; zeros past N), the key term (0, or
// -inf for a masked key and past N) and the live 64-key tiles of each batch
// row. A stage carries its tile's three planes and key terms behind k and v,
// so the distance of a (row, key) pair is made where its score lies:
//   dist = sqrt(dy^2 + dx^2), IEEE rounded (the coordinates are small
//   integers, so dy^2 + dx^2 is exact and dist equals the plain version's),
//   logit2 = s scale log2(e) - slope log2(e) dist (1 - cls_i)(1 - cls_j) + term.
// A key past N or masked has the term -inf and weight exactly 0; a batch row
// without a live tile streams nothing (out 0, lse NEG_INF, zero gradients).
#pragma once

#include "attention_wgmma.cuh"
#include "tf32x3.cuh"

namespace mt {

// 0, 1, 2: the family that serves (D, dtype) (0 = float32, 1 = bfloat16).
enum AlibiFamily { kAlibiCudaCores = 0, kAlibiWgmma = 1, kAlibiTf32x3 = 2 };
inline int alibi_family(int D, int dtype) {
  if (D != wg::kD) return kAlibiCudaCores;
  if (dtype == 1) return kAlibiWgmma;
  return dtype == 0 ? kAlibiTf32x3 : kAlibiCudaCores;
}

// The forward (alibi_tf32_fwd.cu): out (B, H, N, 64) and lse (B, H, N) fp32,
// 0 and NEG_INF for a row without a valid key.
cudaError_t launch_alibi_tf32_fwd(const float* q, const float* k, const float* v,
                                  const wg::SideInputs& side, const float* slopes, float* out,
                                  float* lse, int B, int H, int N, float scale,
                                  cudaStream_t stream);

// The backward (alibi_tf32_bwd.cu) into the 16-byte aligned fp32 scratch
// `work`, (B H) x (64 + 2 NP) floats (ops/alibi_flash.py::work_floats,
// NP = N rounded up to 64): a kernel that writes vbar, the mean of
// the valid keys' v rows, of every (b, h); the dq kernel, which also writes
// delta = dout.(out - vbar) and lse in base 2 of every query (padded to NP);
// then the dk/dv kernel, which streams them.
cudaError_t launch_alibi_tf32_bwd(const float* q, const float* k, const float* v,
                                  const wg::SideInputs& side, const float* slopes,
                                  const float* dout, const float* out, const float* lse,
                                  float* work, float* dq, float* dk, float* dv, int B, int H,
                                  int N, float scale, cudaStream_t stream);

namespace atf {

using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::Frag;
using tf32::mma3;
using tf32::split;

constexpr int kD = wg::kD;
constexpr int kTile = 64;
constexpr int kStride = kD + 4;               // floats a row in shared memory
constexpr int kTileFloats = kTile * kStride;  // 17,408 bytes
constexpr int kChunks = kD / 4;               // 16-byte chunks of a row
constexpr int kThreads = 128;                 // four warps of 16 own rows
constexpr int kHalf = kTile / 2;              // rows of a stage multiplied at once
constexpr int kPlaneChunks = kTile / 4;       // 16-byte chunks of a 64-float plane
static_assert(kStride % 4 == 0, "16-byte rows");

__host__ __device__ inline int tiles_of(int N) { return (N + kTile - 1) / kTile; }

// 16 bytes from global to shared memory, zeros where !fill.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(wg::smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// Tile t of the rows [0, N) at x (64 rows of 64 floats, 16 chunks each) into
// d, chunk threadIdx.x + 128 i by thread threadIdx.x; rows past N as zeros.
__device__ __forceinline__ void load_tile(float* d, const float* x, int N, int t) {
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i, row = c / kChunks, ch = c % kChunks;
    const int l = t * kTile + row;
    const bool real = l < N;
    cp_async16(d + row * kStride + 4 * ch, x + static_cast<size_t>(real ? l : 0) * kD + 4 * ch,
               real);
  }
}

// P planes of tile t into d, 64 floats apart: plane p from src(p), a (NP,)
// row padded to whole tiles, by threads below 16 P.
template <int P, typename Src>
__device__ __forceinline__ void load_planes(float* d, Src src, int t) {
  if (threadIdx.x < kPlaneChunks * P) {
    const int p = threadIdx.x / kPlaneChunks, ch = threadIdx.x % kPlaneChunks;
    cp_async16(d + p * kTile + 4 * ch, src(p) + t * kTile + 4 * ch, true);
  }
}

// The batch row's first live key tile at or after t (n_tiles if none).
__device__ __forceinline__ int next_live(const int* live, int t, int n_tiles) {
  while (t < n_tiles && __ldg(live + t) == 0) ++t;
  return t;
}

// ---- the products -----------------------------------------------------------
//
// A thread (g = lane / 4, t = lane % 4) of the warp owning rows
// [r0, r0 + 16) holds, in element 4 j + 2 rr + e of a 16 x 8N register tile,
// row r0 + g + 8 rr and column 8 j + 2 t + e: the C fragments of the N
// 16 x 8 tiles (wg::Lane: row0 = r0 + g, col0 = 2 t).

// The warp's A fragment of its 16 rows of tile a, columns [8 kk, + 8).
__device__ __forceinline__ Frag row_frag(const float* a, int kk, const wg::Lane& ln) {
  const float* ar = a + ln.row0 * kStride + 8 * kk + ln.col0 / 2;
  Frag fa;
  split(ar[0], fa.hi[0], fa.lo[0]);                  // (g, t)
  split(ar[8 * kStride], fa.hi[1], fa.lo[1]);        // (g + 8, t)
  split(ar[4], fa.hi[2], fa.lo[2]);                  // (g, t + 4)
  split(ar[8 * kStride + 4], fa.hi[3], fa.lo[3]);    // (g + 8, t + 4)
  return fa;
}

// s += the 8-deep step kk of A B^T: fa the warp's A fragment there, B the
// 32 rows at b.
__device__ __forceinline__ void scores_step(float (&s)[16], const Frag& fa, const float* b,
                                            int kk, const wg::Lane& ln) {
  const int g = ln.row0 & 7, t = ln.col0 / 2;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    const float* br = b + (8 * j + g) * kStride + 8 * kk + t;
    uint32_t bh[2], bl[2];
    split(br[0], bh[0], bl[0]);                      // (k = t, n = g)
    split(br[4], bh[1], bl[1]);                      // (k = t + 4, n = g)
    mma3(s + 4 * j, fa.hi, fa.lo, bh, bl);
  }
}

// s (the warp's 16 rows x 32) = A B^T over the 64 columns: A the warp's
// rows of tile a, B the 32 rows at b.
__device__ __forceinline__ void scores(float (&s)[16], const float* a, const float* b,
                                       const wg::Lane& ln) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) scores_step(s, row_frag(a, kk, ln), b, kk, ln);
}

// acc (the warp's 16 rows x 64) += X B over a half: X the 16 x 32 register
// tile, B the 32 rows at b (their 64 columns are N), in GROUPS groups of
// output columns, each summed in a fresh fragment (tf32::product) that fp32
// adds add to acc. More groups hold fewer registers and split X again.
template <int GROUPS>
__device__ __forceinline__ void product(float (&acc)[32], const float (&x)[16], const float* b,
                                        const wg::Lane& ln) {
  constexpr int N = kD / 8 / GROUPS;
#pragma unroll
  for (int gr = 0; gr < GROUPS; ++gr)
    tf32::product<N, kHalf / 8>(acc + 4 * N * gr, x,
                                [&](int j, int m, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
                                  const float* br = b + (8 * j + ln.col0) * kStride +
                                                    8 * (m + N * gr) + (ln.row0 & 7);
                                  split(br[0], bh[0], bl[0]);
                                  split(br[kStride], bh[1], bl[1]);
                                });
}

// ---- the ALiBi term ---------------------------------------------------------

// The coordinates of a thread's two own rows (row0 + 8 rr of tile t):
// {row, col, 1 - is_cls} from the batch row's (3, NP) planes.
struct Own {
  float y[2], x[2], nc[2];
  __device__ Own(const float* planes_b, int NP, int t, const wg::Lane& ln) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = t * kTile + ln.row0 + 8 * rr;
      y[rr] = planes_b[i];
      x[rr] = planes_b[NP + i];
      nc[rr] = 1.f - planes_b[2 * NP + i];
    }
  }
};

// The scores s (q k^T unscaled, the thread's two rows x 8 columns of a
// half) into base-2 logits: s scale2 + nslope2 dist not_cls + term(rr, c),
// the columns' planes row, col, is_cls at `planes` (64 floats apart, at the
// half's first column), term(rr, c) the additive term of own row rr and
// column c of the half (a key's 0 or -inf, less a query's lse2).
template <typename Term>
__device__ __forceinline__ void logits(float (&s)[16], const Own& own, const float* planes,
                                       float scale2, float nslope2, const wg::Lane& ln,
                                       Term term) {
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    const int c = 8 * j + ln.col0;
    const float2 y = *reinterpret_cast<const float2*>(planes + c);
    const float2 x = *reinterpret_cast<const float2*>(planes + kTile + c);
    const float2 cls = *reinterpret_cast<const float2*>(planes + 2 * kTile + c);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = 4 * j + 2 * rr;
      const float dy0 = own.y[rr] - y.x, dx0 = own.x[rr] - x.x;
      const float dy1 = own.y[rr] - y.y, dx1 = own.x[rr] - x.y;
      const float d0 = __fsqrt_rn(fmaf(dy0, dy0, dx0 * dx0)) * fmaf(-own.nc[rr], cls.x, own.nc[rr]);
      const float d1 = __fsqrt_rn(fmaf(dy1, dy1, dx1 * dx1)) * fmaf(-own.nc[rr], cls.y, own.nc[rr]);
      s[i] = fmaf(s[i], scale2, fmaf(nslope2, d0, term(rr, c)));
      s[i + 1] = fmaf(s[i + 1], scale2, fmaf(nslope2, d1, term(rr, c + 1)));
    }
  }
}

// Rows row0 + lane's row and + 8 of a 64 x 64 accumulator times `scale`
// into rows at `dst` (row stride 64), rows below n only.
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[32], int n,
                                           float scale, const wg::Lane& ln) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    if (row >= n) continue;
    float* d = dst + static_cast<size_t>(row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<float2*>(d + 8 * j) = make_float2(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// Zero rows [0, n) of 64 floats at `dst`, the whole block.
__device__ __forceinline__ void zero_rows(float* dst, int n) {
  for (int i = threadIdx.x; i < n * kD / 4; i += blockDim.x)
    reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace atf
}  // namespace mt
