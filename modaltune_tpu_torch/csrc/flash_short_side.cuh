// The short-side family of the key-bias flash attention kernels (K2f, K2b):
// bf16 q/k/v at head dimension 16 with one side of the attention at most
// kMaxShort rows long, which is every adapter attention of the models (65
// modal tokens against 10,239 or 16,383 patches, or against themselves).
//
// The short side ("resident") is held by every block for its whole life; the
// long side is split into C chunks of 64-row tiles, one block per (bh, chunk),
// and each tile of a chunk is read from device memory once, by one bulk
// asynchronous copy per tensor into a ring of kStages shared-memory stages
// whose `full` barriers count the bytes. Thread 0 issues the copies; after a
// tile is consumed the block synchronises and thread 0 refills its stage.
// Side arrays (bias of the streamed keys, lse of the streamed queries) are
// not 16-byte aligned (Lk and Lq are odd), so a block loads its chunk's
// entries with plain loads into shared memory before the loop.
//
// Every product runs on the tensor cores as mma.sync m16n8k16 (bf16 in, fp32
// accumulate): the head dimension is one k16 step. The accumulator of a
// 16 x 8 product gives thread (g, t) = (lane / 4, lane % 4) rows g and g + 8,
// columns 2t and 2t + 1; two neighbouring accumulators packed to bf16 are
// the A fragment of the next product's k16 step, so P and dS stay in
// registers where they feed a product over the other side. Where a product
// needs them transposed, a warp writes them to shared memory in bf16 and
// reads them back with ldmatrix.trans. P and dS enter every product as two
// bf16 parts, hi = bf16(x) and lo = bf16(x - hi), two mma each: the product
// is then exact to about 2^-16 of x. Rounded once to bf16, as the ALiBi
// kernels round them, they doubled the error of out and of every gradient
// (sums of P v and dS k cancel), more than the bf16 train step's per-tensor
// gate takes; the products cost little beside the bytes. Scores are taken
// in base 2 (exp2 with the softmax scale folded into log2(e) * scale).
//
// Masking never forms a NaN: a masked or padded key has the additive term
// -inf, selected by index and bias, never by arithmetic on the streamed
// values; running maxima start at NEG_INF and stay finite; a query row
// without a valid key takes +|NEG_INF/2| for its lse in the backward, so its
// P underflows to 0. Padded resident rows are zero, and the ring is zeroed
// before its first copy, so a ragged last tile multiplies zeros or earlier
// finite rows by exact zeros.
//
// Cross-block sums (the C chunks' softmax partials, partial dq or dk/dv) go
// through fp32 scratch that the wrapper allocates and a second kernel that
// adds them in a fixed order: no atomics, so reruns are bit-equal. The fp32
// family (flash_short_side_tf32.cuh) keeps this plan and these second
// kernels.
#pragma once

#include "attention_wgmma.cuh"  // mbarrier, bulk copy, bf16 packing, quad reductions

namespace mt {
namespace ss {

constexpr int kD = 16;                          // the head dimension served
constexpr int kMaxShort = 128;                  // the longest resident side
constexpr int kTile = 64;                       // rows of a streamed tile
constexpr int kStages = 4;                      // ring depth
constexpr int kRowBytes = kD * 2;               // 32
constexpr int kTileBytes = kTile * kRowBytes;   // 2 KB
constexpr int kResStride = 48;                  // bytes per resident row: ldmatrix without bank conflicts
constexpr int kMaxChunkTiles = 64;              // the wrapper keeps a chunk within this
constexpr int kWarps = 4;                       // except the short-queries forward: one per 16 rows
constexpr float kLowerLse = 5e8f;               // +|NEG_INF/2|: P of a row without a valid key is 0

// The fp32 short-side family (*Tf32) runs flash_short_side_tf32.cuh's
// kernels on the TF32 tensor cores (3xTF32) with this plan; kTf32x3 is the
// fp32 sibling of the wgmma family at D = 48 (flash_tf32.cuh).
enum Family {
  kCudaCores = 0,
  kShortKeys = 1,
  kShortQueries = 2,
  kWgmma = 3,
  kShortKeysTf32 = 4,
  kShortQueriesTf32 = 5,
  kTf32x3 = 6
};

// The head dimension of the wgmma family (flash_wgmma.cuh), GigaPath's: every
// call of the per-branch dilated attention.
constexpr int kWgmmaD = 48;

// Which kernels serve a call. dtype: 0 float32, 1 bfloat16. D = 48 takes
// the wgmma family (bf16) or the 3xTF32 family (fp32) at every Lq and Lk;
// D = 16 with a short side the short-side kernels (bf16 on mma.sync bf16,
// fp32 on 3xTF32), both sides short (the prompt self-attention) the
// short-keys ones; everything else (other D, both sides long at D = 16) the
// CUDA cores. The wrapper asks this rule (mt_flash_attention_family);
// ops/flash_attention.py::family is its copy for the CPU.
inline int family(int Lq, int Lk, int D, int dtype) {
  if (dtype == 1 && D == kWgmmaD) return kWgmma;
  if (dtype == 0 && D == kWgmmaD) return kTf32x3;
  if ((dtype != 0 && dtype != 1) || D != kD) return kCudaCores;
  if (Lk <= kMaxShort) return dtype == 0 ? kShortKeysTf32 : kShortKeys;
  if (Lq <= kMaxShort) return dtype == 0 ? kShortQueriesTf32 : kShortQueries;
  return kCudaCores;
}

inline int pad16(int n) { return (n + 15) / 16 * 16; }
inline int tiles_of(int L) { return (L + kTile - 1) / kTile; }

// The wrapper's choice of C must keep every chunk within kMaxChunkTiles tiles.
inline bool chunks_valid(int L, int C) {
  const int tiles = tiles_of(L);
  return C >= 1 && C <= tiles && (tiles + C - 1) / C <= kMaxChunkTiles;
}
// Rows of the longest chunk.
inline int max_chunk_rows(int L, int C) { return (tiles_of(L) + C - 1) / C * kTile; }

// Chunk c of C over the long side's tiles: tiles [c T / C, (c + 1) T / C).
struct Chunk {
  int row0, rows, tiles;
  __device__ Chunk(int c, int C, int L) {
    const int T = (L + kTile - 1) / kTile;
    const int t0 = static_cast<int>(static_cast<long long>(c) * T / C);
    const int t1 = static_cast<int>(static_cast<long long>(c + 1) * T / C);
    row0 = t0 * kTile;
    rows = min(t1 * kTile, L) - row0;
    tiles = t1 - t0;
  }
};

// ---- tensor-core pieces ------------------------------------------------------

// d (16 x 8) += a (16 x 16) b (16 x 8), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The lane's row address for an x4 ldmatrix of the 16 x 16 bf16 block at
// (r0, c0) of a row-major array (`stride` bytes a row) at shared address
// `base`. Two orders of the four 8 x 8 matrices:
//  RowsFirst: (r0, c0) (r0 + 8, c0) (r0, c0 + 8) (r0 + 8, c0 + 8). Without
//    .trans these are the A fragment of the block as a row-major 16 x 16
//    A; with .trans, the B fragments of two 8-column tiles of a [k][n] array
//    (k the rows): registers 0-1 columns c0.., 2-3 columns c0 + 8...
//  ColsFirst: (r0, c0) (r0, c0 + 8) (r0 + 8, c0) (r0 + 8, c0 + 8). Without
//    .trans, the B fragments of two 8-column tiles of an [n][k] array (n the
//    rows: K for S = Q K^T); with .trans, the A fragment of the transpose of
//    a [k][m] array (P^T from P).
__device__ __forceinline__ uint32_t rows_first(uint32_t base, int stride, int r0, int c0) {
  const int l = threadIdx.x % 32;
  return base + (r0 + (l & 7) + (l & 8)) * stride + (c0 + (l >> 4) * 8) * 2;
}
__device__ __forceinline__ uint32_t cols_first(uint32_t base, int stride, int r0, int c0) {
  const int l = threadIdx.x % 32;
  return base + (r0 + (l & 7) + (l >> 4) * 8) * stride + (c0 + (l & 8)) * 2;
}

// (x, y) as two packed bf16 pairs whose sum is (x, y) to about 2^-16.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = wg::pack_bf16(x - f.x, y - f.y);
}

// The A fragment, as hi and lo parts, of the k16 step made of accumulator
// tiles c0 and c1 (the two 8-column tiles of the same 16 rows).
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                        const float (&c1)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// d += (hi + lo) b
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  mma(d, hi, b0, b1);
  mma(d, lo, b0, b1);
}

__device__ __forceinline__ void zero(float (&d)[4]) { d[0] = d[1] = d[2] = d[3] = 0.f; }

// ---- the ring --------------------------------------------------------------

// kStages stages of one 64-row tile of each of N streamed (.., 16) bf16
// tensors; stage s, tensor i at tiles + (s * N + i) * kTile * kD.
template <int N>
struct Ring {
  static constexpr int kBytes = kStages * N * kTileBytes;
  bf16* tiles;
  uint64_t* full;

  __device__ bf16* tile(int t, int i) const { return tiles + ((t % kStages) * N + i) * kTile * kD; }
  __device__ uint32_t addr(int t, int i) const { return wg::smem_u32(tile(t, i)); }

  // Every thread: zero the stages; thread 0: the barriers. Ends with a
  // __syncthreads, after which the async proxy may write the stages.
  __device__ void init() const {
    uint4* z = reinterpret_cast<uint4*>(tiles);
    for (int i = threadIdx.x; i < kBytes / 16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) wg::mbar_init(full + s, 1);
      wg::mbar_init_fence();
    }
    __syncthreads();
  }

  // Thread 0: tile t (rows [row0, row0 + n) of every source) into its stage.
  __device__ void issue(int t, const bf16* const (&src)[N], size_t row0, int n) const {
    uint64_t* bar = full + t % kStages;
    const uint32_t bytes = static_cast<uint32_t>(n) * kRowBytes;
    wg::mbar_expect(bar, N * bytes);
#pragma unroll
    for (int i = 0; i < N; ++i) wg::bulk_copy(tile(t, i), src[i] + row0 * kD, bytes, bar);
  }

  __device__ void wait(int t) const { wg::mbar_wait(full + t % kStages, (t / kStages) & 1); }
};

// Rows [0, n) of a (.., 16) bf16 array into `rows` resident rows of kResStride
// bytes, zeros past n.
__device__ __forceinline__ void load_resident(unsigned char* dst, const bf16* src, int n, int rows) {
  for (int i = threadIdx.x; i < rows * 2; i += blockDim.x) {
    const int r = i / 2, h = i % 2;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < n) x = reinterpret_cast<const uint4*>(src)[i];
    *reinterpret_cast<uint4*>(dst + r * kResStride + h * 16) = x;
  }
}

__device__ __forceinline__ float key_term(const float* bias, int j, int n, float log2e) {
  if (j >= n) return -INFINITY;
  const float b = bias == nullptr ? 0.f : bias[j];
  return b > kMaskThreshold ? b * log2e : -INFINITY;
}

// lse in base 2 as the backward uses it: +|NEG_INF/2| for a row without a
// valid key (and for a padded row), so that its P underflows to 0.
__device__ __forceinline__ float lse2_for_bwd(const float* lse, int i, int n) {
  const float x = i < n ? lse[i] : kNegInf;
  return (x > kMaskThreshold ? x : kLowerLse) * wg::kLog2e;
}

__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// ---- the cross-chunk kernels of both dtypes (T: bf16 or float) --------------

// out and lse of (bh, row) from the C short-queries partials of the row
// (acc [BH][C][QP][16], then m and l [BH][C][QP] each, m in base 2), in chunk
// order. A partial with l = 0 (a chunk without a valid key) takes no part; a
// row without any gets out 0 and lse NEG_INF. One thread per output element.
template <typename T>
__global__ void __launch_bounds__(256)
flash_fwd_combine_kernel(const float* __restrict__ work, T* __restrict__ out,
                         float* __restrict__ lse, int BH, int Lq, int QP, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BH * Lq * kD) return;
  const int d = i % kD, row = i / kD % Lq, bh = i / (kD * Lq);
  const size_t planes = static_cast<size_t>(BH) * C * QP;
  const float* acc = work + static_cast<size_t>(bh) * C * QP * kD + row * kD + d;
  const float* ms = work + planes * kD + static_cast<size_t>(bh) * C * QP + row;
  const float* ls = ms + planes;
  float mx = kNegInf;
  for (int c = 0; c < C; ++c)
    if (ls[c * QP] > 0.f) mx = fmaxf(mx, ms[c * QP]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < C; ++c) {
    const float lc = ls[c * QP];
    if (lc > 0.f) {
      const float w = exp2f(ms[c * QP] - mx);
      l = fmaf(w, lc, l);
      o = fmaf(w, acc[static_cast<size_t>(c) * QP * kD], o);
    }
  }
  put(out + i, l > 0.f ? o / l : 0.f);
  if (d == 0) lse[static_cast<size_t>(bh) * Lq + row] = l > 0.f ? (mx + log2f(l)) * wg::kLn2 : kNegInf;
}

// dst_y[bh][r][d] = mul_y * sum over chunks c of part_y[bh][c][r][d], r < n,
// in chunk order; y = blockIdx.y picks one of two (part, dst, mul), the
// parts RP rows a chunk and BH * C * RP * 16 floats apart.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dst0, T* __restrict__ dst1,
                     float mul0, float mul1, int BH, int n, int RP, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BH * n * kD) return;
  const int d = i % kD, r = i / kD % n, bh = i / (kD * n);
  const float* p = part + static_cast<size_t>(blockIdx.y) * BH * C * RP * kD +
                   static_cast<size_t>(bh) * C * RP * kD + r * kD + d;
  float x = 0.f;
  for (int c = 0; c < C; ++c) x += p[static_cast<size_t>(c) * RP * kD];
  put((blockIdx.y ? dst1 : dst0) + i, x * (blockIdx.y ? mul1 : mul0));
}

// ---- launchers (flash_short_side_fwd.cu, flash_short_side_bwd.cu) ----------

// Scratch, in floats: the forward's short-queries partials (acc, m, l of
// every (bh, chunk, resident row)); the backward's partial dk and dv
// (short keys) or dq (short queries) of every (bh, chunk, resident row).
cudaError_t launch_fwd(int fam, const bf16* q, const bf16* k, const bf16* v, const float* bias,
                       bf16* out, float* lse, int BH, int Lq, int Lk, float scale, int chunks,
                       float* work, cudaStream_t stream);
cudaError_t launch_bwd(int fam, const bf16* q, const bf16* k, const bf16* v, const float* bias,
                       const bf16* dout, const bf16* out, const float* lse, bf16* dq, bf16* dk,
                       bf16* dv, int BH, int Lq, int Lk, float scale, int chunks, float* work,
                       cudaStream_t stream);

}  // namespace ss
}  // namespace mt
