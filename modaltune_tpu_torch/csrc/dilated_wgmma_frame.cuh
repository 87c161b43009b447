// The device frame of the tensor-core dilated attention cores
// (dilated_fwd_wgmma.cu, dilated_bwd_wgmma.cu): compact 64-row tiles at
// D = 48 in shared memory, the wgmma products on them, the gather of their
// rows, the ring of stages and the sentinel that ends a stream.
//
// * D = 48, rows of 96 bytes: a tile is three 16-column slabs of 64 rows x
//   32 bytes in the 32-byte swizzle (wgmma layout type 3). A slab is one
//   16-deep step of the K-major products (S = q k^T, dP = dmix v^T: three
//   steps) and the three slabs are the N = 48 of the MN-major ones
//   (O += P v, dq += dS k, ...: m64n48k16, four steps over the 64 rows).
//   Nothing is padded to 64 columns: a neighbouring head's columns never
//   enter a product.
// * Gathered rows: row l of a (segment, head group) is position first + r l,
//   so a tile's rows lie r H 96 bytes apart. A producer warpgroup gathers
//   them with 16-byte cp.async (two threads a row, three chunks each,
//   zero-filled past the group's n_real, so the gather needs no L % r and
//   never reads past a tensor), each thread's copies arriving on the stage's
//   barrier when they land (cp.async.mbarrier.arrive.noinc); a TMA map per
//   ratio would need L % r == 0 and 20 maps in the kernel parameters. The
//   consumer fences the async proxy before its products read the stage.
// * A stream of key tiles: the producer ORs each key tile's validity over
//   its warpgroup (bar.red.or) and never loads a dead tile; a stage carries
//   its keys' terms (0 or -inf, from the mask bytes); a sentinel stage, whose
//   flag is set, ends the stream, so the consumer needs no count.
#pragma once

#include "attention_wgmma.cuh"
#include "dilated_wgmma.cuh"

namespace mt {
namespace dwg {

constexpr int kD = kWgmmaD;
constexpr int kTile = 64;
constexpr int kSlabBytes = kTile * 32;        // 64 rows x 16 bf16
constexpr int kTileBytes = 3 * kSlabBytes;    // 6 KB
constexpr int kRowBytes = kTile * 4;          // 64 floats
constexpr int kStages = 4;
constexpr int kThreads = 2 * wg::kWgThreads;  // consumer, producer
// The descriptor strides of a tile (bytes): 8-row groups of a slab, and
// slab to slab along N in the MN-major products.
constexpr uint32_t kGroupBytes = 8 * 32;
static_assert(kTileBytes == kTile * kD * 2, "three slabs of 16 columns");

// Byte offset of 16-byte chunk c (0..5) of row `row` in a tile: slab c / 2,
// the pair of chunks of a 32-byte row swapped on rows 4..7 of every 8 (the
// 32-byte swizzle; a tile's base is 1024-byte aligned).
__device__ __forceinline__ int chunk_offset(int row, int c) {
  return (c >> 1) * kSlabBytes + row * 32 + (((c & 1) ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint64_t desc32(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((wg::smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (uint64_t{3} << 62);
}

// d (64 x 64) = A B^T over the 48 columns, A and B tiles (K-major): one
// 16-deep step a slab.
__device__ __forceinline__ void product_ss(float (&d)[32], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 3; ++kk)
    wg::wgmma_ss(d, desc32(a + kk * kSlabBytes, 16, kGroupBytes),
                 desc32(b + kk * kSlabBytes, 16, kGroupBytes), kk > 0);
}

#define MT_WGMMA_D24                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23}"
#define MT_WGMMA_D24_ARGS(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])

// d (64 x 48) += A B for one 16-deep step: A a register fragment, B rows
// [16 kk, + 16) of a tile, MN-major (its 48 columns are N).
__device__ __forceinline__ void wgmma_rs48(float (&d)[24], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " MT_WGMMA_D24
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n"
      "}\n"
      : MT_WGMMA_D24_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d += X B over the 64 rows of tile B, X the packed register tile.
__device__ __forceinline__ void product_rs(float (&d)[24], const uint32_t (&x)[16],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs48(d, x + 4 * kk, desc32(b + kk * 16 * 32, kSlabBytes, kGroupBytes));
}

template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the consumers' arithmetic ----------------------------------------------

// One key tile's scores `s` (64 x 64, q k^T unscaled) into the online
// softmax of the thread's two rows: P packed to bf16 into `p`, O rescaled.
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint32_t (&p)[16], float (&o)[24],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const float* kterm, float scale2,
                                             const wg::Lane& ln) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 kt = *reinterpret_cast<const float2*>(kterm + 8 * j + ln.col0);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = 4 * j + 2 * rr;
      s[i] = fmaf(s[i], scale2, kt.x);
      s[i + 1] = fmaf(s[i + 1], scale2, kt.y);
      tmax[rr] = fmaxf(tmax[rr], fmaxf(s[i], s[i + 1]));
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    // never below NEG_INF, so finite: a row of masked keys keeps weight 0
    const float m_new = fmaxf(m_run[rr], wg::quad_max(tmax[rr]));
    const float c_old = wg::exp2_fast(m_run[rr] - m_new);
    m_run[rr] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * rr;
      s[i] = wg::exp2_fast(s[i] - m_new);
      s[i + 1] = wg::exp2_fast(s[i + 1] - m_new);
      sum += s[i] + s[i + 1];
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      o[4 * j + 2 * rr] *= c_old;
      o[4 * j + 2 * rr + 1] *= c_old;
    }
    l_run[rr] = l_run[rr] * c_old + sum;
  }
  wg::pack_tile(p, s);
}

// A 64 x 64 fp32 register tile as two bf16 A-fragment tiles, hi = bf16(x)
// and lo = bf16(x - hi).
__device__ __forceinline__ void pack_parts(uint32_t (&hi)[16], uint32_t (&lo)[16],
                                           const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = wg::pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
}

// A query's lse in base 2 for P = exp2(s + key term - lse2): +1e30 for a
// row that is no real one or has no valid key, so its P is exactly 0.
__device__ __forceinline__ float lse2_of(float lse, bool real) {
  return real && lse > kMaskThreshold ? lse * wg::kLog2e : 1e30f;
}

// ---- the gradient cores' arithmetic (dilated_bwd_wgmma.cu, dilated_bwd_tf32.cu) --

// Zero rows [0, n) of compact fp32 gradients at `dst`, the whole block.
__device__ __forceinline__ void zero_rows(float* dst, int n) {
  for (int i = threadIdx.x; i < n * kD / 4; i += blockDim.x)
    reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Rows row0 + lane's row and + 8 of a 64 x 48 accumulator times `scale`
// into fp32 compact rows at `dst` (row stride 48), rows below n only; rows
// past the group's n_real hold zeros (their P is 0).
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[24], int n,
                                           float scale, const wg::Lane& ln) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ln.row0 + 8 * rr;
    if (row >= n) continue;
    float* d = dst + static_cast<size_t>(row) * kD + ln.col0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<float2*>(d + 8 * j) = make_float2(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// One live key tile's P (into s, from the scores; N = 32 for 64 keys, 16
// for 32) for the thread's two rows, and rowsum(P dP) over its columns added
// to rs.
template <int N>
__device__ __forceinline__ void probabilities(float (&s)[N], const float (&dp)[N],
                                              float (&rs)[2], const float* kterm,
                                              const float (&lse2)[2], float scale2,
                                              const wg::Lane& ln) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 kt = *reinterpret_cast<const float2*>(kterm + 8 * j + ln.col0);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = 4 * j + 2 * rr;
      s[i] = wg::exp2_fast(fmaf(s[i], scale2, kt.x - lse2[rr]));
      s[i + 1] = wg::exp2_fast(fmaf(s[i + 1], scale2, kt.y - lse2[rr]));
      rs[rr] = fmaf(s[i], dp[i], rs[rr]);
      rs[rr] = fmaf(s[i + 1], dp[i + 1], rs[rr]);
    }
  }
}

// ---- the gather --------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(wg::smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
// One arrival on `bar` when this thread's earlier cp.async have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   wg::smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Shared memory written by the generic proxy (cp.async, stores), read next
// by wgmma (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// OR of x over the 128 threads of the producer warpgroup (named barrier 1).
__device__ __forceinline__ bool producer_any(bool x) {
  uint32_t r;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(x))
      : "memory");
  return r != 0;
}

// The block's tile and its (segment, group), with the addressing of rows.
struct Group {
  FusedTile ft;
  int b, h, L, H;
  size_t rows0;  // compact row of the group's row 0 in a (B, H, M) tensor
  __device__ Group(const FusedBranches& fb, const FusedTile& ft_, int h_, int b_, int L_, int H_)
      : ft(ft_), b(b_), h(h_), L(L_), H(H_) {
    rows0 = (static_cast<size_t>(b) * H + h) * fb.off[fb.n] + ft.seg_row;
  }
  __device__ Group(const FusedBranches& fb, int tile, int h_, int b_, int L_, int H_)
      : Group(fb, locate_tile(fb, tile, h_, H_, L_), h_, b_, L_, H_) {}
  __device__ int position(int l) const { return ft.first + ft.r * l; }
  // element offset of row l of a (B, L, H, 48) tensor at this head
  __device__ size_t element(int l) const {
    return ((static_cast<size_t>(b) * L + position(l)) * H + h) * kD;
  }
  __device__ bool valid_key(int l, const unsigned char* mask) const {
    return l < ft.n_real && (mask == nullptr || mask[static_cast<size_t>(b) * L + position(l)]);
  }
  __device__ int n_tiles() const { return (ft.n_real + kTile - 1) / kTile; }
  // [t_lo, t_hi): the tiles holding a real row at a position of [q0, q1)
  __device__ void query_tiles(int q0, int q1, int& t_lo, int& t_hi) const {
    const int l_lo = ceil_div_nonneg(q0 - ft.first, ft.r);
    const int l_hi = min(ft.n_real, ceil_div_nonneg(q1 - ft.first, ft.r));
    t_lo = l_lo / kTile;
    t_hi = l_hi > l_lo ? (l_hi + kTile - 1) / kTile : t_lo;
  }
};

// Producer thread p (0..127) gathers its three chunks of row p / 2 of group
// tile t of x into tile d; rows past n_real arrive as zeros.
__device__ __forceinline__ void gather(unsigned char* d, const bf16* x, const Group& g, int t,
                                       int p) {
  const int i = p >> 1, l = t * kTile + i;
  const bool real = l < g.ft.n_real;
  const size_t e = real ? g.element(l) : 0;
#pragma unroll
  for (int cc = 0; cc < 3; ++cc) {
    const int c = 3 * (p & 1) + cc;
    cp_async16(d + chunk_offset(i, c), x + e + 8 * c, real);
  }
}

// Shared memory of a core: two own tiles, then the ring; a stage is two
// tiles and 1 KB of per-row terms; then the barriers.
struct Smem {
  static constexpr int kTerms = 2 * kTileBytes;   // floats of the stage's rows
  static constexpr int kEnd = kTerms + 3 * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;
  static constexpr int kRing = 2 * kTileBytes;
  static constexpr int kBars = kRing + kStages * kStageBytes;
  static constexpr size_t bytes = 1024 + kBars + (2 * kStages + 1) * sizeof(uint64_t);
  static_assert(kEnd + 16 <= kStageBytes && kStageBytes % 1024 == 0, "stage layout");
  static_assert(2 * bytes <= 232448, "two blocks an SM");
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The ring's barriers: `consumer_warps` arrive on a stage's `empty` when
// they are done with it.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* own_bar,
                                              int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // every producer thread arrives twice: its copies landed, its stores
      wg::mbar_init(full + s, 2 * wg::kWgThreads);
      wg::mbar_init(empty + s, consumer_warps);
    }
    wg::mbar_init(own_bar, wg::kWgThreads);
    wg::mbar_init_fence();
  }
  __syncthreads();
}

// The end of a stream: one more stage whose flag is set.
__device__ __forceinline__ void producer_finish(unsigned char* ring, uint64_t* full,
                                                uint64_t* empty, wg::Ring r, int p) {
  wg::mbar_wait(empty + r.stage, r.phase ^ 1);
  if (p == 0) *reinterpret_cast<int*>(ring + r.stage * Smem::kStageBytes + Smem::kEnd) = 1;
  cp_async_arrive(full + r.stage);
  wg::mbar_arrive(full + r.stage);
  cp_async_wait_all();
}

// The producer's stream of the group's live key tiles: each stage holds a
// tile's k and v and its keys' terms (0, or -inf for a masked key or a row
// past n_real); then the sentinel.
__device__ __forceinline__ void produce_key_tiles(unsigned char* ring, uint64_t* full,
                                                  uint64_t* empty, const bf16* k, const bf16* v,
                                                  const unsigned char* mask, const Group& g,
                                                  int p) {
  wg::Ring r;
  for (int t = 0; t < g.n_tiles(); ++t) {
    const int l = t * kTile + (p >> 1);
    const bool valid = g.valid_key(l, mask);
    if (!producer_any(valid)) continue;   // a dead key tile is never loaded
    wg::mbar_wait(empty + r.stage, r.phase ^ 1);
    unsigned char* st = ring + r.stage * Smem::kStageBytes;
    gather(st, k, g, t, p);
    gather(st + kTileBytes, v, g, t, p);
    cp_async_arrive(full + r.stage);
    if ((p & 1) == 0)
      reinterpret_cast<float*>(st + Smem::kTerms)[p >> 1] = valid ? 0.f : -INFINITY;
    if (p == 0) *reinterpret_cast<int*>(st + Smem::kEnd) = 0;
    wg::mbar_arrive(full + r.stage);
    r.advance<kStages>();
  }
  producer_finish(ring, full, empty, r, p);
}

// The consumer's wait for the next stage: false at the sentinel.
__device__ __forceinline__ bool next_stage(const unsigned char*& st, const unsigned char* ring,
                                           uint64_t* full, const wg::Ring& r) {
  wg::mbar_wait(full + r.stage, r.phase);
  st = ring + r.stage * Smem::kStageBytes;
  if (*reinterpret_cast<const volatile int*>(st + Smem::kEnd) != 0) return false;
  fence_async_shared();
  return true;
}

}  // namespace dwg
}  // namespace mt
