// The Hopper frame of the bf16 ALiBi attention kernels at head dimension 64
// (alibi_attention_{fwd,bwd}.cu): warpgroup matrix products (wgmma) on
// tiles that the Tensor Memory Accelerator (TMA) streams through a ring of
// shared-memory stages, with every score tile kept in registers.
//
// A block is W consumer warpgroups (128 threads, 64 "own" rows each) and one
// producer warpgroup, of which one lane works and which hands its registers
// to the consumers (setmaxnreg). That lane fills the ring: for every stage it
// waits on the stage's `empty` barrier, announces the bytes on its `full`
// barrier and issues the TMA copies, which complete on that barrier. The
// consumers wait on `full`, multiply, and one lane per warp arrives on
// `empty` when the warp's products that read the stage have completed.
//
// Tiles are 64 rows x 64 bf16 = 64 lines of 128 bytes in the 128-byte
// swizzled layout that both TMA (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma
// (layout type 1) use; a tile's base is 1024-byte aligned. One tile serves
// both kinds of product:
// * as a K-major operand (the 64 columns are the product's inner dimension:
//   S = Q K^T reads Q as A and K as B), a 16-deep step advances 32 bytes;
// * as an MN-major B operand (the 64 rows are the inner dimension:
//   O += P V reads V, `trans-b` set), a 16-deep step advances 16 rows.
//
// The accumulator of m64nNk16 is documented: thread t of the warpgroup holds,
// in element i of its 32 floats, row 16 * (t / 32) + (t % 32) / 4 +
// 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * (t % 4) + i % 2. So a
// thread knows the (row, column) of what it holds, a row's statistics are
// shared by the four threads of a quad, and elements 8k .. 8k + 7, packed in
// pairs to bf16, are exactly the A fragment of the k-th 16-deep step of the
// next product: P and dS go from one product to the next without leaving
// the registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace mt {

using bf16 = __nv_bfloat16;

namespace wg {

constexpr int kTile = 64;                       // rows of a tile: keys or queries
constexpr int kD = 64;                          // the head dimension served
constexpr int kTileBytes = kTile * kD * 2;      // 8 KB
constexpr int kRowBytes = kTile * 4;            // a plane of 64 floats
constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// One 64 x 64 bf16 tile of a (BH, N, 64) tensor: rows [row, row + 64) of
// plane bh; rows past N arrive as zeros.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of raw memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a 64 x 64 bf16 tile in the 128-byte swizzled layout: groups
// of eight 128-byte lines, 1024 bytes apart.
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{64} << 32) | (uint64_t{1} << 62);
}
constexpr uint64_t kStepKMajor = 32 >> 4;             // 16 columns of a line
constexpr uint64_t kStepMnMajor = (16 * 128) >> 4;    // 16 lines

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving a use of these registers across the point:
// an asynchronous product owns its accumulator and its register operand
// until the wait that follows it.
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define MT_WGMMA_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MT_WGMMA_D32_ARGS(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (64 x 64) = [d +] A B^T for one 16-deep step, A and B K-major tiles.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : MT_WGMMA_D32_ARGS(d)
      : "l"(a), "l"(b), "r"(add));
}

// d (64 x 64) += A B for one 16-deep step: A a register fragment (four
// packed bf16 pairs), B an MN-major tile (its rows are the inner dimension).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MT_WGMMA_D32_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d = A B^T over the whole head dimension (four steps), A and B tiles.
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(d, a + kk * kStepKMajor, b + kk * kStepKMajor, kk > 0);
}

// d += P B over the 64 rows of tile B, P the packed register tile.
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&p)[16], uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) wgmma_rs(d, p + 4 * kk, b + kk * kStepMnMajor);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Pack a 64 x 64 fp32 register tile to bf16 in the A-fragment order.
__device__ __forceinline__ void pack_tile(uint32_t (&p)[16], const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sqrt_fast(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Maximum / sum over the four threads that share a row of the accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Where a consumer thread's accumulator elements lie: rows row0 and
// row0 + 8 of its warpgroup's 64, columns 8 j + col0 and + 1, j < 8.
struct Lane {
  int row0, col0;
  __device__ Lane() {
    const int t = threadIdx.x % kWgThreads;
    row0 = 16 * (t / 32) + (t % 32) / 4;
    col0 = 2 * (t % 4);
  }
};

// dnc[i] = ||c_row - c_col|| * (1 - cls_row) * (1 - cls_col) for the 32
// elements a thread holds: `own` = {y, x, 1 - is_cls} of its two rows, the
// columns' planes y, x, is_cls (64 floats each, kTile apart) in shared memory.
__device__ __forceinline__ void distance_tile(float (&dnc)[32], const float (&own)[2][3],
                                              const float* planes, int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 y = *reinterpret_cast<const float2*>(planes + 8 * j + col0);
    const float2 x = *reinterpret_cast<const float2*>(planes + kTile + 8 * j + col0);
    const float2 c = *reinterpret_cast<const float2*>(planes + 2 * kTile + 8 * j + col0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float dy0 = own[r][0] - y.x, dx0 = own[r][1] - x.x;
      const float dy1 = own[r][0] - y.y, dx1 = own[r][1] - x.y;
      dnc[4 * j + 2 * r] = sqrt_fast(fmaf(dy0, dy0, dx0 * dx0)) * fmaf(-own[r][2], c.x, own[r][2]);
      dnc[4 * j + 2 * r + 1] =
          sqrt_fast(fmaf(dy1, dy1, dx1 * dx1)) * fmaf(-own[r][2], c.y, own[r][2]);
    }
  }
}

// {y, x, 1 - is_cls} of the two own rows of a thread, rows own_row0 + lane's
// row0 and + 8 of the (3, NP) planes at `planes_b`; zeros past NP.
__device__ __forceinline__ void own_coords(float (&own)[2][3], const float* planes_b, int NP,
                                           int first_row) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = first_row + 8 * r;
    own[r][0] = i < NP ? planes_b[i] : 0.f;
    own[r][1] = i < NP ? planes_b[NP + i] : 0.f;
    own[r][2] = i < NP ? 1.f - planes_b[2 * NP + i] : 0.f;
  }
}

// How many of a batch row's n_tiles flags are set, counted by one warp.
__device__ __forceinline__ int count_live(const int* tile_live, int n_tiles) {
  int n = 0;
  for (int i = threadIdx.x % 32; i < n_tiles; i += 32) n += tile_live[i] != 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  return n;
}

// Registers move from the producer's warpgroup to the consumers': a block is
// launched with (W + 1) * 128 threads at 65536 / threads registers each, the
// producer's warpgroup drops to kProducerRegs and each consumer warpgroup
// rises to kConsumerRegs<W>. Every thread of a warpgroup executes its call,
// at the top of a branch that the other role never enters.
constexpr int kProducerRegs = 40;
template <int W>
constexpr int kConsumerRegs = W == 1 ? 216 : 232;
static_assert(2 * 128 * (kConsumerRegs<1> + kProducerRegs) <= 65536 &&
                  128 * (2 * kConsumerRegs<2> + kProducerRegs) <= 65536,
              "the blocks of an SM share 65,536 registers");

template <int REGS>
__device__ __forceinline__ void take_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// A ring position: the stage and the parity of its barriers' current use.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---- host side ------------------------------------------------------------

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime so that the
// library needs no link against libcuda; null if it is not there.
inline TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<TensorMapEncode>(p);
  }();
  return fn;
}

// The map of a contiguous (BH, N, 64) bf16 tensor cut into 64 x 64 tiles.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, int BH, int N) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {kD * 2, static_cast<cuuint64_t>(N) * kD * 2};
  const cuuint32_t box[3] = {kD, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What the wrapper prepares once per call for the kernels of this frame
// (ops/alibi_flash.py), NP = N rounded up to 64:
struct SideInputs {
  const float* coords_t;   // (B, 3, NP): planes row, col, is_cls; 0 past N
  const float* key_add;    // (B, NP): 0 for a valid key, -inf for a masked one or past N
  const int* tile_live;    // (B, NP / 64): 1 where the 64-key tile holds a valid key
};

}  // namespace wg
}  // namespace mt
