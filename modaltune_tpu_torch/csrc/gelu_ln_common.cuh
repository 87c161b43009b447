// Shared pieces of the fused GELU -> LayerNorm kernels (gelu_ln_fwd.cu,
// gelu_ln_bwd.cu): the fp32 erf GELU, rounding at the operand dtype, and
// two frames whose sums run in a fixed order, so the kernels are
// deterministic.
//
// The row-resident frame (bf16 x, F = 3072, every pointer aligned to 16
// bytes): a group of kRowWarps warps owns a row, each lane
// holds its share in registers as 16-byte vectors of 8 bf16, and the row's
// sums are a butterfly in each warp plus one exchange of kRowWarps floats
// among the group's warps behind a named barrier.
//
// The generic frame (fp32 x, other widths, unaligned pointers): a block
// owns a row at a time with the row in shared memory, 4-wide or scalar
// accesses, and a block sum.
#pragma once

#include <cstdint>

#include "attention_common.cuh"

namespace mt {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnMaxFeatures = 8192;  // MAX_FEATURES of ops/gelu_ln.py
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

// Phi(x), the normal CDF: gelu(x) = x * Phi(x).
__device__ __forceinline__ float gelu_cdf(float x) { return 0.5f * (1.f + erff(x * kInvSqrt2)); }

// x as it reads after a round trip through T (the dtype boundary between
// the GELU and the LayerNorm of the unfused chain).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// gamma or beta, held in float32 (f32) or in T.
template <typename T>
__device__ __forceinline__ float load_param(const void* p, int i, bool f32) {
  return f32 ? static_cast<const float*>(p)[i] : to_float<T>(static_cast<const T*>(p)[i]);
}

// V consecutive elements as floats; V = 4 needs p aligned to 4 elements.
template <typename T, int V> struct Vec;

template <typename T> struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* o) { o[0] = to_float<T>(p[0]); }
  static __device__ __forceinline__ void store(T* p, const float* o) { p[0] = from_float<T>(o[0]); }
};

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* o) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned int*>(&a);
    raw.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// The block's sums of a and of b, in every thread. red: 2 * kLnWarps floats
// of shared memory, free again after the call's first barrier.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous call's reads of red are done
  if (lane == 0) {
    red[warp] = a;
    red[kLnWarps + warp] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int w = 0; w < kLnWarps; ++w) {
    sa += red[w];
    sb += red[kLnWarps + w];
  }
  return make_float2(sa, sb);
}

// Pass 1 of both kernels over one row: g = round_T(gelu(x)) into shared
// memory (each thread touches only its own columns, in every pass), then
// the fast-variance statistics. Returns (mu, rstd).
template <typename T, int V>
__device__ __forceinline__ float2 gelu_row_stats(const T* xr, float* g, int F, float eps,
                                                 float* red) {
  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
    float xv[V];
    Vec<T, V>::load(xr + c, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xv[e] = round_to<T>(xv[e] * gelu_cdf(xv[e]));
      s += xv[e];
      ss += xv[e] * xv[e];
    }
    Vec<float, V>::store(g + c, xv);
  }
  const float2 tot = block_sum2(s, ss, red);
  const float mu = tot.x / F;
  const float var = fmaxf(0.f, tot.y / F - mu * mu);
  return make_float2(mu, rsqrtf(var + eps));
}

// 4-wide access needs F a multiple of 4 and every row pointer aligned to 4
// elements of T.
template <typename T> inline bool can_vectorize(int F, const void* a, const void* b, const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return F % 4 == 0 && bits % (4 * sizeof(T)) == 0;
}

// ---------------------------------------------------------------------------
// The row-resident frame (bf16, F = kRowWidth)
// ---------------------------------------------------------------------------
//
// Lane t (0 <= t < kRowLanes) of a group holds the row's 16-byte vectors t,
// t + kRowLanes, ..., t + (kRowVectors - 1) kRowLanes: columns
// (i kRowLanes + t) 8 to + 8. Its element j (0 <= j < kRowElems) is column
// (j / 8 * kRowLanes + t) * 8 + j % 8, the low half of 32-bit word j / 2
// when j is even. Group i of block b takes rows b kRowGroups + i, then every
// gridDim.x kRowGroups-th row after it, and loads each next row before the
// current row's sums. ops/gelu_ln.py keeps a copy of the constants
// (ROW_WIDTH, ROW_WARPS, ROW_GROUPS) and of row_route for the CPU;
// mt_gelu_ln_row_frame and mt_gelu_ln_route export them, and the card tests
// hold the copies equal.

constexpr int kRowWidth = 3072;      // F of the frame: the model's FFN
constexpr int kRowWarps = 4;         // warps that own one row
constexpr int kRowLanes = 32 * kRowWarps;
constexpr int kRowGroups = 2;        // groups a block
constexpr int kRowThreads = kRowLanes * kRowGroups;
constexpr int kRowVectors = kRowWidth / (8 * kRowLanes);  // 16-byte vectors a lane
constexpr int kRowWords = 4 * kRowVectors;                 // 32-bit words a lane
constexpr int kRowElems = 8 * kRowVectors;                 // elements a lane
static_assert(kRowVectors * 8 * kRowLanes == kRowWidth, "kRowWarps must tile kRowWidth");

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// element j of a lane's words
__device__ __forceinline__ float bf16_at(const uint32_t* w, int j) {
  return j % 2 ? bf16_hi(w[j / 2]) : bf16_lo(w[j / 2]);
}
// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A lane's words of row `row` of a (rows, kRowWidth) bf16 tensor.
__device__ __forceinline__ void load_row(const __nv_bfloat16* base, int row, int t,
                                         uint32_t (&w)[kRowWords]) {
  const uint4* p = reinterpret_cast<const uint4*>(base) + static_cast<size_t>(row) * kRowWidth / 8;
#pragma unroll
  for (int i = 0; i < kRowVectors; ++i) {
    const uint4 u = __ldg(p + i * kRowLanes + t);
    w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
  }
}

__device__ __forceinline__ void store_row(__nv_bfloat16* base, int row, int t,
                                          const uint32_t (&w)[kRowWords]) {
  uint4* p = reinterpret_cast<uint4*>(base) + static_cast<size_t>(row) * kRowWidth / 8;
#pragma unroll
  for (int i = 0; i < kRowVectors; ++i)
    p[i * kRowLanes + t] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// gamma or beta at a lane's columns, held in registers in their dtype P and
// read as 16-byte vectors.
template <typename P> struct ParamRow;

template <> struct ParamRow<__nv_bfloat16> {
  uint32_t w[kRowWords];
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int t) { load_row(p, 0, t, w); }
  __device__ __forceinline__ float at(int j) const { return bf16_at(w, j); }
};

template <> struct ParamRow<float> {
  float f[kRowElems];
  __device__ __forceinline__ void load(const float* p, int t) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < kRowVectors; ++i) {
      const float4* v = q + 2 * (i * kRowLanes + t);
      const float4 a = __ldg(v), b = __ldg(v + 1);
      f[8 * i] = a.x; f[8 * i + 1] = a.y; f[8 * i + 2] = a.z; f[8 * i + 3] = a.w;
      f[8 * i + 4] = b.x; f[8 * i + 5] = b.y; f[8 * i + 6] = b.z; f[8 * i + 7] = b.w;
    }
  }
  __device__ __forceinline__ float at(int j) const { return f[j]; }
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The group's sums of a and of b, the same bits in every lane: a butterfly
// in each warp, then the warps' sums in warp order. red: the group's
// 2 kRowWarps slots; consecutive calls alternate between their halves
// (`half`), so one named barrier (1 + the group's index) a call suffices:
// a lane writes a half only after every lane of the group has passed the
// barrier of the call between, and so has read that half.
__device__ __forceinline__ float2 group_sum2(float a, float b, float2* red, int& half, int group) {
  a = warp_sum(a);
  b = warp_sum(b);
  float2* slot = red + half * kRowWarps;
  if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32 % kRowWarps] = make_float2(a, b);
  named_barrier(1 + group, kRowLanes);
  float2 s = slot[0];
#pragma unroll
  for (int w = 1; w < kRowWarps; ++w) {
    s.x += slot[w].x;
    s.y += slot[w].y;
  }
  half ^= 1;
  return s;
}

// Whether rows of width F in dtype (0 = float32, 1 = bfloat16) whose
// tensors are all 16-byte aligned take the row-resident kernels.
inline bool row_route(int dtype, int F, bool aligned) {
  return dtype == 1 && F == kRowWidth && aligned;
}

// Blocks of `kernel` an SM can hold, or 0 if the card cannot be asked. The
// launchers keep it in a static, one per kernel: a row-resident kernel's
// launch asks the card nothing it has asked before.
template <typename Kernel>
inline int row_blocks_per_sm(Kernel kernel) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, 0) != cudaSuccess)
    return 0;
  return per_sm;
}

// Blocks of a row-resident kernel: as many as the card holds at once
// (per_sm of row_blocks_per_sm), and no more than the rows need. 0 if the
// card cannot be asked.
inline int row_grid(int per_sm, int rows) {
  int dev = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const int want = (rows + kRowGroups - 1) / kRowGroups;
  return want < sms * per_sm ? want : sms * per_sm;
}

}  // namespace mt
