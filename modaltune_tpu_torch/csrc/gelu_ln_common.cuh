// Shared pieces of the fused GELU -> LayerNorm kernels (gelu_ln_fwd.cu,
// gelu_ln_bwd.cu): the fp32 erf GELU, rounding at the operand dtype, the
// affine parameters in either dtype, 4-wide loads and stores, and a block
// sum whose order is fixed (every thread adds the warps' sums in the same
// order), so the kernels are deterministic.
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

}  // namespace mt
