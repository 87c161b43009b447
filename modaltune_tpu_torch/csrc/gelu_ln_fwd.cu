// Fused exact GELU -> LayerNorm, forward (K5f).
//
// Replaces: modaltune_tpu/ops/gelu_ln.py::_fwd_call (the Pallas TPU kernel
// that runs the FFN's chain between its two matrix products in one pass).
//
// Semantics (the plain oracle is ops/gelu_ln.py::gelu_ln_reference). Per row
// of x (rows, F): g = round_T(x * Phi(x)) with the erf in fp32 and the
// rounding at the operand dtype T; mu = mean(g); var = max(0, mean(g^2) -
// mu^2) (the fast variance); y = (g - mu) * rsqrt(var + eps) * gamma + beta,
// all in fp32, stored as T. gamma and beta are fp32 or T.
//
// The Pallas body evaluates a rational polynomial for erf because its
// compiler has none; here erff is the device library's.
//
// What bounds it on the H100: bytes. x is read once and y written once
// (2 * rows * F * sizeof(T)); the unfused chain (GELU, then LayerNorm) moves
// the tensor four to five times. About 30 fp32 operations an element, one
// erf among them, are a sixth of the card's ~20 a byte at its fp32 peak.
//
// Two routes, by row_route (gelu_ln_common.cuh), which the wrapper asks
// through mt_gelu_ln_route (ops/gelu_ln.py::card_route):
//
// * bf16 x with F = 3072 (the model's FFN) and every pointer 16-byte
//   aligned: gelu_ln_fwd_rows_kernel on the
//   row-resident frame of gelu_ln_common.cuh. What the design does about the
//   bytes: a group of four warps owns a row, and each lane reads its share
//   once as 16-byte vectors into registers, where g stays, packed as bf16
//   (exact: it was rounded there), until y is written as 16-byte vectors;
//   one erf an element; the two row sums are shuffles plus one exchange of
//   four floats behind a named barrier, so no group waits for another; a
//   group issues its next row's loads before the current row's sums, so
//   each SM keeps tens of KB of reads in flight; gamma and beta are read
//   once a group, as 16-byte vectors in their own dtype (a template
//   parameter), and stay in registers.
// * everything else (fp32 x, other widths, unaligned pointers):
//   gelu_ln_fwd_kernel, a block a row with g in shared memory, 4-wide
//   accesses where F and the pointers allow them.
#include "gelu_ln_common.cuh"

namespace mt {

template <typename T, int V>
__global__ void __launch_bounds__(kLnThreads)
gelu_ln_fwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                   const void* __restrict__ beta, T* __restrict__ y, int rows, int F, float eps,
                   bool param_f32) {
  extern __shared__ float4 smem4[];
  float* g = reinterpret_cast<float*>(smem4);  // [F]
  __shared__ float red[2 * kLnWarps];
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * F;
    T* yr = y + static_cast<size_t>(row) * F;
    const float2 st = gelu_row_stats<T, V>(xr, g, F, eps, red);
    const float mu = st.x, rstd = st.y;
    for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
      float o[V];
      Vec<float, V>::load(g + c, o);
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = (o[e] - mu) * rstd * load_param<T>(gamma, c + e, param_f32) +
               load_param<T>(beta, c + e, param_f32);
      Vec<T, V>::store(yr + c, o);
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(kRowThreads)
gelu_ln_fwd_rows_kernel(const __nv_bfloat16* __restrict__ x, const P* __restrict__ gamma,
                        const P* __restrict__ beta, __nv_bfloat16* __restrict__ y, int rows,
                        float eps) {
  __shared__ float2 red[kRowGroups][2 * kRowWarps];
  const int group = threadIdx.x / kRowLanes, t = threadIdx.x % kRowLanes;
  const int stride = gridDim.x * kRowGroups;
  int row = blockIdx.x * kRowGroups + group;
  if (row >= rows) return;  // the whole group: its lanes share their rows
  ParamRow<P> gm, bt;
  gm.load(gamma, t);
  bt.load(beta, t);
  uint32_t cur[kRowWords], nxt[kRowWords];
  load_row(x, row, t, cur);
  int half = 0;
  for (;;) {
    const int next = row + stride;
    if (next < rows) load_row(x, next, t, nxt);
    // g = round_bf16(x Phi(x)), kept packed; the lane's sums in element order
    uint32_t g[kRowWords];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < kRowWords; ++k) {
      const float a = bf16_lo(cur[k]), b = bf16_hi(cur[k]);
      g[k] = pack_bf16(a * gelu_cdf(a), b * gelu_cdf(b));
      const float ga = bf16_lo(g[k]), gb = bf16_hi(g[k]);
      s += ga;
      ss += ga * ga;
      s += gb;
      ss += gb * gb;
    }
    const float2 tot = group_sum2(s, ss, red[group], half, group);
    const float mu = tot.x / kRowWidth;
    const float rstd = rsqrtf(fmaxf(0.f, tot.y / kRowWidth - mu * mu) + eps);
    uint32_t out[kRowWords];
#pragma unroll
    for (int k = 0; k < kRowWords; ++k)
      out[k] = pack_bf16((bf16_lo(g[k]) - mu) * rstd * gm.at(2 * k) + bt.at(2 * k),
                         (bf16_hi(g[k]) - mu) * rstd * gm.at(2 * k + 1) + bt.at(2 * k + 1));
    store_row(y, row, t, out);
    if (next >= rows) break;
    row = next;
#pragma unroll
    for (int k = 0; k < kRowWords; ++k) cur[k] = nxt[k];
  }
}

template <typename T>
cudaError_t launch_gelu_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                               int rows, int F, float eps, bool param_f32, cudaStream_t stream) {
  const int grid = rows < 65536 ? rows : 65536;
  const size_t bytes = sizeof(float) * F;
  const auto tx = static_cast<const T*>(x);
  const auto ty = static_cast<T*>(y);
  if (can_vectorize<T>(F, x, y, y))
    gelu_ln_fwd_kernel<T, 4><<<grid, kLnThreads, bytes, stream>>>(tx, gamma, beta, ty, rows, F,
                                                                  eps, param_f32);
  else
    gelu_ln_fwd_kernel<T, 1><<<grid, kLnThreads, bytes, stream>>>(tx, gamma, beta, ty, rows, F,
                                                                  eps, param_f32);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_gelu_ln_fwd_rows(const void* x, const void* gamma, const void* beta, void* y,
                                    int rows, float eps, cudaStream_t stream) {
  const auto kernel = gelu_ln_fwd_rows_kernel<P>;
  static const int per_sm = row_blocks_per_sm(kernel);
  const int grid = row_grid(per_sm, rows);
  if (grid < 1) return cudaErrorUnknown;
  kernel<<<grid, kRowThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const P*>(gamma),
      static_cast<const P*>(beta), static_cast<__nv_bfloat16*>(y), rows, eps);
  return cudaGetLastError();
}

}  // namespace mt

// x, y (rows, F) contiguous in one dtype (0 = float32, 1 = bfloat16); gamma,
// beta (F,) in param_dtype: 0 = float32, else the dtype of x. route 0: the
// generic kernel; 1: the row-resident kernel, which takes bf16 x with
// F = 3072 and every pointer aligned to 16 bytes.
// Returns a cudaError_t; 0 means the kernel was launched.
extern "C" int mt_gelu_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              int rows, int F, float eps, int dtype, int param_dtype, int route,
                              void* stream) {
  if (rows < 1 || F < 1 || F > mt::kLnMaxFeatures || (param_dtype != 0 && param_dtype != dtype))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool pf32 = param_dtype == 0;
  if (route == 1) {
    if (!mt::row_route(dtype, F, true)) return cudaErrorInvalidValue;
    if (!mt::aligned16(x) || !mt::aligned16(gamma) || !mt::aligned16(beta) || !mt::aligned16(y))
      return cudaErrorMisalignedAddress;
    if (pf32) return mt::launch_gelu_ln_fwd_rows<float>(x, gamma, beta, y, rows, eps, s);
    return mt::launch_gelu_ln_fwd_rows<__nv_bfloat16>(x, gamma, beta, y, rows, eps, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return mt::launch_gelu_ln_fwd<float>(x, gamma, beta, y, rows, F, eps, pf32, s);
  if (dtype == 1)
    return mt::launch_gelu_ln_fwd<__nv_bfloat16>(x, gamma, beta, y, rows, F, eps, pf32, s);
  return cudaErrorInvalidValue;
}

// The route of rows of width F in dtype (0 = float32, 1 = bfloat16) whose
// tensors are all 16-byte aligned (aligned != 0) or not: 1, the
// row-resident kernels, else 0, the generic ones. The wrappers ask it
// (ops/gelu_ln.py::card_route); ops/gelu_ln.py::route is its copy.
extern "C" int mt_gelu_ln_route(int dtype, int F, int aligned) {
  return mt::row_route(dtype, F, aligned != 0) ? 1 : 0;
}
