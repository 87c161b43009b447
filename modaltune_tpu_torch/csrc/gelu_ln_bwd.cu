// Fused exact GELU -> LayerNorm, backward (K5b).
//
// Replaces: modaltune_tpu/ops/gelu_ln.py::_bwd_call (the Pallas TPU kernel
// that recomputes the GELU and the LayerNorm statistics from the saved x and
// returns dx, dgamma and dbeta).
//
// Semantics (the plain oracle is ops/gelu_ln.py::gelu_ln_backward_reference).
// Per row, with g, mu, rstd as in the forward (gelu_ln_fwd.cu) and
// xhat = (g - mu) * rstd:
//   dyg = dy * gamma
//   dg  = round_T(rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)))
//   dx  = dg * (Phi(x) + x * phi(x))
// and over all rows dgamma = sum dy * xhat, dbeta = sum dy, in fp32.
//
// What bounds it on the H100: bytes. x and dy are read once and dx written
// once (3 * rows * F * sizeof(T)); autograd through the unfused chain moves
// the tensor some ten times.
//
// What the design does about it: a block owns a whole row at a time, with g
// and dyg in shared memory between its three passes (the third reads x
// again, from cache). Blocks walk the rows in a fixed stride and keep their
// own sums of dy * xhat and dy per column in shared memory, each column
// owned by one thread, so no atomics: every block writes its partial row to
// a scratch (n_blocks, 2, F) and a second kernel adds the partial rows in a
// fixed order. The result does not depend on the order blocks run in.
#include "gelu_ln_common.cuh"

namespace mt {

template <typename T, int V>
__global__ void __launch_bounds__(kLnThreads)
gelu_ln_bwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   int rows, int F, float eps, bool param_f32) {
  extern __shared__ float4 smem4[];
  float* g = reinterpret_cast<float*>(smem4);  // [F]
  float* dyg = g + F;                          // [F]
  float* acc_dg = dyg + F;                     // [F] this block's sum of dy * xhat
  float* acc_db = acc_dg + F;                  // [F] this block's sum of dy
  __shared__ float red[2 * kLnWarps];
  // every pass gives a thread the same columns, so the four arrays need no
  // barrier of their own
  for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc_dg[c + e] = acc_db[c + e] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * F;
    const T* dyr = dy + static_cast<size_t>(row) * F;
    T* dxr = dx + static_cast<size_t>(row) * F;
    const float2 st = gelu_row_stats<T, V>(xr, g, F, eps, red);
    const float mu = st.x, rstd = st.y;

    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
      float d[V], gv[V], adg[V], adb[V];
      Vec<T, V>::load(dyr + c, d);
      Vec<float, V>::load(g + c, gv);
      Vec<float, V>::load(acc_dg + c, adg);
      Vec<float, V>::load(acc_db + c, adb);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (gv[e] - mu) * rstd;
        adg[e] += d[e] * xhat;
        adb[e] += d[e];
        d[e] *= load_param<T>(gamma, c + e, param_f32);
        s1 += d[e];
        s2 += d[e] * xhat;
      }
      Vec<float, V>::store(acc_dg + c, adg);
      Vec<float, V>::store(acc_db + c, adb);
      Vec<float, V>::store(dyg + c, d);
    }
    const float2 tot = block_sum2(s1, s2, red);
    const float m1 = tot.x / F, m2 = tot.y / F;

    for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
      float xv[V], gv[V], d[V];
      Vec<T, V>::load(xr + c, xv);
      Vec<float, V>::load(g + c, gv);
      Vec<float, V>::load(dyg + c, d);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (gv[e] - mu) * rstd;
        const float dg = round_to<T>(rstd * (d[e] - m1 - xhat * m2));
        const float pdf = expf(-0.5f * xv[e] * xv[e]) * kInvSqrt2Pi;
        xv[e] = dg * (gelu_cdf(xv[e]) + xv[e] * pdf);
      }
      Vec<T, V>::store(dxr + c, xv);
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * F;
  for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      out[c + e] = acc_dg[c + e];
      out[F + c + e] = acc_db[c + e];
    }
  }
}

constexpr int kReduceCols = 32;
constexpr int kReduceRows = 8;

// total[i] = sum over blocks b of partial[b][i], i < n (= 2 F). A block owns
// 32 columns; its 8 thread rows each add every 8th partial row, then thread
// row 0 adds the 8 sums in order.
__global__ void __launch_bounds__(kReduceCols * kReduceRows)
gelu_ln_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ total,
                          int n_blocks, int n) {
  __shared__ float part[kReduceRows][kReduceCols];
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  float s = 0.f;
  if (col < n)
    for (int b = threadIdx.y; b < n_blocks; b += kReduceRows)
      s += partial[static_cast<size_t>(b) * n + col];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kReduceRows; ++r) t += part[r][threadIdx.x];
    total[col] = t;
  }
}

template <typename T>
cudaError_t launch_gelu_ln_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                               float* partial, float* total, int rows, int F, int n_blocks,
                               float eps, bool param_f32, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * 4 * F;
  const auto tx = static_cast<const T*>(x);
  const auto tdy = static_cast<const T*>(dy);
  const auto tdx = static_cast<T*>(dx);
  cudaError_t err;
  if (can_vectorize<T>(F, x, dy, dx)) {
    auto kernel = gelu_ln_bwd_kernel<T, 4>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, kLnThreads, bytes, stream>>>(tx, gamma, tdy, tdx, partial, rows, F, eps,
                                                    param_f32);
  } else {
    auto kernel = gelu_ln_bwd_kernel<T, 1>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, kLnThreads, bytes, stream>>>(tx, gamma, tdy, tdx, partial, rows, F, eps,
                                                    param_f32);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 2 * F;
  gelu_ln_bwd_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols,
                              dim3(kReduceCols, kReduceRows), 0, stream>>>(partial, total,
                                                                           n_blocks, n);
  return cudaGetLastError();
}

}  // namespace mt

// x, dy, dx (rows, F) contiguous in one dtype (0 = float32, 1 = bfloat16);
// gamma (F,) in param_dtype: 0 = float32, else the dtype of x; partial
// (n_blocks, 2, F) fp32 scratch, 1 <= n_blocks <= rows; total (2, F) fp32:
// dgamma, then dbeta. Returns a cudaError_t; 0 means both kernels were
// launched.
extern "C" int mt_gelu_ln_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                              void* partial, void* total, int rows, int F, int n_blocks,
                              float eps, int dtype, int param_dtype, void* stream) {
  if (rows < 1 || F < 1 || F > mt::kLnMaxFeatures || n_blocks < 1 || n_blocks > rows ||
      (param_dtype != 0 && param_dtype != dtype))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool pf32 = param_dtype == 0;
  const auto pp = static_cast<float*>(partial);
  const auto pt = static_cast<float*>(total);
  if (dtype == 0)
    return mt::launch_gelu_ln_bwd<float>(x, gamma, dy, dx, pp, pt, rows, F, n_blocks, eps, pf32,
                                         s);
  if (dtype == 1)
    return mt::launch_gelu_ln_bwd<__nv_bfloat16>(x, gamma, dy, dx, pp, pt, rows, F, n_blocks,
                                                 eps, pf32, s);
  return cudaErrorInvalidValue;
}
