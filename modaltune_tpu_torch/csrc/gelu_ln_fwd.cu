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
// the tensor four to five times. About 30 flop per element hide under the
// memory traffic.
//
// What the design does about it: a block owns a whole row at a time and
// keeps its g in shared memory (4 F bytes), so the second pass reads no
// device memory; loads and stores are 4 elements wide; each thread touches
// the same columns in both passes, so the only barriers are the two of the
// block sum.
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

}  // namespace mt

// x, y (rows, F) contiguous in one dtype (0 = float32, 1 = bfloat16); gamma,
// beta (F,) in param_dtype: 0 = float32, else the dtype of x.
// Returns a cudaError_t; 0 means the kernel was launched.
extern "C" int mt_gelu_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              int rows, int F, float eps, int dtype, int param_dtype,
                              void* stream) {
  if (rows < 1 || F < 1 || F > mt::kLnMaxFeatures || (param_dtype != 0 && param_dtype != dtype))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool pf32 = param_dtype == 0;
  if (dtype == 0) return mt::launch_gelu_ln_fwd<float>(x, gamma, beta, y, rows, F, eps, pf32, s);
  if (dtype == 1)
    return mt::launch_gelu_ln_fwd<__nv_bfloat16>(x, gamma, beta, y, rows, F, eps, pf32, s);
  return cudaErrorInvalidValue;
}
