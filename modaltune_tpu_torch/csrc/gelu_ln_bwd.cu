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
// and, in the variant that computes them, over all rows dgamma = sum dy *
// xhat, dbeta = sum dy, in fp32. The model's train step freezes gamma and
// beta, so the wrapper asks for the variant without them there
// (ops/gelu_ln.py::wants_param_grads): no scratch, no second kernel.
//
// What bounds it on the H100: bytes. x and dy are read once and dx written
// once (3 * rows * F * sizeof(T)); autograd through the unfused chain moves
// the tensor some ten times. About 60 fp32 operations an element, an erf and
// an exp among them, come within a factor of two of the fp32 peak at that
// byte time, so no element may be computed twice.
//
// dgamma and dbeta without atomics, in a fixed order in both routes: each
// block walks the rows in a fixed stride and keeps its own column sums;
// every block writes one partial row to a scratch (n_blocks, 2, F) and a
// second kernel adds the partial rows in a fixed order. The result does not
// depend on the order in which blocks run.
//
// Two routes, by row_route (gelu_ln_common.cuh), which the wrapper asks
// through mt_gelu_ln_route (ops/gelu_ln.py::card_route):
//
// * bf16 x with F = 3072 (the model's FFN) and every pointer 16-byte
//   aligned: gelu_ln_bwd_rows_kernel on the
//   row-resident frame of gelu_ln_common.cuh. What the design does about the
//   bytes: a group of four warps owns a row; each lane loads its share of x
//   and dy as 16-byte vectors, all of them before any arithmetic, and the
//   group loads its next row before the current row's sums, so each SM keeps
//   tens of KB of reads in flight; x is read once and Phi(x) evaluated once
//   an element, into g and into the GELU's derivative, which stays in
//   registers for dx; g stays packed in bf16; nothing per element goes
//   through shared memory; the two row reductions are shuffles plus one
//   exchange of four float pairs behind a named barrier, so no group waits
//   for another. With dgamma and dbeta, each lane keeps its columns' two
//   sums in registers across its rows, and the groups of a block add theirs
//   in group order into the block's partial row.
// * everything else (fp32 x, other widths, unaligned pointers):
//   gelu_ln_bwd_kernel, a block a row with g, dyg and the column sums in
//   shared memory and three passes over the row.
#include "gelu_ln_common.cuh"

namespace mt {

template <typename T, int V, bool AFFINE>
__global__ void __launch_bounds__(kLnThreads)
gelu_ln_bwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   int rows, int F, float eps, bool param_f32) {
  extern __shared__ float4 smem4[];
  float* g = reinterpret_cast<float*>(smem4);  // [F]
  float* dyg = g + F;                          // [F]
  float* acc_dg = dyg + F;                     // [F] this block's sum of dy * xhat (AFFINE)
  float* acc_db = acc_dg + F;                  // [F] this block's sum of dy (AFFINE)
  __shared__ float red[2 * kLnWarps];
  // every pass gives a thread the same columns, so the four arrays need no
  // barrier of their own
  if constexpr (AFFINE) {
    for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc_dg[c + e] = acc_db[c + e] = 0.f;
    }
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * F;
    const T* dyr = dy + static_cast<size_t>(row) * F;
    T* dxr = dx + static_cast<size_t>(row) * F;
    const float2 st = gelu_row_stats<T, V>(xr, g, F, eps, red);
    const float mu = st.x, rstd = st.y;

    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
      float d[V], gv[V];
      Vec<T, V>::load(dyr + c, d);
      Vec<float, V>::load(g + c, gv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (gv[e] - mu) * rstd;
        if constexpr (AFFINE) {
          acc_dg[c + e] += d[e] * xhat;
          acc_db[c + e] += d[e];
        }
        d[e] *= load_param<T>(gamma, c + e, param_f32);
        s1 += d[e];
        s2 += d[e] * xhat;
      }
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
  if constexpr (AFFINE) {
    float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * F;
    for (int c = threadIdx.x * V; c < F; c += kLnThreads * V) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        out[c + e] = acc_dg[c + e];
        out[F + c + e] = acc_db[c + e];
      }
    }
  }
}

// Without dgamma and dbeta two blocks an SM fit in 128 registers a thread
// (0.2507 against 0.2654 ms at one block, PERF.md section 6); with them the
// column sums need more, and at 128 they spill.
template <typename P, bool AFFINE>
__global__ void __launch_bounds__(kRowThreads, AFFINE ? 1 : 2)
gelu_ln_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x, const P* __restrict__ gamma,
                        const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ partial, int rows, float eps) {
  __shared__ float2 red[kRowGroups][2 * kRowWarps];
  const int group = threadIdx.x / kRowLanes, t = threadIdx.x % kRowLanes;
  const int stride = gridDim.x * kRowGroups;
  int row = blockIdx.x * kRowGroups + group;
  ParamRow<P> gm;
  gm.load(gamma, t);
  // this lane's columns' sums of dy * xhat and of dy over its rows
  float acc_g[AFFINE ? kRowElems : 1], acc_b[AFFINE ? kRowElems : 1];
  if constexpr (AFFINE) {
#pragma unroll
    for (int j = 0; j < kRowElems; ++j) acc_g[j] = acc_b[j] = 0.f;
  }
  uint32_t xc[kRowWords], dc[kRowWords], xn[kRowWords], dn[kRowWords];
  if (row < rows) {
    load_row(x, row, t, xc);
    load_row(dy, row, t, dc);
  }
  int half = 0;
  // no early return: the AFFINE epilogue's barriers need every thread
  for (; row < rows; row += stride) {
    const int next = row + stride;
    if (next < rows) {
      load_row(x, next, t, xn);
      load_row(dy, next, t, dn);
    }
    // Phi(x) once an element: into g = round_bf16(x Phi(x)), kept packed,
    // and the GELU's derivative Phi(x) + x phi(x), kept for dx, so x is
    // dead after this pass
    float dgelu[kRowElems];
    uint32_t g[kRowWords];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < kRowWords; ++k) {
      const float a = bf16_lo(xc[k]), b = bf16_hi(xc[k]);
      const float ca = gelu_cdf(a), cb = gelu_cdf(b);
      dgelu[2 * k] = ca + a * (expf(-0.5f * a * a) * kInvSqrt2Pi);
      dgelu[2 * k + 1] = cb + b * (expf(-0.5f * b * b) * kInvSqrt2Pi);
      g[k] = pack_bf16(a * ca, b * cb);
      const float ga = bf16_lo(g[k]), gb = bf16_hi(g[k]);
      s += ga;
      ss += ga * ga;
      s += gb;
      ss += gb * gb;
    }
    const float2 st = group_sum2(s, ss, red[group], half, group);
    const float mu = st.x / kRowWidth;
    const float rstd = rsqrtf(fmaxf(0.f, st.y / kRowWidth - mu * mu) + eps);

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kRowElems; ++j) {
      const float xhat = (bf16_at(g, j) - mu) * rstd;
      const float d = bf16_at(dc, j);
      if constexpr (AFFINE) {
        acc_g[j] += d * xhat;
        acc_b[j] += d;
      }
      const float dyg = d * gm.at(j);
      s1 += dyg;
      s2 += dyg * xhat;
    }
    const float2 sm = group_sum2(s1, s2, red[group], half, group);
    const float m1 = sm.x / kRowWidth, m2 = sm.y / kRowWidth;

    uint32_t out[kRowWords];
#pragma unroll
    for (int k = 0; k < kRowWords; ++k) {
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * k + e;
        const float xhat = (bf16_at(g, j) - mu) * rstd;
        const float dyg = bf16_at(dc, j) * gm.at(j);
        const float dg = round_to<__nv_bfloat16>(rstd * (dyg - m1 - xhat * m2));
        o[e] = dg * dgelu[j];
      }
      out[k] = pack_bf16(o[0], o[1]);
    }
    store_row(dx, row, t, out);
    if (next < rows) {
#pragma unroll
      for (int k = 0; k < kRowWords; ++k) {
        xc[k] = xn[k];
        dc[k] = dn[k];
      }
    }
  }
  if constexpr (AFFINE) {
    // the block's groups add their sums into its partial row (dgamma | dbeta)
    // in group order
    float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * kRowWidth;
    for (int i = 0; i < kRowGroups; ++i) {
      if (group == i) {
#pragma unroll
        for (int v = 0; v < kRowVectors; ++v) {
          const int c = (v * kRowLanes + t) * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float a = acc_g[8 * v + e], b = acc_b[8 * v + e];
            out[c + e] = i ? out[c + e] + a : a;
            out[kRowWidth + c + e] = i ? out[kRowWidth + c + e] + b : b;
          }
        }
      }
      __syncthreads();
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

cudaError_t launch_reduce(const float* partial, float* total, int n_blocks, int F,
                          cudaStream_t stream) {
  const int n = 2 * F;
  gelu_ln_bwd_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceRows),
                              0, stream>>>(partial, total, n_blocks, n);
  return cudaGetLastError();
}

template <typename T, bool AFFINE>
cudaError_t launch_gelu_ln_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                               float* partial, int rows, int F, int n_blocks, float eps,
                               bool param_f32, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (AFFINE ? 4 : 2) * F;
  const auto tx = static_cast<const T*>(x);
  const auto tdy = static_cast<const T*>(dy);
  const auto tdx = static_cast<T*>(dx);
  cudaError_t err;
  if (can_vectorize<T>(F, x, dy, dx)) {
    auto kernel = gelu_ln_bwd_kernel<T, 4, AFFINE>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, kLnThreads, bytes, stream>>>(tx, gamma, tdy, tdx, partial, rows, F, eps,
                                                    param_f32);
  } else {
    auto kernel = gelu_ln_bwd_kernel<T, 1, AFFINE>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, kLnThreads, bytes, stream>>>(tx, gamma, tdy, tdx, partial, rows, F, eps,
                                                    param_f32);
  }
  return cudaGetLastError();
}

// The row-resident kernel's grid: as many blocks as the card holds at once,
// asked once a kernel.
template <typename P, bool AFFINE>
int rows_bwd_grid(int rows) {
  static const int per_sm = row_blocks_per_sm(gelu_ln_bwd_rows_kernel<P, AFFINE>);
  return row_grid(per_sm, rows);
}

template <bool AFFINE>
cudaError_t launch_route(const void* x, const void* gamma, const void* dy, void* dx,
                         float* partial, int rows, int F, int n_blocks, float eps, int dtype,
                         bool param_f32, int route, cudaStream_t stream) {
  const auto bx = static_cast<const __nv_bfloat16*>(x);
  const auto bdy = static_cast<const __nv_bfloat16*>(dy);
  const auto bdx = static_cast<__nv_bfloat16*>(dx);
  if (route == 1 && param_f32)
    gelu_ln_bwd_rows_kernel<float, AFFINE><<<n_blocks, kRowThreads, 0, stream>>>(
        bx, static_cast<const float*>(gamma), bdy, bdx, partial, rows, eps);
  else if (route == 1)
    gelu_ln_bwd_rows_kernel<__nv_bfloat16, AFFINE><<<n_blocks, kRowThreads, 0, stream>>>(
        bx, static_cast<const __nv_bfloat16*>(gamma), bdy, bdx, partial, rows, eps);
  else if (dtype == 0)
    return launch_gelu_ln_bwd<float, AFFINE>(x, gamma, dy, dx, partial, rows, F, n_blocks, eps,
                                             param_f32, stream);
  else
    return launch_gelu_ln_bwd<__nv_bfloat16, AFFINE>(x, gamma, dy, dx, partial, rows, F,
                                                     n_blocks, eps, param_f32, stream);
  return cudaGetLastError();
}

// The arguments both entry points check: 0 if the route takes them.
inline cudaError_t check_bwd(int rows, int F, int dtype, int param_dtype, int route) {
  if (rows < 1 || F < 1 || F > kLnMaxFeatures || (dtype != 0 && dtype != 1) ||
      (param_dtype != 0 && param_dtype != dtype) || (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  if (route == 1 && !row_route(dtype, F, true)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace mt

// The row-resident frame's constants, which ops/gelu_ln.py copies for the
// CPU (the card tests hold the copies equal): what = 0 kRowWidth, 1
// kRowWarps, 2 kRowGroups, 3 the reduce kernel's thread rows; -1 else.
extern "C" int mt_gelu_ln_row_frame(int what) {
  const int frame[] = {mt::kRowWidth, mt::kRowWarps, mt::kRowGroups, mt::kReduceRows};
  return what >= 0 && what < 4 ? frame[what] : -1;
}

// The number of blocks mt_gelu_ln_bwd takes for these arguments on the
// current device (the partial scratch has as many rows), or minus a
// cudaError_t. The generic route: as many blocks as the card holds at once
// at 16 F bytes of shared memory each; the row-resident route: as many as
// the card holds at once of the variant (affine 0 or 1), at most one a
// kRowGroups rows.
extern "C" int mt_gelu_ln_bwd_blocks(int rows, int F, int dtype, int param_dtype, int route,
                                     int affine) {
  cudaError_t err = mt::check_bwd(rows, F, dtype, param_dtype, route);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (route == 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int per_sm = 200000 / (16 * F);
    per_sm = per_sm < 1 ? 1 : per_sm > 8 ? 8 : per_sm;
    return rows < sms * per_sm ? rows : sms * per_sm;
  }
  const bool pf32 = param_dtype == 0;
  const int grid = pf32 ? (affine ? mt::rows_bwd_grid<float, true>(rows)
                                  : mt::rows_bwd_grid<float, false>(rows))
                        : (affine ? mt::rows_bwd_grid<__nv_bfloat16, true>(rows)
                                  : mt::rows_bwd_grid<__nv_bfloat16, false>(rows));
  return grid > 0 ? grid : -static_cast<int>(cudaErrorUnknown);
}

// x, dy, dx (rows, F) contiguous in one dtype (0 = float32, 1 = bfloat16);
// gamma (F,) in param_dtype: 0 = float32, else the dtype of x. route 0: the
// generic kernel; 1: the row-resident kernel (bf16 x, F = 3072, every
// pointer aligned to 16 bytes). n_blocks: mt_gelu_ln_bwd_blocks
// of the same arguments. partial (n_blocks, 2, F) fp32 scratch and total
// (2, F) fp32 (dgamma, then dbeta) for the variant with dgamma and dbeta;
// both null for the variant without them, which launches one kernel.
// Returns a cudaError_t; 0 means every kernel was launched.
extern "C" int mt_gelu_ln_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                              void* partial, void* total, int rows, int F, int n_blocks,
                              float eps, int dtype, int param_dtype, int route, void* stream) {
  cudaError_t err = mt::check_bwd(rows, F, dtype, param_dtype, route);
  if (err != cudaSuccess) return err;
  const bool affine = partial != nullptr;
  if (n_blocks < 1 || n_blocks > rows || affine != (total != nullptr)) return cudaErrorInvalidValue;
  if (route == 1 && !(mt::aligned16(x) && mt::aligned16(gamma) && mt::aligned16(dy) &&
                      mt::aligned16(dx)))
    return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto pp = static_cast<float*>(partial);
  const bool pf32 = param_dtype == 0;
  if (!affine)
    return mt::launch_route<false>(x, gamma, dy, dx, nullptr, rows, F, n_blocks, eps, dtype, pf32,
                                   route, s);
  err = mt::launch_route<true>(x, gamma, dy, dx, pp, rows, F, n_blocks, eps, dtype, pf32, route,
                               s);
  if (err != cudaSuccess) return err;
  return mt::launch_reduce(pp, static_cast<float*>(total), n_blocks, F, s);
}
