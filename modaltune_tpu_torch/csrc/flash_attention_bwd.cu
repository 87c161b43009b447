// Flash attention backward with an additive key bias (K2b).
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the Pallas TPU kernels launched by _bwd_pallas).
//
// Computes, from the forward's lse and delta = rowsum(dout * out) (taken by
// the wrapper, as _bwd_pallas takes it outside its kernels), for every bh:
//   P  = exp(q k^T * scale + bias - lse)   (0 for a key with bias <= NEG_INF/2;
//                                           a row whose keys are all masked
//                                           gets zero gradients)
//   dS = P * (dout v^T - delta)
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dout
// Layout (BH, L, D), contiguous; q/k/v/dout fp32 or bf16, lse/delta/bias
// fp32; fp32 accumulation, gradients in the input dtype.
//
// What bounds it on the H100: at the adapter's shapes (D = 16, one side 65
// tokens) the work is a few GFLOP on CUDA cores, so it is bound by latency
// and shared-memory reads, not by device memory. The dq kernel at the
// Extractor shape (65 queries per bh) and the dk/dv kernel at the Injector
// shape (65 keys per bh) have only 2 x BH = 72 blocks for 132 SMs.
//
// What the design does about it: two kernels and no atomics. The dq kernel's
// block owns 64 query rows and streams 64-key tiles; the dk/dv kernel's
// block owns 64 key rows and streams 64-query tiles (attention_bwd_common.cuh
// has the shared update). The adapter's own shapes (D = 16, one side of at
// most 128 rows) do not come here: the entry point below hands them to the
// short-side families (bf16: flash_short_side_bwd.cu, fp32 on 3xTF32:
// flash_short_side_tf32_bwd.cu), which split the long side over the card,
// make delta themselves and run their products on the tensor cores; D = 48
// (the per-branch dilated attention) goes to the wgmma family in bf16
// (flash_wgmma_bwd.cu) and to the 3xTF32 family in fp32
// (flash_tf32_bwd.cu). This file serves every other shape: other D, and
// both sides longer than 128 at D = 16.
#include "attention_bwd_common.cuh"
#include "flash_short_side_tf32.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma.cuh"

namespace mt {

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Lq, int Lk, int D, float scale) {
  extern __shared__ float4 smem4[];
  BwdTiles<DP, false> t(reinterpret_cast<float*>(smem4));
  constexpr int S = BwdPlan<DP, false>::S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, Lq - q0);
  const size_t qrow0 = static_cast<size_t>(bh) * Lq + q0;
  const T* kb = k + static_cast<size_t>(bh) * Lk * D;
  const T* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh) * Lk;
  const auto qrow = [D](int r) { return static_cast<size_t>(r) * D; };

  load_rows<DP, kBlockQ, S>(t.a1, q + qrow0 * D, nq, D, scale, qrow);
  load_rows<DP, kBlockQ, S>(t.a2, dout + qrow0 * D, nq, D, 1.f, qrow);
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    t.lse[i] = i < nq ? lse_for_bwd(lse[qrow0 + i]) : 0.f;
    t.w[i] = 1.f;
    t.delta[i] = i < nq ? delta[qrow0 + i] : 0.f;
  }
  t.zero_acc();

  for (int k0 = 0; k0 < Lk; k0 += kBlockK) {
    const int nk = min(kBlockK, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    const auto krow = [D, k0](int j) { return static_cast<size_t>(k0 + j) * D; };
    load_rows<DP, kBlockK, S>(t.b1, kb, nk, D, 1.f, krow);
    load_rows<DP, kBlockK, S>(t.b2, vb, nk, D, 1.f, krow);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads)
      t.bias[j] = j < nk ? (biasb == nullptr ? 0.f : biasb[k0 + j]) : kNegInf;
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nq; r0 += kWarps * kRowsPerWarp)
      bwd_fold<DP, false>(t, r0, 1, min(kRowsPerWarp, nq - r0), nk, warp, lane);
  }
  __syncthreads();
  store_rows<DP>(dq + qrow0 * D, t.acc1, nq, D, scale, qrow);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int D, float scale) {
  extern __shared__ float4 smem4[];
  BwdTiles<DP, true> t(reinterpret_cast<float*>(smem4));
  constexpr int S = BwdPlan<DP, true>::S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
  const int nk = min(kBlockK, Lk - k0);
  const size_t krow0 = static_cast<size_t>(bh) * Lk + k0;
  const size_t qrow0 = static_cast<size_t>(bh) * Lq;
  const auto row = [D](int r) { return static_cast<size_t>(r) * D; };

  load_rows<DP, kBlockK, S>(t.a1, k + krow0 * D, nk, D, 1.f, row);
  load_rows<DP, kBlockK, S>(t.a2, v + krow0 * D, nk, D, 1.f, row);
  for (int j = threadIdx.x; j < kBlockK; j += kThreads)
    t.bias[j] = j < nk ? (bias == nullptr ? 0.f : bias[krow0 + j]) : kNegInf;
  t.zero_acc();

  for (int q0 = 0; q0 < Lq; q0 += kBlockQ) {
    const int nq = min(kBlockQ, Lq - q0);
    __syncthreads();  // the previous tile is consumed
    const auto qrow = [D, q0](int i) { return static_cast<size_t>(q0 + i) * D; };
    load_rows<DP, kBlockQ, S>(t.b1, q + qrow0 * D, nq, D, scale, qrow);
    load_rows<DP, kBlockQ, S>(t.b2, dout + qrow0 * D, nq, D, 1.f, qrow);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      t.lse[i] = i < nq ? lse_for_bwd(lse[qrow0 + q0 + i]) : 0.f;
      t.w[i] = 1.f;
      t.delta[i] = i < nq ? delta[qrow0 + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nk; r0 += kWarps * kRowsPerWarp)
      bwd_fold<DP, true>(t, r0, 1, min(kRowsPerWarp, nk - r0), nq, warp, lane);
  }
  __syncthreads();
  store_rows<DP>(dv + krow0 * D, t.acc1, nk, D, 1.f, row);
  store_rows<DP>(dk + krow0 * D, t.acc2, nk, D, 1.f, row);
}

template <int DP, typename T>
cudaError_t launch_flash_bwd(const void* q, const void* k, const void* v, const float* bias,
                             const void* dout, const float* lse, const float* delta, void* dq,
                             void* dk, void* dv, int BH, int Lq, int Lk, int D, float scale,
                             cudaStream_t stream) {
  auto kq = flash_bwd_dq_kernel<DP, T>;
  auto kkv = flash_bwd_dkv_kernel<DP, T>;
  cudaError_t err = allow_smem(kq, BwdPlan<DP, false>::bytes);
  if (err == cudaSuccess) err = allow_smem(kkv, BwdPlan<DP, true>::bytes);
  if (err != cudaSuccess) return err;
  const auto tq = static_cast<const T*>(q);
  const auto tk = static_cast<const T*>(k);
  const auto tv = static_cast<const T*>(v);
  const auto tdo = static_cast<const T*>(dout);
  kq<<<dim3((Lq + kBlockQ - 1) / kBlockQ, BH), kThreads, BwdPlan<DP, false>::bytes, stream>>>(
      tq, tk, tv, bias, tdo, lse, delta, static_cast<T*>(dq), Lq, Lk, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3((Lk + kBlockK - 1) / kBlockK, BH), kThreads, BwdPlan<DP, true>::bytes, stream>>>(
      tq, tk, tv, bias, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, D,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash_bwd(int DP, const void* q, const void* k, const void* v,
                               const float* bias, const void* dout, const float* lse,
                               const float* delta, void* dq, void* dk, void* dv, int BH, int Lq,
                               int Lk, int D, float scale, cudaStream_t s) {
  switch (DP) {
#define MT_CASE(N)                                                                            \
  case N:                                                                                     \
    return launch_flash_bwd<N, T>(q, k, v, bias, dout, lse, delta, dq, dk, dv, BH, Lq, Lk, D, \
                                  scale, s);
    MT_CASE(16)
    MT_CASE(32)
    MT_CASE(48)
    MT_CASE(64)
    MT_CASE(128)
#undef MT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mt

// q/k/v/dout/out/dq/dk/dv (BH, L, D) contiguous in one dtype (0 = float32,
// 1 = bfloat16); bias (BH, Lk) fp32 or null; lse and delta (BH, Lq) fp32.
// The CUDA-core kernels read delta = rowsum(dout * out) and not out; the
// short-side families (bf16 and fp32) read out, make delta themselves, and
// take chunks and the fp32 scratch `work` that the wrapper sizes
// (ops/flash_attention.py); the
// wgmma family reads out and makes delta into `work`, (BH, Lq) floats; the
// 3xTF32 family writes vbar of every bh and then delta into `work`, (BH,
// 48) and (BH, Lq) floats.
// Returns a cudaError_t; 0 means every kernel was launched.
extern "C" int mt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* bias, const void* dout, const void* out,
                                      const void* lse, const void* delta, void* dq, void* dk,
                                      void* dv, int BH, int Lq, int Lk, int D, float scale,
                                      int dtype, int chunks, void* work, void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || BH < 1 || BH > 65535 || Lq < 1 || Lk < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const float*>(bias);
  const auto l = static_cast<const float*>(lse);
  const int fam = mt::ss::family(Lq, Lk, D, dtype);
  using mt::bf16;
  if (fam == mt::ss::kWgmma)
    return mt::launch_flash_wgmma_bwd(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), b,
        static_cast<const bf16*>(dout), static_cast<const bf16*>(out), l,
        static_cast<float*>(work), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), BH, Lq, Lk, scale, s);
  if (fam == mt::ss::kTf32x3)
    return mt::launch_flash_tf32_bwd(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        b, static_cast<const float*>(dout), static_cast<const float*>(out), l,
        static_cast<float*>(work), static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), BH, Lq, Lk, scale, s);
  if (fam == mt::ss::kShortKeysTf32 || fam == mt::ss::kShortQueriesTf32)
    return mt::sst::launch_bwd(fam, static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), b, static_cast<const float*>(dout),
                               static_cast<const float*>(out), l, static_cast<float*>(dq),
                               static_cast<float*>(dk), static_cast<float*>(dv), BH, Lq, Lk,
                               scale, chunks, static_cast<float*>(work), s);
  if (fam != mt::ss::kCudaCores) {
    return mt::ss::launch_bwd(fam, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), b, static_cast<const bf16*>(dout),
                              static_cast<const bf16*>(out), l, static_cast<bf16*>(dq),
                              static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, Lq, Lk, scale,
                              chunks, static_cast<float*>(work), s);
  }
  const auto dl = static_cast<const float*>(delta);
  if (dl == nullptr) return cudaErrorInvalidValue;
  if (dtype == 0)
    return mt::dispatch_flash_bwd<float>(DP, q, k, v, b, dout, l, dl, dq, dk, dv, BH, Lq, Lk, D,
                                         scale, s);
  if (dtype == 1)
    return mt::dispatch_flash_bwd<__nv_bfloat16>(DP, q, k, v, b, dout, l, dl, dq, dk, dv, BH, Lq,
                                                 Lk, D, scale, s);
  return cudaErrorInvalidValue;
}
