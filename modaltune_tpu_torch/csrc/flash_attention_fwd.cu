// Flash attention forward with an additive key bias, returning the LSE.
//
// Replaces: modaltune_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _fwd_pallas).
//
// Computes, for every (bh, query row i):
//   s_j  = (q_i . k_j) * scale + bias[bh, j]
//   out  = sum_j softmax(s)_j v_j         (a key with bias <= NEG_INF/2 gets
//                                           exactly zero weight)
//   lse  = log sum_j exp(s_j)             (NEG_INF and out = 0 when every key
//                                           of the row is masked)
// Layout (BH, L, D), contiguous; q/k/v fp32 or bf16, fp32 statistics and
// accumulation, out in the input dtype, lse fp32.
//
// What bounds it on the H100: on the adapter's shapes the head dimension is
// 16 and one side of the attention is short (65-66 tokens), so the work is a
// few GFLOP and the kernel is bound by latency and by the shared-memory
// reads of the fp32 CUDA-core inner loops, not by device memory. The
// Extractor shape (65 queries x 10,239 keys per bh) yields only
// 2 x BH blocks, well under the 132 SMs' worth of parallelism.
//
// What the design does about it: each block keeps a 64-row query tile and its
// softmax state in shared memory and streams 64-key tiles of K/V through
// shared memory, so K/V are read from device memory once per query tile.
// One warp updates four rows per key tile with the online-softmax recurrence
// (lanes over keys for q.k, over (row, head dimension) for p.V). It runs
// on CUDA cores in fp32. The adapter's own shapes (D = 16, one side of at
// most 128 rows) do not come here: the entry point below hands them to the
// short-side families (bf16: flash_short_side_fwd.cu, fp32 on 3xTF32:
// flash_short_side_tf32_fwd.cu), which split the long side over the card and
// run their products on the tensor cores; D = 48 (the per-branch dilated
// attention) goes to the wgmma family in bf16 (flash_wgmma_fwd.cu) and to
// the 3xTF32 family in fp32 (flash_tf32_fwd.cu). This file serves every
// other shape: other D, and both sides longer than 128 at D = 16.
#include "attention_common.cuh"
#include "flash_short_side_tf32.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma.cuh"

namespace mt {

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
                 int Lq, int Lk, int D, float scale) {
  extern __shared__ float4 smem4[];
  Tiles<DP> t(reinterpret_cast<float*>(smem4));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, Lq - q0);

  const T* qb = q + (static_cast<size_t>(bh) * Lq + q0) * D;
  const T* kb = k + static_cast<size_t>(bh) * Lk * D;
  const T* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh) * Lk;

  load_rows<DP, kBlockQ, Plan<DP>::QS>(t.q, qb, nq, D, scale,
                                       [D](int r) { return static_cast<size_t>(r) * D; });
  t.init_state();

  for (int k0 = 0; k0 < Lk; k0 += kBlockK) {
    const int nk = min(kBlockK, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    const auto row = [D, k0](int j) { return static_cast<size_t>(k0 + j) * D; };
    load_rows<DP, kBlockK, Plan<DP>::KS>(t.k, kb, nk, D, 1.f, row);
    load_rows<DP, kBlockK, DP>(t.v, vb, nk, D, 1.f, row);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads)
      t.bias[j] = (j < nk && biasb != nullptr) ? biasb[k0 + j] : 0.f;
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nq; r0 += kWarps * kRowsPerWarp)
      fold_rows<DP>(t, r0, 1, min(kRowsPerWarp, nq - r0), nk, warp, lane);
  }
  __syncthreads();

  for (int r = warp; r < nq; r += kWarps) {
    const float l = t.l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out + (static_cast<size_t>(bh) * Lq + q0 + r) * D;
    for (int d = lane; d < D; d += 32) o[d] = from_float<T>(t.acc[r * DP + d] * inv);
    if (lane == 0) lse[static_cast<size_t>(bh) * Lq + q0 + r] = l > 0.f ? t.m[r] + logf(l) : kNegInf;
  }
}

template <int DP, typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const float* bias, void* out,
                         float* lse, int BH, int Lq, int Lk, int D, float scale,
                         cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DP, T>;
  cudaError_t err = allow_smem(kernel, Plan<DP>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, BH);
  kernel<<<grid, kThreads, Plan<DP>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), lse, Lq, Lk, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int DP, const void* q, const void* k, const void* v, const float* bias,
                           void* out, float* lse, int BH, int Lq, int Lk, int D, float scale,
                           cudaStream_t s) {
  switch (DP) {
    case 16: return launch_flash<16, T>(q, k, v, bias, out, lse, BH, Lq, Lk, D, scale, s);
    case 32: return launch_flash<32, T>(q, k, v, bias, out, lse, BH, Lq, Lk, D, scale, s);
    case 48: return launch_flash<48, T>(q, k, v, bias, out, lse, BH, Lq, Lk, D, scale, s);
    case 64: return launch_flash<64, T>(q, k, v, bias, out, lse, BH, Lq, Lk, D, scale, s);
    case 128: return launch_flash<128, T>(q, k, v, bias, out, lse, BH, Lq, Lk, D, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mt

// The name of a cudaError_t returned by the entry points of this library.
extern "C" const char* mt_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// Which kernels serve a call (mt::ss::Family): 0 the CUDA-core kernels of
// this file, 1 short keys, 2 short queries, 3 the wgmma family
// (flash_wgmma.cuh), 4 and 5 short keys and short queries at fp32
// (flash_short_side_tf32.cuh), 6 the 3xTF32 family at D = 48
// (flash_tf32.cuh).
extern "C" int mt_flash_attention_family(int Lq, int Lk, int D, int dtype) {
  return mt::ss::family(Lq, Lk, D, dtype);
}

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no masking). chunks and
// work: the split of the long side and the fp32 scratch of the short-side
// families, which the wrapper sizes (ops/flash_attention.py); the CUDA-core
// kernels and the wgmma family take neither. Returns a cudaError_t; 0 means
// the kernels were launched.
extern "C" int mt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, void* lse, int BH, int Lq,
                                      int Lk, int D, float scale, int dtype, int chunks,
                                      void* work, void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || BH < 1 || BH > 65535 || Lq < 1 || Lk < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const float*>(bias);
  const auto l = static_cast<float*>(lse);
  const int fam = mt::ss::family(Lq, Lk, D, dtype);
  using mt::bf16;
  if (fam == mt::ss::kWgmma)
    return mt::launch_flash_wgmma_fwd(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                      static_cast<const bf16*>(v), b, static_cast<bf16*>(out), l,
                                      BH, Lq, Lk, scale, s);
  if (fam == mt::ss::kTf32x3)
    return mt::launch_flash_tf32_fwd(static_cast<const float*>(q), static_cast<const float*>(k),
                                     static_cast<const float*>(v), b, static_cast<float*>(out), l,
                                     BH, Lq, Lk, scale, s);
  if (fam == mt::ss::kShortKeysTf32 || fam == mt::ss::kShortQueriesTf32)
    return mt::sst::launch_fwd(fam, static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), b, static_cast<float*>(out), l, BH,
                               Lq, Lk, scale, chunks, static_cast<float*>(work), s);
  if (fam != mt::ss::kCudaCores) {
    return mt::ss::launch_fwd(fam, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), b, static_cast<bf16*>(out), l, BH, Lq,
                              Lk, scale, chunks, static_cast<float*>(work), s);
  }
  if (dtype == 0) return mt::dispatch_flash<float>(DP, q, k, v, b, out, l, BH, Lq, Lk, D, scale, s);
  if (dtype == 1)
    return mt::dispatch_flash<__nv_bfloat16>(DP, q, k, v, b, out, l, BH, Lq, Lk, D, scale, s);
  return cudaErrorInvalidValue;
}
