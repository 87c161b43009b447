// Flash attention forward with the 2-D ALiBi bias computed per tile (K4f):
// the attention of the TITAN backbone's blocks.
//
// Replaces: modaltune_tpu/ops/alibi_flash.py::_fwd_kernel and
// ::_fwd_kernel_ah (the Pallas TPU kernels launched by _fwd_pallas, one head
// per grid step, and _fwd_pallas_ah, all heads per grid step: one function
// in two TPU tilings, and this kernel is the counterpart of both).
//
// Computes, for every batch row b, head h and query i:
//   s_j  = (q_i . k_j) * scale
//          - slope[h] * ||c_i - c_j||_2 * (1 - cls_i) * (1 - cls_j)
//          + bias[b, j]
//   out  = sum_j softmax(s)_j v_j        (a key with bias <= NEG_INF/2 gets
//                                          exactly zero weight)
//   lse  = log sum_j exp(s_j)            (NEG_INF and out = 0 when every key
//                                          of the row is masked)
// with coords[b, i] = [row, col, is_cls]. Layout q/k/v/out (B, H, N, D),
// coords (B, N, 3) fp32, slopes (H,) fp32, bias (B, N) fp32 or null, lse
// (B, H, N) fp32, all contiguous; q/k/v fp32 or bf16, fp32 statistics and
// accumulation.
//
// What bounds it on the H100: operations. At the TITAN geometry (3 task rows
// x 12 heads, N = 16,384, D = 64) the two products are 4 N^2 D x 36 = 2.47
// TFLOP against 0.3 GB of q/k/v/out, so the tensor cores' 989 TFLOP/s bound
// it at 2.5 ms; the distance term adds one sqrt, and the softmax one exp,
// per pair and head.
//
// What the design does about it: the dense (H, N, N) bias (12.9 GB in fp32 at
// this size) is never built: a block keeps its 64 query rows' coordinates in
// shared memory, loads each 64-key tile's coordinates beside k and v, and
// adds the term to the score on the fly (AlibiTerm). The grid is
// (N / 64, B * H): 9,216 blocks at N = 16,384, so no split over the keys is
// needed. Two kernels share that frame:
// * bf16 (the model's path): alibi_fwd_tc_kernel runs both products on the
//   tensor cores (wmma m16n16k16, fp32 accumulation). A warp owns 16 query
//   rows; its score tile passes through shared memory, where two lanes per
//   row apply scale, ALiBi term and key bias and keep the online-softmax
//   state in registers; the output accumulator stays in registers and is
//   rescaled there (fragment_rows says which row each element holds).
// * fp32 (tests and oracles): alibi_fwd_kernel is K2f's design on CUDA
//   cores in full fp32, four rows per warp.
// wgmma, TMA, overlapping the loads with the products, and computing the
// distance tile once for all heads are left for later work.
#include <type_traits>

#include "attention_tc_common.cuh"

namespace mt {

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
alibi_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ coords, const float* __restrict__ slopes,
                 const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
                 int H, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Tiles<DP> t(smem);
  float* qc = smem + Plan<DP>::floats;  // [3][kBlockQ]
  float* kc = qc + 3 * kBlockQ;         // [3][kBlockK]
  const AlibiTerm term{qc, kc};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, N - q0);

  const T* qb = q + (static_cast<size_t>(bh) * N + q0) * D;
  const T* kb = k + static_cast<size_t>(bh) * N * D;
  const T* vb = v + static_cast<size_t>(bh) * N * D;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;

  load_rows<DP, kBlockQ, Plan<DP>::QS>(t.q, qb, nq, D, scale,
                                       [D](int r) { return static_cast<size_t>(r) * D; });
  load_coords(qc, cb, q0, nq, slopes[bh % H]);
  t.init_state();

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    const int nk = min(kBlockK, N - k0);
    __syncthreads();  // the previous tile is consumed
    const auto row = [D, k0](int j) { return static_cast<size_t>(k0 + j) * D; };
    load_rows<DP, kBlockK, Plan<DP>::KS>(t.k, kb, nk, D, 1.f, row);
    load_rows<DP, kBlockK, DP>(t.v, vb, nk, D, 1.f, row);
    load_coords(kc, cb, k0, nk, 1.f);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads)
      t.bias[j] = (j < nk && biasb != nullptr) ? biasb[k0 + j] : 0.f;
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nq; r0 += kWarps * kRowsPerWarp)
      fold_rows<DP>(t, r0, 1, min(kRowsPerWarp, nq - r0), nk, warp, lane, term);
  }
  __syncthreads();

  for (int r = warp; r < nq; r += kWarps) {
    const float l = t.l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out + (static_cast<size_t>(bh) * N + q0 + r) * D;
    for (int d = lane; d < D; d += 32) o[d] = from_float<T>(t.acc[r * DP + d] * inv);
    if (lane == 0) lse[static_cast<size_t>(bh) * N + q0 + r] = l > 0.f ? t.m[r] + logf(l) : kNegInf;
  }
}

// bf16 on the tensor cores. Shared memory: the warps' fp32 patches, the
// per-row rescale factors, the coordinate planes and key bias, then the
// q, k and v tiles and the warps' bf16 probability tiles.
template <int DP>
struct AlibiFwdTcPlan {
  using P = TcPlan<DP>;
  static constexpr int floats = P::patch_floats + kBlockQ + 3 * kBlockQ + 3 * kBlockK + kBlockK;
  static constexpr size_t bytes =
      sizeof(float) * floats + sizeof(bf16) * (3 * P::tile_elems + P::p_elems);
  static_assert(bytes <= 232448, "over the H100's shared memory per block");
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
alibi_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ coords,
                    const float* __restrict__ slopes, const float* __restrict__ bias,
                    bf16* __restrict__ out, float* __restrict__ lse, int H, int N, int D,
                    float scale) {
  using P = TcPlan<DP>;
  constexpr int LD = P::LD, SS = P::SS;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  float* patches = reinterpret_cast<float*>(smem_tc);
  float* corrs = patches + P::patch_floats;
  float* qc = corrs + kBlockQ;    // [3][kBlockQ]
  float* kc = qc + 3 * kBlockQ;   // [3][kBlockK]
  float* kbias = kc + 3 * kBlockK;
  bf16* sq = reinterpret_cast<bf16*>(kbias + kBlockK);
  bf16* sk = sq + P::tile_elems;
  bf16* sv = sk + P::tile_elems;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* patch = patches + warp * kTcRows * SS;
  float* corr = corrs + warp * kTcRows;
  bf16* sp = sv + P::tile_elems + warp * kTcRows * kTcPS;

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, N - q0);
  const bf16* kb = k + static_cast<size_t>(bh) * N * D;
  const bf16* vb = v + static_cast<size_t>(bh) * N * D;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;

  load_tile_bf16<DP>(sq, q + (static_cast<size_t>(bh) * N + q0) * D, nq, D);
  load_coords(qc, cb, q0, nq, slopes[bh % H]);
  int rows[8];
  fragment_rows(patch, SS, lane, rows);
  FragC o[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) nvcuda::wmma::fill_fragment(o[n], 0.f);
  __syncthreads();

  // two lanes per query row: lane / 2 is the row, lane % 2 its keys' parity
  const int row = lane >> 1, half = lane & 1;
  const int qi = warp * kTcRows + row;
  const float qy = qc[qi], qx = qc[kBlockQ + qi], qw = qc[2 * kBlockQ + qi];
  float m_run = kNegInf, l_run = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    const int nk = min(kBlockK, N - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<DP>(sk, kb + static_cast<size_t>(k0) * D, nk, D);
    load_tile_bf16<DP>(sv, vb + static_cast<size_t>(k0) * D, nk, D);
    load_coords(kc, cb, k0, nk, 1.f);
    for (int j = threadIdx.x; j < kBlockK; j += kTcThreads)
      kbias[j] = j < nk ? (biasb == nullptr ? 0.f : biasb[k0 + j]) : kNegInf;
    __syncthreads();

    warp_scores<DP>(patch, sq + warp * kTcRows * LD, LD, sk);
    __syncwarp();
    float s[kBlockK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = 2 * j + half;
      const float dy = qy - kc[c], dx = qx - kc[kBlockK + c];
      const float term = -(qw * kc[2 * kBlockK + c]) * sqrtf(dy * dy + dx * dx);
      s[j] = kbias[c] > kMaskThreshold ? patch[row * SS + c] * scale + kbias[c] + term
                                       : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // never below NEG_INF, so finite
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const float e = __expf(s[j] - m_new);  // exp(-inf) == 0 for masked keys
      sp[row * kTcPS + 2 * j + half] = __float2bfloat16(e);
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float c_old = __expf(m_run - m_new);
    l_run = l_run * c_old + sum;
    m_run = m_new;
    if (half == 0) corr[row] = c_old;
    __syncwarp();

#pragma unroll
    for (int n = 0; n < DP / 16; ++n)
#pragma unroll
      for (int i = 0; i < o[n].num_elements; ++i) o[n].x[i] *= corr[rows[i]];
    warp_accumulate<DP>(o, sp, sv);
  }

  __syncwarp();
  if (half == 0) corr[row] = l_run > 0.f ? 1.f / l_run : 0.f;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
#pragma unroll
    for (int i = 0; i < o[n].num_elements; ++i) o[n].x[i] *= corr[rows[i]];
  const size_t row0 = static_cast<size_t>(bh) * N + q0 + warp * kTcRows;
  warp_store<DP>(out + row0 * D, D, nq - warp * kTcRows, o, patch, 1.f, lane);
  if (half == 0 && qi < nq) lse[row0 + row] = l_run > 0.f ? m_run + logf(l_run) : kNegInf;
}

template <int DP>
cudaError_t launch_alibi_tc(const void* q, const void* k, const void* v, const float* coords,
                            const float* slopes, const float* bias, void* out, float* lse, int B,
                            int H, int N, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = AlibiFwdTcPlan<DP>::bytes;
  auto kernel = alibi_fwd_tc_kernel<DP>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      coords, slopes, bias, static_cast<bf16*>(out), lse, H, N, D, scale);
  return cudaGetLastError();
}

template <int DP, typename T>
cudaError_t launch_alibi(const void* q, const void* k, const void* v, const float* coords,
                         const float* slopes, const float* bias, void* out, float* lse, int B,
                         int H, int N, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Plan<DP>::bytes + sizeof(float) * 3 * (kBlockQ + kBlockK);
  static_assert(bytes <= 232448, "over the H100's shared memory per block");
  auto kernel = alibi_fwd_kernel<DP, T>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), coords,
      slopes, bias, static_cast<T*>(out), lse, H, N, D, scale);
  return cudaGetLastError();
}

// fp32 goes to the CUDA-core kernel, bf16 to the tensor-core kernel.
template <typename T>
cudaError_t dispatch_alibi(int DP, const void* q, const void* k, const void* v,
                           const float* coords, const float* slopes, const float* bias,
                           void* out, float* lse, int B, int H, int N, int D, float scale,
                           cudaStream_t s) {
  switch (DP) {
#define MT_CASE(W)                                                                            \
  case W:                                                                                     \
    if constexpr (std::is_same<T, float>::value)                                              \
      return launch_alibi<W, T>(q, k, v, coords, slopes, bias, out, lse, B, H, N, D, scale,   \
                                s);                                                           \
    else                                                                                      \
      return launch_alibi_tc<W>(q, k, v, coords, slopes, bias, out, lse, B, H, N, D, scale, s);
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

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no masking).
// Returns a cudaError_t; 0 means the kernel was launched.
extern "C" int mt_alibi_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* coords, const void* slopes, const void* bias,
                                      void* out, void* lse, int B, int H, int N, int D,
                                      float scale, int dtype, void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || B < 1 || H < 1 || B * H > 65535 || N < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const float*>(coords);
  const auto sl = static_cast<const float*>(slopes);
  const auto bs = static_cast<const float*>(bias);
  const auto l = static_cast<float*>(lse);
  if (dtype == 0)
    return mt::dispatch_alibi<float>(DP, q, k, v, c, sl, bs, out, l, B, H, N, D, scale, s);
  if (dtype == 1)
    return mt::dispatch_alibi<__nv_bfloat16>(DP, q, k, v, c, sl, bs, out, l, B, H, N, D, scale,
                                             s);
  return cudaErrorInvalidValue;
}
