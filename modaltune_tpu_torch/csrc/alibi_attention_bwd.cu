// Flash attention backward with the 2-D ALiBi bias computed per tile (K4b).
//
// Replaces: modaltune_tpu/ops/alibi_flash.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels launched by _bwd_pallas) and their all-heads
// variants ::_dq_kernel_ah and ::_dkv_kernel_ah (launched by _bwd_pallas_ah).
//
// Computes, from the forward's lse and delta = rowsum(dout * out) (taken by
// the wrapper, as _bwd_pallas takes it outside its kernels), for every batch
// row b and head h:
//   s  = q k^T * scale - slope[h] * dist * not_cls + bias[b]   (the forward's)
//   P  = exp(s - lse)          (0 for a key with bias <= NEG_INF/2; a row
//                               whose keys are all masked gets zero gradients)
//   dS = P * (dout v^T - delta)
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dout
// coords, slopes and bias get no gradient. Layout q/k/v/dout/dq/dk/dv
// (B, H, N, D), coords (B, N, 3), slopes (H,), bias (B, N) or null, lse and
// delta (B, H, N); fp32 accumulation, gradients in the input dtype.
//
// What bounds it on the H100: operations. The five products a backward needs
// are 10 N^2 D per (b, h), 6.2 TFLOP at 3 x 12 x 16,384 x 64: 6.2 ms at the
// tensor cores' 989 TFLOP/s. The two kernels here recompute q.k and dout.v
// each, seven products in all.
//
// What the design does about it: K2b's pair of kernels without atomics (a dq
// kernel whose block owns 64 query rows and streams the keys, a dk/dv kernel
// whose block owns 64 key rows and streams the queries), with the ALiBi term
// recomputed per pair from the two tiles' coordinates in shared memory, so
// neither the bias nor P is ever in device memory. Each grid has
// (N / 64) x B * H blocks (9,216 at N = 16,384). For bf16 (the model's path)
// the *_tc kernels run every product on the tensor cores (wmma m16n16k16,
// fp32 accumulation): a warp owns 16 rows, its score and dout.v tiles pass
// through shared memory, two lanes per row turn them into P and dS, which go
// back as bf16 for the gradient products. For fp32 (tests and oracles) the
// kernels are K2b's on CUDA cores. wgmma, TMA and overlapping the loads
// with the products are left for later work.
#include <type_traits>

#include "attention_bwd_common.cuh"
#include "attention_tc_common.cuh"

namespace mt {

template <int DP, bool DUAL>
constexpr size_t alibi_bwd_bytes() {
  return BwdPlan<DP, DUAL>::bytes + sizeof(float) * 3 * (kBlockQ + kBlockK);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
alibi_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ coords, const float* __restrict__ slopes,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  BwdTiles<DP, false> t(smem);
  constexpr int S = BwdPlan<DP, false>::S;
  float* qc = smem + BwdPlan<DP, false>::floats;  // [3][kBlockQ]
  float* kc = qc + 3 * kBlockQ;                   // [3][kBlockK]
  const AlibiTerm term{qc, kc};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, N - q0);
  const size_t qrow0 = static_cast<size_t>(bh) * N + q0;
  const T* kb = k + static_cast<size_t>(bh) * N * D;
  const T* vb = v + static_cast<size_t>(bh) * N * D;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;
  const auto qrow = [D](int r) { return static_cast<size_t>(r) * D; };

  load_rows<DP, kBlockQ, S>(t.a1, q + qrow0 * D, nq, D, scale, qrow);
  load_rows<DP, kBlockQ, S>(t.a2, dout + qrow0 * D, nq, D, 1.f, qrow);
  load_coords(qc, cb, q0, nq, slopes[bh % H]);
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    t.lse[i] = i < nq ? lse_for_bwd(lse[qrow0 + i]) : 0.f;
    t.w[i] = 1.f;
    t.delta[i] = i < nq ? delta[qrow0 + i] : 0.f;
  }
  t.zero_acc();

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    const int nk = min(kBlockK, N - k0);
    __syncthreads();  // the previous tile is consumed
    const auto krow = [D, k0](int j) { return static_cast<size_t>(k0 + j) * D; };
    load_rows<DP, kBlockK, S>(t.b1, kb, nk, D, 1.f, krow);
    load_rows<DP, kBlockK, S>(t.b2, vb, nk, D, 1.f, krow);
    load_coords(kc, cb, k0, nk, 1.f);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads)
      t.bias[j] = j < nk ? (biasb == nullptr ? 0.f : biasb[k0 + j]) : kNegInf;
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nq; r0 += kWarps * kRowsPerWarp)
      bwd_fold<DP, false>(t, r0, 1, min(kRowsPerWarp, nq - r0), nk, warp, lane, term);
  }
  __syncthreads();
  store_rows<DP>(dq + qrow0 * D, t.acc1, nq, D, scale, qrow);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
alibi_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ coords, const float* __restrict__ slopes,
                     const float* __restrict__ bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  BwdTiles<DP, true> t(smem);
  constexpr int S = BwdPlan<DP, true>::S;
  float* qc = smem + BwdPlan<DP, true>::floats;  // [3][kBlockQ]
  float* kc = qc + 3 * kBlockQ;                  // [3][kBlockK]
  const AlibiTerm term{qc, kc};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * kBlockK;
  const int nk = min(kBlockK, N - k0);
  const size_t krow0 = static_cast<size_t>(bh) * N + k0;
  const size_t qrow0 = static_cast<size_t>(bh) * N;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float slope = slopes[bh % H];
  const auto row = [D](int r) { return static_cast<size_t>(r) * D; };

  load_rows<DP, kBlockK, S>(t.a1, k + krow0 * D, nk, D, 1.f, row);
  load_rows<DP, kBlockK, S>(t.a2, v + krow0 * D, nk, D, 1.f, row);
  load_coords(kc, cb, k0, nk, 1.f);
  for (int j = threadIdx.x; j < kBlockK; j += kThreads)
    t.bias[j] = j < nk ? (bias == nullptr ? 0.f : bias[static_cast<size_t>(b) * N + k0 + j])
                       : kNegInf;
  t.zero_acc();

  for (int q0 = 0; q0 < N; q0 += kBlockQ) {
    const int nq = min(kBlockQ, N - q0);
    __syncthreads();  // the previous tile is consumed
    const auto qrow = [D, q0](int i) { return static_cast<size_t>(q0 + i) * D; };
    load_rows<DP, kBlockQ, S>(t.b1, q + qrow0 * D, nq, D, scale, qrow);
    load_rows<DP, kBlockQ, S>(t.b2, dout + qrow0 * D, nq, D, 1.f, qrow);
    load_coords(qc, cb, q0, nq, slope);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      t.lse[i] = i < nq ? lse_for_bwd(lse[qrow0 + q0 + i]) : 0.f;
      t.w[i] = 1.f;
      t.delta[i] = i < nq ? delta[qrow0 + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int r0 = warp * kRowsPerWarp; r0 < nk; r0 += kWarps * kRowsPerWarp)
      bwd_fold<DP, true>(t, r0, 1, min(kRowsPerWarp, nk - r0), nq, warp, lane, term);
  }
  __syncthreads();
  store_rows<DP>(dv + krow0 * D, t.acc1, nk, D, 1.f, row);
  store_rows<DP>(dk + krow0 * D, t.acc2, nk, D, 1.f, row);
}

// bf16 on the tensor cores. Shared memory of both kernels: two fp32 patches
// per warp (scores, dout.v), per-row lse and delta, the coordinate planes
// and key bias, then four bf16 tiles (own q/dout or k/v, streamed k/v or
// q/dout) and the warps' bf16 dS (and P) tiles.
template <int DP, bool DUAL>
struct AlibiBwdTcPlan {
  using P = TcPlan<DP>;
  static constexpr int floats =
      2 * P::patch_floats + 2 * kBlockQ + 3 * kBlockQ + 3 * kBlockK + kBlockK;
  static constexpr size_t bytes =
      sizeof(float) * floats + sizeof(bf16) * (4 * P::tile_elems + (DUAL ? 2 : 1) * P::p_elems);
  static_assert(bytes <= 232448, "over the H100's shared memory per block");
};

template <int DP, bool DUAL>
struct AlibiBwdTcSmem {
  using P = TcPlan<DP>;
  float *patch1, *patch2, *lse, *delta, *qc, *kc, *kbias;
  bf16 *own1, *own2, *oth1, *oth2, *p1, *p2;

  __device__ AlibiBwdTcSmem(unsigned char* raw, int warp) {
    float* f = reinterpret_cast<float*>(raw);
    patch1 = f + warp * kTcRows * P::SS;
    patch2 = patch1 + P::patch_floats;
    lse = f + 2 * P::patch_floats;
    delta = lse + kBlockQ;
    qc = delta + kBlockQ;
    kc = qc + 3 * kBlockQ;
    kbias = kc + 3 * kBlockK;
    own1 = reinterpret_cast<bf16*>(kbias + kBlockK);
    own2 = own1 + P::tile_elems;
    oth1 = own2 + P::tile_elems;
    oth2 = oth1 + P::tile_elems;
    p1 = oth2 + P::tile_elems + warp * kTcRows * kTcPS;
    p2 = p1 + P::p_elems;
  }
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
alibi_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ coords,
                       const float* __restrict__ slopes, const float* __restrict__ bias,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq, int H, int N, int D,
                       float scale) {
  using P = TcPlan<DP>;
  constexpr int LD = P::LD, SS = P::SS;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const AlibiBwdTcSmem<DP, false> t(smem_tc, warp);
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, N - q0);
  const size_t qrow0 = static_cast<size_t>(bh) * N + q0;
  const bf16* kb = k + static_cast<size_t>(bh) * N * D;
  const bf16* vb = v + static_cast<size_t>(bh) * N * D;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;

  load_tile_bf16<DP>(t.own1, q + qrow0 * D, nq, D);
  load_tile_bf16<DP>(t.own2, dout + qrow0 * D, nq, D);
  load_coords(t.qc, cb, q0, nq, slopes[bh % H]);
  FragC acc[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) nvcuda::wmma::fill_fragment(acc[n], 0.f);
  __syncthreads();

  // two lanes per query row: lane / 2 is the row, lane % 2 its keys' parity
  const int row = lane >> 1, half = lane & 1;
  const int qi = warp * kTcRows + row;
  const float qy = t.qc[qi], qx = t.qc[kBlockQ + qi], qw = t.qc[2 * kBlockQ + qi];
  const float lse_r = qi < nq ? lse_for_bwd(lse[qrow0 + qi]) : 0.f;
  const float delta_r = qi < nq ? delta[qrow0 + qi] : 0.f;

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    const int nk = min(kBlockK, N - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<DP>(t.oth1, kb + static_cast<size_t>(k0) * D, nk, D);
    load_tile_bf16<DP>(t.oth2, vb + static_cast<size_t>(k0) * D, nk, D);
    load_coords(t.kc, cb, k0, nk, 1.f);
    for (int j = threadIdx.x; j < kBlockK; j += kTcThreads)
      t.kbias[j] = j < nk ? (biasb == nullptr ? 0.f : biasb[k0 + j]) : kNegInf;
    __syncthreads();

    warp_scores<DP>(t.patch1, t.own1 + warp * kTcRows * LD, LD, t.oth1);  // q.k
    warp_scores<DP>(t.patch2, t.own2 + warp * kTcRows * LD, LD, t.oth2);  // dout.v
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = 2 * j + half;
      float ds = 0.f;
      if (t.kbias[c] > kMaskThreshold) {
        const float dy = qy - t.kc[c], dx = qx - t.kc[kBlockK + c];
        const float term = -(qw * t.kc[2 * kBlockK + c]) * sqrtf(dy * dy + dx * dx);
        const float p = __expf(t.patch1[row * SS + c] * scale + t.kbias[c] + term - lse_r);
        ds = p * (t.patch2[row * SS + c] - delta_r);
      }
      t.p1[row * kTcPS + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_accumulate<DP>(acc, t.p1, t.oth1);  // dq += dS k
  }
  warp_store<DP>(dq + (qrow0 + warp * kTcRows) * D, D, nq - warp * kTcRows, acc, t.patch1, scale,
                 lane);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
alibi_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ coords,
                        const float* __restrict__ slopes, const float* __restrict__ bias,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int N, int D, float scale) {
  using P = TcPlan<DP>;
  constexpr int LD = P::LD, SS = P::SS;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const AlibiBwdTcSmem<DP, true> t(smem_tc, warp);
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * kBlockK;
  const int nk = min(kBlockK, N - k0);
  const size_t krow0 = static_cast<size_t>(bh) * N + k0;
  const size_t qrow0 = static_cast<size_t>(bh) * N;
  const float* cb = coords + static_cast<size_t>(b) * N * 3;
  const float slope = slopes[bh % H];

  load_tile_bf16<DP>(t.own1, k + krow0 * D, nk, D);
  load_tile_bf16<DP>(t.own2, v + krow0 * D, nk, D);
  load_coords(t.kc, cb, k0, nk, 1.f);
  FragC acc_dv[DP / 16], acc_dk[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) {
    nvcuda::wmma::fill_fragment(acc_dv[n], 0.f);
    nvcuda::wmma::fill_fragment(acc_dk[n], 0.f);
  }
  __syncthreads();

  // two lanes per key row: lane / 2 is the row, lane % 2 its queries' parity
  const int row = lane >> 1, half = lane & 1;
  const int kj = warp * kTcRows + row;
  const float ky = t.kc[kj], kx = t.kc[kBlockK + kj], kw = t.kc[2 * kBlockK + kj];
  const float kbias =
      kj < nk ? (bias == nullptr ? 0.f : bias[static_cast<size_t>(b) * N + k0 + kj]) : kNegInf;
  const bool live = kbias > kMaskThreshold;

  for (int q0 = 0; q0 < N; q0 += kBlockQ) {
    const int nq = min(kBlockQ, N - q0);
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<DP>(t.oth1, q + (qrow0 + q0) * D, nq, D);
    load_tile_bf16<DP>(t.oth2, dout + (qrow0 + q0) * D, nq, D);
    load_coords(t.qc, cb, q0, nq, slope);
    for (int i = threadIdx.x; i < kBlockQ; i += kTcThreads) {
      // a query row past the end gets a huge lse, so its P underflows to 0
      t.lse[i] = i < nq ? lse_for_bwd(lse[qrow0 + q0 + i]) : -kMaskThreshold;
      t.delta[i] = i < nq ? delta[qrow0 + q0 + i] : 0.f;
    }
    __syncthreads();

    warp_scores<DP>(t.patch1, t.own1 + warp * kTcRows * LD, LD, t.oth1);  // (q.k)^T
    warp_scores<DP>(t.patch2, t.own2 + warp * kTcRows * LD, LD, t.oth2);  // (dout.v)^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < kBlockQ / 2; ++j) {
      const int c = 2 * j + half;  // the query of the pair
      float p = 0.f, ds = 0.f;
      if (live) {
        const float dy = t.qc[c] - ky, dx = t.qc[kBlockQ + c] - kx;
        const float term = -(t.qc[2 * kBlockQ + c] * kw) * sqrtf(dy * dy + dx * dx);
        p = __expf(t.patch1[row * SS + c] * scale + kbias + term - t.lse[c]);
        ds = p * (t.patch2[row * SS + c] - t.delta[c]);
      }
      t.p1[row * kTcPS + c] = __float2bfloat16(p);
      t.p2[row * kTcPS + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_accumulate<DP>(acc_dv, t.p1, t.oth2);  // dv += P^T dout
    warp_accumulate<DP>(acc_dk, t.p2, t.oth1);  // dk += dS^T q
  }
  const size_t row0 = krow0 + warp * kTcRows;
  warp_store<DP>(dv + row0 * D, D, nk - warp * kTcRows, acc_dv, t.patch1, 1.f, lane);
  warp_store<DP>(dk + row0 * D, D, nk - warp * kTcRows, acc_dk, t.patch1, scale, lane);
}

template <int DP>
cudaError_t launch_alibi_bwd_tc(const void* q, const void* k, const void* v, const float* coords,
                                const float* slopes, const float* bias, const void* dout,
                                const float* lse, const float* delta, void* dq, void* dk,
                                void* dv, int B, int H, int N, int D, float scale,
                                cudaStream_t stream) {
  constexpr size_t bytes_q = AlibiBwdTcPlan<DP, false>::bytes;
  constexpr size_t bytes_kv = AlibiBwdTcPlan<DP, true>::bytes;
  auto kq = alibi_bwd_dq_tc_kernel<DP>;
  auto kkv = alibi_bwd_dkv_tc_kernel<DP>;
  cudaError_t err = allow_smem(kq, bytes_q);
  if (err == cudaSuccess) err = allow_smem(kkv, bytes_kv);
  if (err != cudaSuccess) return err;
  const auto tq = static_cast<const bf16*>(q);
  const auto tk = static_cast<const bf16*>(k);
  const auto tv = static_cast<const bf16*>(v);
  const auto tdo = static_cast<const bf16*>(dout);
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  kq<<<grid, kTcThreads, bytes_q, stream>>>(tq, tk, tv, coords, slopes, bias, tdo, lse, delta,
                                            static_cast<bf16*>(dq), H, N, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid, kTcThreads, bytes_kv, stream>>>(tq, tk, tv, coords, slopes, bias, tdo, lse, delta,
                                              static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
                                              N, D, scale);
  return cudaGetLastError();
}

template <int DP, typename T>
cudaError_t launch_alibi_bwd(const void* q, const void* k, const void* v, const float* coords,
                             const float* slopes, const float* bias, const void* dout,
                             const float* lse, const float* delta, void* dq, void* dk, void* dv,
                             int B, int H, int N, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes_q = alibi_bwd_bytes<DP, false>();
  constexpr size_t bytes_kv = alibi_bwd_bytes<DP, true>();
  static_assert(bytes_kv <= 232448, "over the H100's shared memory per block");
  auto kq = alibi_bwd_dq_kernel<DP, T>;
  auto kkv = alibi_bwd_dkv_kernel<DP, T>;
  cudaError_t err = allow_smem(kq, bytes_q);
  if (err == cudaSuccess) err = allow_smem(kkv, bytes_kv);
  if (err != cudaSuccess) return err;
  const auto tq = static_cast<const T*>(q);
  const auto tk = static_cast<const T*>(k);
  const auto tv = static_cast<const T*>(v);
  const auto tdo = static_cast<const T*>(dout);
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  kq<<<grid, kThreads, bytes_q, stream>>>(tq, tk, tv, coords, slopes, bias, tdo, lse, delta,
                                          static_cast<T*>(dq), H, N, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid, kThreads, bytes_kv, stream>>>(tq, tk, tv, coords, slopes, bias, tdo, lse, delta,
                                            static_cast<T*>(dk), static_cast<T*>(dv), H, N, D,
                                            scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_alibi_bwd(int DP, const void* q, const void* k, const void* v,
                               const float* coords, const float* slopes, const float* bias,
                               const void* dout, const float* lse, const float* delta, void* dq,
                               void* dk, void* dv, int B, int H, int N, int D, float scale,
                               cudaStream_t s) {
  // fp32 goes to the CUDA-core kernels, bf16 to the tensor-core kernels
  switch (DP) {
#define MT_CASE(W)                                                                               \
  case W:                                                                                        \
    if constexpr (std::is_same<T, float>::value)                                                 \
      return launch_alibi_bwd<W, T>(q, k, v, coords, slopes, bias, dout, lse, delta, dq, dk, dv, \
                                    B, H, N, D, scale, s);                                       \
    else                                                                                         \
      return launch_alibi_bwd_tc<W>(q, k, v, coords, slopes, bias, dout, lse, delta, dq, dk, dv, \
                                    B, H, N, D, scale, s);
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

// q/k/v/dout/dq/dk/dv (B, H, N, D) contiguous in one dtype (0 = float32,
// 1 = bfloat16); coords (B, N, 3), slopes (H,), bias (B, N) or null, lse and
// delta (B, H, N), all fp32. Returns a cudaError_t; 0 means both kernels
// were launched.
extern "C" int mt_alibi_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* coords, const void* slopes, const void* bias,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int B, int H, int N, int D,
                                      float scale, int dtype, void* stream) {
  const int DP = mt::padded_head_dim(D);
  if (DP < 0 || B < 1 || H < 1 || B * H > 65535 || N < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const float*>(coords);
  const auto sl = static_cast<const float*>(slopes);
  const auto bs = static_cast<const float*>(bias);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return mt::dispatch_alibi_bwd<float>(DP, q, k, v, c, sl, bs, dout, l, dl, dq, dk, dv, B, H,
                                         N, D, scale, s);
  if (dtype == 1)
    return mt::dispatch_alibi_bwd<__nv_bfloat16>(DP, q, k, v, c, sl, bs, dout, l, dl, dq, dk,
                                                 dv, B, H, N, D, scale, s);
  return cudaErrorInvalidValue;
}
