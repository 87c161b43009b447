// The tensor-core families of the dilated attention kernels at GigaPath's
// head size, D = 48, each a forward core and a gradient core with one
// contract, which both routes (K1 and K3) reach: bf16 on the Hopper frame
// (attention_wgmma.cuh, dilated_wgmma_frame.cuh; dilated_fwd_wgmma.cu,
// dilated_bwd_wgmma.cu), fp32 on 3xTF32 (dilated_tf32.cuh;
// dilated_fwd_tf32.cu, dilated_bwd_tf32.cu). Declared here with the two
// kernels around them that both routes share, the mix
// (dilated_fused_fwd.cu) and the combine (dilated_fused_bwd.cu).
//
// The cores work on the compact rows of dilated_fused_common.cuh: a block
// owns one 64-row compact tile of one (batch, head, branch, segment) and
// streams the 64-row tiles of the same (segment, head group), whose rows are
// at once its queries and its keys. Their inputs are q, k, v (and dmix) in
// place, (B, L, H, 48) bf16 or fp32 (the family's dtype), and the (B, L)
// mask.
// * The forward core writes per compact row the branch's output out_c
//   (B, H, M, 48) in the inputs' dtype and lse_c (B, H, M) fp32 (natural
//   log): 0 and NEG_INF where the row is no real position or has no valid
//   key, as K3f's CUDA-core branch kernel writes them. The mix turns them
//   into a route's outputs.
// * A gradient core takes per compact row the branch's lse and the demix
//   weight w, (B, H, M) fp32 each, which a route's prep kernel writes, and
//   writes delta = w * rowsum(dmix * o_b) there itself, from P and dP (no
//   branch output is kept), and the fp32 compact gradients dq_c, dk_c, dv_c
//   (B, H, M, 48), zeros in every row that is no real position; the combine
//   sums them into dense dq, dk, dv in branch order.
#pragma once

#include "dilated_fused_common.cuh"

namespace mt {

// Which kernels serve a dilated attention, by code: 0 the CUDA-core kernels
// (fp32 and bf16 at any other D), 1 the wgmma cores of this header (bf16 at
// D = 48), 2 the 3xTF32 cores (fp32 at D = 48); a family's forward and
// backward alike. The C entry points own the rule (mt_dilated_family);
// ops/dilated_fused.py::family is its copy.
constexpr int kWgmmaD = 48;
inline int dilated_family(int D, int dtype) {
  return D != kWgmmaD ? 0 : dtype == 1 ? 1 : dtype == 0 ? 2 : 0;
}

struct DilatedFwdCore {
  const void *q, *k, *v;             // (B, L, H, 48) bf16 or fp32, 16-byte aligned
  const unsigned char* mask;         // (B, L), 1 = valid; or null
  void* out_c;                       // (B, H, M, 48) in q's dtype
  float* lse_c;                      // (B, H, M)
  int B, L, H;
  float scale;
};

// The bf16 forward core (dilated_fwd_wgmma.cu); cudaErrorMisalignedAddress
// when q, k or v is not 16-byte aligned.
cudaError_t launch_dilated_fwd_core(const DilatedFwdCore& a, const FusedBranches& fb,
                                    cudaStream_t stream);
// The 3xTF32 forward core (dilated_fwd_tf32.cu) on fp32 q, k, v; the same
// refusal.
cudaError_t launch_dilated_fwd_core_tf32(const DilatedFwdCore& a, const FusedBranches& fb,
                                         cudaStream_t stream);

// The forward core of tensor-core family `family` (1 or 2).
inline cudaError_t launch_fwd_core(int family, const DilatedFwdCore& a, const FusedBranches& fb,
                                   cudaStream_t stream) {
  return family == 2 ? launch_dilated_fwd_core_tf32(a, fb, stream)
                     : launch_dilated_fwd_core(a, fb, stream);
}

struct DilatedBwdCore {
  const void *q, *k, *v, *dmix;      // (B, L, H, 48) bf16 or fp32, 16-byte aligned
  const unsigned char* mask;         // (B, L), 1 = valid; or null
  const float *lse_c, *w_c;
  float *delta_c;                    // written by the dq kernel
  float *dq_c, *dk_c, *dv_c;
  int B, L, H;
  float scale;
};

// The bf16 core (dilated_bwd_wgmma.cu): the dq kernel, then the dk/dv
// kernel.
cudaError_t launch_dilated_bwd_core(const DilatedBwdCore& a, const FusedBranches& fb,
                                    cudaStream_t stream);
// Either kernel alone: the dq kernel (and delta) on the query tiles of fb's
// range; the dk/dv kernel on the tiles of fk's enumeration, each streaming
// the query tiles of fk's range (query_tiles() of a key range with the
// range then widened gives a key range's blocks over every query).
cudaError_t launch_dilated_bwd_dq(const DilatedBwdCore& a, const FusedBranches& fb,
                                  cudaStream_t stream);
cudaError_t launch_dilated_bwd_dkv(const DilatedBwdCore& a, const FusedBranches& fk,
                                   cudaStream_t stream);

// The 3xTF32 core (dilated_bwd_tf32.cu): the dq kernel, then the dk/dv
// kernel, on fp32 q, k, v, dmix.
cudaError_t launch_dilated_bwd_core_tf32(const DilatedBwdCore& a, const FusedBranches& fb,
                                         cudaStream_t stream);

// The gradient core of tensor-core family `family` (1 or 2).
inline cudaError_t launch_bwd_core(int family, const DilatedBwdCore& a, const FusedBranches& fb,
                                   cudaStream_t stream) {
  return family == 2 ? launch_dilated_bwd_core_tf32(a, fb, stream)
                     : launch_dilated_bwd_core(a, fb, stream);
}

// Where the mix writes, per (token, head) of batch row b, head h, position p
// with bh = b H + h: mixed (B, L, H, D); m and Z at m[bh * stride + p] and
// z[bh * stride + p] (K3: two (B, H, L) planes; K1: rows n and n + 1 of its
// (B*H, n + 2, L) stats); with `planes` (K1 with stats) also every branch's
// lse at planes[bh * stride + bi * L + p], NEG_INF where the branch does not
// cover the slot. m and z may be null (K1 without stats).
struct MixOut {
  void* mixed;
  float *m, *z;
  size_t stride;
  float* planes;
};

// fused_mix_kernel (dilated_fused_fwd.cu), in dtype (0 = float32,
// 1 = bfloat16), from compact (out_c, lse_c).
cudaError_t launch_compact_mix(const void* out_c, const float* lse_c, const MixOut& o, int B,
                               int L, int H, int D, const FusedBranches& fb, int dtype,
                               cudaStream_t stream);

// fused_combine_kernel (dilated_fused_bwd.cu): dense dq, dk, dv (B, L, H, D)
// in dtype (0 = float32, 1 = bfloat16) from the compact fp32 gradients.
cudaError_t launch_compact_combine(const float* dq_c, const float* dk_c, const float* dv_c,
                                   void* dq, void* dk, void* dv, int B, int L, int H, int D,
                                   const FusedBranches& fb, int dtype, cudaStream_t stream);

}  // namespace mt
