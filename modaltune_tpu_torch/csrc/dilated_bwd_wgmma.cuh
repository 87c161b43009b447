// The tensor-core family of the dilated attention backward (K1b and K3b at
// bf16, D = 48): one gradient core on the Hopper frame (attention_wgmma.cuh)
// that both routes reach, declared here and defined in dilated_bwd_wgmma.cu.
//
// The core works on the compact rows of dilated_fused_common.cuh: a block
// owns one 64-row compact tile of one (batch, head, branch, segment) and
// streams the 64-row tiles of the same (segment, head group), whose rows are
// at once its queries and its keys. Its inputs are q, k, v and dmix in place
// (B, L, H, 48) bf16, the (B, L) mask, and per compact row the branch's lse
// (natural log, NEG_INF where the row has no valid key or is no real
// position), the demix weight w and delta = w * rowsum(dmix * o_b), each
// (B, H, M) fp32, which a route's prep kernel writes. It writes the fp32
// compact gradients dq_c, dk_c, dv_c (B, H, M, 48), zeros in every row that
// is no real position, as K3b's CUDA-core kernels do; a combine kernel
// (launch_compact_combine) sums them into dense dq, dk, dv in branch order.
#pragma once

#include "dilated_fused_common.cuh"

namespace mt {

// Which kernels serve a dilated attention backward, by code: 0 the CUDA-core
// kernels (fp32 at any D, bf16 at any other D), 1 the core of this header
// (bf16 at D = 48, GigaPath's head size). The C entry points own the rule
// (mt_dilated_bwd_family); ops/dilated_fused.py::bwd_family is its copy.
constexpr int kWgmmaBwdD = 48;
inline int dilated_bwd_family(int D, int dtype) {
  return dtype == 1 && D == kWgmmaBwdD ? 1 : 0;
}

struct DilatedBwdCore {
  const void *q, *k, *v, *dmix;      // (B, L, H, 48) bf16, 16-byte aligned
  const unsigned char* mask;         // (B, L), 1 = valid; or null
  const float *lse_c, *w_c, *delta_c;
  float *dq_c, *dk_c, *dv_c;
  int B, L, H;
  float scale;
};

// The dq kernel, then the dk/dv kernel (dilated_bwd_wgmma.cu).
cudaError_t launch_dilated_bwd_core(const DilatedBwdCore& a, const FusedBranches& fb,
                                    cudaStream_t stream);

// fused_combine_kernel (dilated_fused_bwd.cu): dense dq, dk, dv (B, L, H, D)
// in dtype (0 = float32, 1 = bfloat16) from the compact fp32 gradients.
cudaError_t launch_compact_combine(const float* dq_c, const float* dk_c, const float* dv_c,
                                   void* dq, void* dk, void* dv, int B, int L, int H, int D,
                                   const FusedBranches& fb, int dtype, cudaStream_t stream);

}  // namespace mt
