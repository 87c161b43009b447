"""Flash attention with the 2-D ALiBi bias computed inside the kernel
(the TITAN backbone's attention).

Counterpart of ``modaltune_tpu/ops/alibi_flash.py``. A CUDA tensor goes to
the hand-written Hopper kernels ``csrc/alibi_attention_fwd.cu`` (K4f) and,
for the gradient, ``csrc/alibi_attention_bwd.cu`` (K4b), which run bf16
inputs on the tensor cores and fp32 inputs on CUDA cores; a CPU tensor goes
to :func:`alibi_attention_reference` and
:func:`alibi_attention_backward_reference`, the plain PyTorch versions of
the same functions, which are also the kernels' oracles.

For batch row b, head h, query i and key j::

    s_ij = q_i . k_j * scale
           - slope_h * ||c_i - c_j||_2 * (1 - cls_i) * (1 - cls_j)
           + key_bias_j

with ``coords3[b, i] = [row, col, is_cls]`` (the cls token's row and
column carry no distance bias) and ``key_bias`` 0 for a valid key and
``NEG_INF`` for a masked one. A masked key gets exactly zero weight and
zero gradient; a row without a valid key gets output 0, lse ``NEG_INF``
and zero gradients. The (H, N, N) bias never exists in device memory.
Only q, k and v are differentiated: coords, slopes and the key mask are
inputs that nothing learns, and ``lse`` is an output without a gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check_launch, load_library
from .flash_attention import _DTYPE_CODES, MASK_THRESHOLD, NEG_INF

# Kernel launches since the last reset (read by chip_smoke.py): K4f and K4b.
LAUNCHES = 0
BWD_LAUNCHES = 0


def alibi_scores_bias(coords3: torch.Tensor, slopes: torch.Tensor
                      ) -> torch.Tensor:
    """The dense (B, H, N, N) fp32 ALiBi term of the scores, for the plain
    versions: ``-slope_h * dist_ij * not_cls_ij``."""
    c = coords3.float()
    d = c[:, :, None, :2] - c[:, None, :, :2]
    dist = torch.sqrt((d * d).sum(dim=-1))
    not_cls = (1.0 - c[:, :, None, 2]) * (1.0 - c[:, None, :, 2])
    return -slopes.float()[None, :, None, None] * (dist * not_cls)[:, None]


def alibi_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, coords3: torch.Tensor,
                              slopes: torch.Tensor,
                              key_mask: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ALiBi attention with the kernel's semantics, in fp32.

    q/k/v: (B, H, N, D); coords3: (B, N, 3); slopes: (H,); key_mask:
    (B, N) bool. Returns ``(out (B, H, N, D) in q's dtype, lse (B, H, N)
    fp32)``. The softmax runs over the valid keys only (a masked key's
    probability is exactly 0 and the rest sum to 1, as the JAX oracle
    re-normalises them). Out of place, so autograd differentiates
    ``out``; ``lse`` is detached.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale \
        + alibi_scores_bias(coords3, slopes)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, NEG_INF)
    # the shift cancels in the softmax, so it carries no gradient
    m = s.detach().amax(dim=-1, keepdim=True)
    # next to a valid key a masked key's exp(NEG_INF - m) is exactly 0; a
    # row with none (m <= NEG_INF/2) is zeroed below
    p = torch.exp(s - m)
    live = m > MASK_THRESHOLD
    l_safe = torch.where(live, p.sum(dim=-1, keepdim=True), 1.0)
    out = (torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
           * live).to(q.dtype)
    lse = torch.where(live[..., 0], m[..., 0] + torch.log(l_safe[..., 0]),
                      NEG_INF)
    return out, lse.detach()


def alibi_attention_backward_reference(q, k, v, coords3, slopes, key_mask,
                                       out, lse, dout,
                                       scale: Optional[float] = None):
    """Plain PyTorch gradient of :func:`alibi_flash_attention` from its
    saved ``out`` and ``lse``: the formulas of the JAX package's
    ``_dq_kernel`` and ``_dkv_kernel``.

    ``delta = rowsum(dout * out)``, ``P = exp(s - lse)`` with the forward's
    scores ``s`` (0 for a masked key), ``dS = P * (dout V^T - delta)``,
    ``dq = dS K scale``, ``dk = dS^T Q scale``, ``dv = P^T dout``. A row
    without a valid key (lse ``NEG_INF``) takes ``+|NEG_INF/2|`` in lse's
    place, so its P underflows to 0. Returns ``(dq, dk, dv)`` in the dtypes
    of q, k and v.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale \
        + alibi_scores_bias(coords3, slopes)
    lse_use = torch.where(lse > MASK_THRESHOLD, lse, -MASK_THRESHOLD)
    p = torch.exp(s - lse_use[..., None])
    if key_mask is not None:
        p = torch.where(key_mask[:, None, None, :], p, 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _key_bias(key_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if key_mask is None:
        return None
    return torch.where(key_mask, 0.0, NEG_INF).to(torch.float32).contiguous()


def _check(q, k, v, coords3, slopes, key_mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"alibi_flash_attention takes q, k and v of one "
                         f"(B, H, N, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (d <= 128 and b * h <= 65535 and n >= 1):
        raise ValueError(f"kernel takes D <= 128, B*H <= 65535 and N >= 1, "
                         f"got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t, shape in (("coords3", coords3, (b, n, 3)),
                           ("slopes", slopes, (h,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {q.device}")
    if key_mask is not None and (tuple(key_mask.shape) != (b, n)
                                 or key_mask.dtype != torch.bool
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be a bool {(b, n)} tensor on "
                         f"{q.device}")


def alibi_flash_attention_cuda(q, k, v, coords3, slopes, key_mask,
                               scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K4f kernel on ``q``'s device and current stream."""
    global LAUNCHES
    _check(q, k, v, coords3, slopes, key_mask)
    b, h, n, d = q.shape
    bias = _key_bias(key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_alibi_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), coords3.data_ptr(),
            slopes.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, n, d, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "mt_alibi_attention_fwd")
    LAUNCHES += 1
    return out, lse


def alibi_flash_attention_backward_cuda(q, k, v, coords3, slopes, key_mask,
                                        out, lse, dout, scale: float):
    """Launch the K4b kernels (dq, then dk/dv) on ``q``'s device and current
    stream. ``delta = rowsum(dout * out)`` is computed here in torch, as
    the JAX package computes it outside its Pallas kernels."""
    global BWD_LAUNCHES
    _check(q, k, v, coords3, slopes, key_mask)
    b, h, n, d = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}")
    if tuple(lse.shape) != (b, h, n) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, n)} "
                         f"tensor")
    bias = _key_bias(key_mask)
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_alibi_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), coords3.data_ptr(),
            slopes.data_ptr(), None if bias is None else bias.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, n, d, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "mt_alibi_attention_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _AlibiFlashAttention(torch.autograd.Function):
    """K4f forward, K4b backward on CUDA tensors; the plain versions on
    CPU tensors. ``lse`` is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, coords3, slopes, key_mask, scale):
        if q.device.type == "cuda":
            out, lse = alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                                  key_mask, scale)
        else:
            out, lse = alibi_attention_reference(q, k, v, coords3, slopes,
                                                 key_mask, scale)
        ctx.save_for_backward(q, k, v, coords3, slopes, key_mask, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, coords3, slopes, key_mask, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = alibi_flash_attention_backward_cuda(
                q, k, v, coords3, slopes, key_mask, out, lse,
                dout.contiguous(), ctx.scale)
        else:
            grads = alibi_attention_backward_reference(
                q, k, v, coords3, slopes, key_mask, out, lse, dout, ctx.scale)
        return (*grads, None, None, None, None)


def alibi_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          coords3: torch.Tensor, slopes: torch.Tensor,
                          key_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """ALiBi flash attention, differentiable in q, k and v.

    q/k/v: ``(B, H, N, D)`` contiguous; coords3: ``(B, N, 3)`` =
    [row, col, is_cls]; slopes: ``(H,)``; key_mask: ``(B, N)`` bool;
    scale defaults to ``D ** -0.5``. Returns ``(B, H, N, D)``. CUDA
    tensors run the kernels (or raise), CPU tensors the plain versions.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"alibi_flash_attention: unsupported device "
                         f"{q.device}")
    out, _ = _AlibiFlashAttention.apply(
        q, k, v, coords3.to(torch.float32).contiguous(),
        slopes.to(torch.float32).contiguous(), key_mask, float(scale))
    return out
