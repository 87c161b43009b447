"""Flash attention with an additive key bias, returning the log-sum-exp.

Counterpart of ``modaltune_tpu/ops/flash_attention.py``. A CUDA tensor
goes to the hand-written Hopper kernels ``csrc/flash_attention_fwd.cu``
(K2f) and, for the gradient, ``csrc/flash_attention_bwd.cu`` (K2b); a CPU
tensor goes to :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`, the plain PyTorch versions of
the same functions, which are also the kernels' oracles.

Semantics: ``bias`` is ``(BH, Lk)``, 0 for a valid key and ``NEG_INF``
for a masked one. A masked key gets exactly zero weight (and zero
gradient), and a row whose keys are all masked gets output 0, lse
``NEG_INF`` and zero gradients. ``lse`` is not differentiated: its
cotangent is dropped, as the JAX package's ``_bwd_pallas`` drops it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check_launch, load_library

NEG_INF = -1e9
MASK_THRESHOLD = NEG_INF * 0.5

# Kernel launches since the last reset (read by chip_smoke.py): K2f and K2b.
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the kernel's semantics, in fp32.

    ``q``: (BH, Lq, D); ``k``/``v``: (BH, Lk, D); ``bias``: (BH, Lk)
    additive. Returns ``(out (BH, Lq, D) in q's dtype, lse (BH, Lq) fp32)``.
    Out of place, so autograd differentiates ``out``; ``lse`` is detached.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias[:, None, :].float()
    # the shift cancels in the softmax, so it carries no gradient
    m = s.detach().amax(dim=-1, keepdim=True)
    # With one valid key in a row, a masked key's exp(NEG_INF - m) is
    # exactly 0; a row with none (m <= NEG_INF/2) is zeroed below.
    p = torch.exp(s - m)
    live = m > MASK_THRESHOLD
    l_safe = torch.where(live, p.sum(dim=-1, keepdim=True), 1.0)
    out = (torch.bmm(p, v.float()) / l_safe * live).to(q.dtype)
    lse = torch.where(live[..., 0], m[..., 0] + torch.log(l_safe[..., 0]),
                      NEG_INF)
    return out, lse.detach()


def flash_attention_backward_reference(q, k, v, bias, out, lse, dout,
                                       scale: Optional[float] = None):
    """Plain PyTorch gradient of :func:`flash_attention` from its saved
    ``out`` and ``lse``: the formulas of the JAX package's ``_bwd_pallas``.

    ``delta = rowsum(dout * out)``, ``P = exp(s * scale + bias - lse)``
    (0 for a masked key), ``dS = P * (dout V^T - delta)``,
    ``dq = dS K scale``, ``dk = dS^T Q scale``, ``dv = P^T dout``. A row
    whose keys are all masked (lse ``NEG_INF``) takes ``+|NEG_INF/2|`` in
    lse's place, so its P underflows to 0. Returns ``(dq, dk, dv)`` in
    the dtypes of q, k and v.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    s = torch.bmm(qf, kf.transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias[:, None, :].float()
    lse_use = torch.where(lse > MASK_THRESHOLD, lse, -MASK_THRESHOLD)
    p = torch.exp(s - lse_use[..., None])
    if bias is not None:
        p = torch.where(bias[:, None, :] > MASK_THRESHOLD, p, 0.0)
    ds = p * (torch.bmm(do, vf.transpose(1, 2)) - delta)
    dq = torch.bmm(ds, kf) * scale
    dk = torch.bmm(ds.transpose(1, 2), qf) * scale
    dv = torch.bmm(p.transpose(1, 2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, bias):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes (BH, L, D) q, k and v")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (d <= 128 and bh <= 65535 and q.shape[1] >= 1 and k.shape[1] >= 1):
        raise ValueError(f"kernel takes D <= 128, BH <= 65535 and non-empty "
                         f"rows, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if bias is not None:
        if bias.shape != (bh, k.shape[1]) or bias.device != q.device \
                or bias.dtype != torch.float32 or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous float32 "
                             f"{(bh, k.shape[1])} tensor on {q.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor], scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K2f kernel on ``q``'s device and current stream."""
    global LAUNCHES
    _check(q, k, v, bias)
    bh, lq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bh, lq, k.shape[1], d,
            float(scale), _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "mt_flash_attention_fwd")
    LAUNCHES += 1
    return out, lse


def flash_attention_backward_cuda(q, k, v, bias, out, lse, dout, scale: float):
    """Launch the K2b kernels (dq, then dk/dv) on ``q``'s device and current
    stream. ``delta = rowsum(dout * out)`` is computed here in torch, as
    the JAX package computes it outside its Pallas kernels."""
    global BWD_LAUNCHES
    _check(q, k, v, bias)
    bh, lq, d = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}")
    if lse.shape != (bh, lq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(bh, lq)} tensor")
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, lq, k.shape[1], d, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "mt_flash_attention_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K2f forward, K2b backward on CUDA tensors; the plain versions on
    CPU tensors. ``lse`` is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        if q.device.type == "cuda":
            out, lse = flash_attention_cuda(q, k, v, bias, scale)
        else:
            out, lse = flash_attention_reference(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = flash_attention_backward_cuda(
                q, k, v, bias, out, lse, dout.contiguous(), ctx.scale)
        else:
            grads = flash_attention_backward_reference(
                q, k, v, bias, out, lse, dout, ctx.scale)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning ``(out, lse)``, differentiable in q, k, v.

    q: ``(BH, Lq, D)``; k, v: ``(BH, Lk, D)``; bias: optional ``(BH, Lk)``
    additive key bias (``NEG_INF`` masks a key); scale defaults to
    ``D ** -0.5``. CUDA tensors run the kernels (or raise), CPU tensors the
    plain versions.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        bias = bias.to(torch.float32)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bias, float(scale))
