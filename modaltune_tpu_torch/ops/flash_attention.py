"""Flash attention with an additive key bias, returning the log-sum-exp.

Counterpart of ``modaltune_tpu/ops/flash_attention.py``. A CUDA tensor
goes to the hand-written Hopper kernel ``csrc/flash_attention_fwd.cu``; a
CPU tensor goes to :func:`flash_attention_reference`, the plain PyTorch
version of the same function, which is also the kernel's oracle.

Semantics: ``bias`` is ``(BH, Lk)``, 0 for a valid key and ``NEG_INF``
for a masked one. A masked key gets exactly zero weight, and a row whose
keys are all masked gets output 0 and lse ``NEG_INF``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check_launch, load_library

NEG_INF = -1e9
MASK_THRESHOLD = NEG_INF * 0.5

# Kernel launches since the last reset (read by chip_smoke.py).
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the kernel's semantics, in fp32.

    ``q``: (BH, Lq, D); ``k``/``v``: (BH, Lk, D); ``bias``: (BH, Lk)
    additive. Returns ``(out (BH, Lq, D) in q's dtype, lse (BH, Lq) fp32)``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.bmm(q.float(), k.float().transpose(1, 2)).mul_(scale)
    if bias is not None:
        s.add_(bias[:, None, :].float())
    m = s.amax(dim=-1, keepdim=True)
    # With one valid key in a row, a masked key's exp(NEG_INF - m) is
    # exactly 0; a row with none (m <= NEG_INF/2) is zeroed below.
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True)
    live = m > MASK_THRESHOLD
    l = torch.where(live, l, 0.0)
    l_safe = torch.where(l > 0.0, l, 1.0)
    out = (torch.bmm(p, v.float()) / l_safe * live).to(q.dtype)
    lse = torch.where(l[..., 0] > 0.0, m[..., 0] + torch.log(l_safe[..., 0]),
                      NEG_INF)
    return out, lse


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
    """Launch the CUDA kernel on ``q``'s device and current stream."""
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning ``(out, lse)``.

    q: ``(BH, Lq, D)``; k, v: ``(BH, Lk, D)``; bias: optional ``(BH, Lk)``
    additive key bias (``NEG_INF`` masks a key); scale defaults to
    ``D ** -0.5``. CUDA tensors run the kernel (or raise), CPU tensors the
    plain version.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        bias = bias.to(torch.float32)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, bias, float(scale))
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_reference(q, k, v, bias, scale)
