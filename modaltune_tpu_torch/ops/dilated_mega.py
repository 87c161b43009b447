"""Multi-branch LongNet dilated attention in one kernel launch.

Counterpart of ``modaltune_tpu/ops/dilated_mega.py::mega_dilated_attention``:
same signature and semantics as :func:`.dilated.dilated_attention`. A CUDA
tensor goes to the hand-written Hopper kernel
``csrc/dilated_attention_fwd.cu`` (every branch and the branch mix in one
launch, q/k/v read in place); a CPU tensor goes to the plain version
:func:`.dilated.dilated_attention`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ._build import check_launch, load_library
from .dilated import dilated_attention

# Kernel launches since the last reset (read by chip_smoke.py).
LAUNCHES = 0

MAX_BRANCHES = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, mask, segment_lengths, dilated_ratios):
    if q.dim() != 4:
        raise ValueError("mega_dilated_attention takes (B, L, H, D) q/k/v")
    b, length, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or d > 128 or b > 65535 or h > 65535:
        raise ValueError(f"kernel takes D a multiple of 8 up to 128, got "
                         f"{tuple(q.shape)}")
    if not 1 <= len(segment_lengths) <= MAX_BRANCHES or \
            len(segment_lengths) != len(dilated_ratios):
        raise ValueError(f"kernel takes 1..{MAX_BRANCHES} branches with one "
                         f"ratio each, got {segment_lengths}, {dilated_ratios}")
    if min(segment_lengths) < 1 or min(dilated_ratios) < 1:
        raise ValueError("segment lengths and ratios must be positive")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if mask is not None:
        if mask.shape != (b, length) or mask.dtype != torch.bool or \
                mask.device != q.device or not mask.is_contiguous():
            raise ValueError(f"mask must be a contiguous bool {(b, length)} "
                             f"tensor on {q.device}")


def mega_dilated_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mask: Optional[torch.Tensor],
                                segment_lengths: Sequence[int],
                                dilated_ratios: Sequence[int],
                                scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on ``q``'s device and current stream."""
    global LAUNCHES
    segs = [int(w) for w in segment_lengths]
    ratios = [int(r) for r in dilated_ratios]
    _check(q, k, v, mask, segs, ratios)
    b, length, h, d = q.shape
    out = torch.empty_like(q)
    n = len(segs)
    c_segs = (ctypes.c_int * n)(*segs)
    c_ratios = (ctypes.c_int * n)(*ratios)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_dilated_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, length, h, d, ctypes.cast(c_segs, ctypes.c_void_p),
            ctypes.cast(c_ratios, ctypes.c_void_p), n, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "mt_dilated_attention_fwd")
    LAUNCHES += 1
    return out


def mega_dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, segment_lengths: Sequence[int],
                           dilated_ratios: Sequence[int],
                           mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Multi-branch LongNet dilated attention.

    q/k/v ``(B, L, H, D)``, optional ``(B, L)`` bool validity mask, output
    ``(B, L, H, D)`` in q's dtype. CUDA tensors run the kernel (or raise),
    CPU tensors the plain version.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return mega_dilated_attention_cuda(q, k, v, mask, segment_lengths,
                                           dilated_ratios, float(scale))
    if q.device.type != "cpu":
        raise ValueError(f"mega_dilated_attention: unsupported device "
                         f"{q.device}")
    return dilated_attention(q, k, v, segment_lengths=segment_lengths,
                             dilated_ratios=dilated_ratios, mask=mask,
                             scale=scale)
