"""Exact GELU fused with the sub-LN LayerNorm of the LongNet FFN.

Counterpart of ``modaltune_tpu/ops/gelu_ln.py::gelu_ln``: the chain
between the FFN's two matrix products, ``LayerNorm(gelu(x))`` over the last
axis, in one pass. A CUDA tensor goes to the hand-written Hopper kernels
``csrc/gelu_ln_fwd.cu`` (K5f: one read of ``x``, one write of ``y``) and
``csrc/gelu_ln_bwd.cu`` (K5b: reads ``x`` and ``dy``, writes ``dx``,
``dgamma``, ``dbeta``); a CPU tensor goes to :func:`gelu_ln_reference` and
:func:`gelu_ln_backward_reference`, the plain PyTorch versions of the same
functions, which are also the kernels' oracles.

Numerics, op for op those of the unfused chain: the erf GELU in fp32,
rounded to ``x``'s dtype (where the unfused chain materialises the
activation) and taken back to fp32; the mean and the *fast variance*
``max(0, E[g^2] - E[g]^2)``; ``(g - mu) * rsqrt(var + eps)``; the affine
in fp32; the result in ``x``'s dtype. ``nn.LayerNorm`` computes the
variance in two passes and differs in the last bits, so it is not the
oracle. The backward saves only ``(x, scale)`` and recomputes the rest.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ._build import check_launch, load_library

# Kernel launches since the last reset (read by chip_smoke.py): K5f and K5b.
LAUNCHES = 0
BWD_LAUNCHES = 0

# Widths the kernels take: a block keeps whole rows in shared memory.
MAX_FEATURES = 8192

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _gelu_stats(x: torch.Tensor, eps: float):
    """fp32 ``(x, g, mu, rstd)`` of the rows of ``x``: g is the GELU
    rounded to x's dtype, mu and rstd the fast-variance statistics."""
    x32 = x.float()
    g = (0.5 * x32 * (1.0 + torch.erf(x32 * _INV_SQRT2))).to(x.dtype).float()
    mu = g.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((g * g).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    return x32, g, mu, torch.rsqrt(var + eps)


def gelu_ln_reference(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch ``LayerNorm(gelu(x))`` over the last axis with the
    kernel's numerics (module docstring). ``x``: (..., F); ``scale`` and
    ``bias``: (F,). Returns x's shape and dtype."""
    _, g, mu, rstd = _gelu_stats(x, eps)
    y = (g - mu) * rstd
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu_ln_backward_reference(x: torch.Tensor, scale: torch.Tensor,
                               dy: torch.Tensor, eps: float = 1e-5
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch gradient of :func:`gelu_ln` from ``x`` alone.

    ``dyg = dy * gamma``; the LayerNorm input gradient
    ``dg = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))`` is rounded
    to x's dtype (the unfused chain hands the GELU a cotangent in that
    dtype); ``dx = dg * (cdf(x) + x * pdf(x))``; ``dgamma = sum_rows dy *
    xhat`` and ``dbeta = sum_rows dy`` are summed in fp32. Returns
    ``(dx in x's dtype, dgamma, dbeta in scale's dtype)``."""
    x32, g, mu, rstd = _gelu_stats(x, eps)
    xhat = (g - mu) * rstd
    dy32 = dy.float()
    dyg = dy32 * scale.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dg = (rstd * (dyg - m1 - xhat * m2)).to(x.dtype).float()
    cdf = 0.5 * (1.0 + torch.erf(x32 * _INV_SQRT2))
    pdf = torch.exp(-0.5 * x32 * x32) * _INV_SQRT_2PI
    dx = (dg * (cdf + x32 * pdf)).to(x.dtype)
    f = x.shape[-1]
    dgamma = (dy32 * xhat).reshape(-1, f).sum(dim=0)
    dbeta = dy32.reshape(-1, f).sum(dim=0)
    return dx, dgamma.to(scale.dtype), dbeta.to(scale.dtype)


def _check(x, scale, bias, dy=None):
    f = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or not 1 <= f <= MAX_FEATURES or x.numel() == 0:
        raise ValueError(f"gelu_ln kernels take (..., F) with 1 <= F <= "
                         f"{MAX_FEATURES} and at least one row, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.numel() // f > 2**31 - 1:
        raise ValueError(f"too many rows: {x.numel() // f}")
    for name, t in (("x", x), ("dy", dy)):
        if t is None:
            continue
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {x.dtype} "
                             f"{tuple(x.shape)} tensor on {x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.shape != (f,) or t.dtype not in (torch.float32, x.dtype) or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({f},) float32 or "
                             f"{x.dtype} tensor on {x.device}")
    if bias is not None and bias.dtype != scale.dtype:
        raise TypeError(f"scale and bias must share a dtype, got "
                        f"{scale.dtype}, {bias.dtype}")


def gelu_ln_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Launch K5f on ``x``'s device and current stream."""
    global LAUNCHES
    _check(x, scale, bias)
    f = x.shape[-1]
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mt_gelu_ln_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel() // f, f, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[scale.dtype], stream)
    check_launch(err, "mt_gelu_ln_fwd")
    LAUNCHES += 1
    return y


def gelu_ln_backward_cuda(x: torch.Tensor, scale: torch.Tensor,
                          dy: torch.Tensor, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K5b (the row kernel, then the sum of its per-block partial
    ``dgamma``/``dbeta`` rows) on ``x``'s device and current stream;
    returns ``(dx, dgamma, dbeta)`` as the plain version does."""
    global BWD_LAUNCHES
    _check(x, scale, None, dy)
    f = x.shape[-1]
    rows = x.numel() // f
    dx = torch.empty_like(x)
    lib = load_library()
    # a block walks rows b, b + n_blocks, ...: as many blocks as the card
    # holds at once (16 F bytes of shared memory each)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_blocks = min(rows, sms * max(1, min(8, 200_000 // (16 * f))))
    # per-block partial sums [dgamma | dbeta], then their totals
    partial = torch.empty((n_blocks, 2, f), dtype=torch.float32,
                          device=x.device)
    total = torch.empty((2, f), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mt_gelu_ln_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), total.data_ptr(), rows, f, n_blocks,
            float(eps), _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
            stream)
    check_launch(err, "mt_gelu_ln_bwd")
    BWD_LAUNCHES += 1
    return dx, total[0].to(scale.dtype), total[1].to(scale.dtype)


class _GeluLn(torch.autograd.Function):
    """Saves only ``(x, scale)``; the kernels on CUDA tensors, the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cuda":
            return gelu_ln_cuda(x, scale, bias, eps)
        return gelu_ln_reference(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cuda":
            dx, dg, db = gelu_ln_backward_cuda(x, scale, dy, ctx.eps)
        else:
            dx, dg, db = gelu_ln_backward_reference(x, scale, dy, ctx.eps)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dg if need[1] else None,
                db if need[2] else None, None)


def gelu_ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Fused exact GELU and LayerNorm over the last axis, differentiable
    in ``x``, ``scale`` and ``bias``.

    ``x``: (..., F) float32 or bfloat16; ``scale``/``bias``: (F,) in
    float32 or x's dtype. CUDA tensors run the kernels (or raise), CPU
    tensors the plain versions.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gelu_ln: unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        x = x.contiguous()
    return _GeluLn.apply(x, scale, bias, float(eps))
