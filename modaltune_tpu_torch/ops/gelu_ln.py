"""Exact GELU fused with the sub-LN LayerNorm of the LongNet FFN.

Counterpart of ``modaltune_tpu/ops/gelu_ln.py::gelu_ln``: the chain
between the FFN's two matrix products, ``LayerNorm(gelu(x))`` over the last
axis, in one pass. A CUDA tensor goes to the hand-written Hopper kernels
``csrc/gelu_ln_fwd.cu`` (K5f: one read of ``x``, one write of ``y``) and
``csrc/gelu_ln_bwd.cu`` (K5b: reads ``x`` and ``dy``, writes ``dx`` and,
when they are asked for, ``dgamma`` and ``dbeta``); a CPU tensor goes to
:func:`gelu_ln_reference` and :func:`gelu_ln_backward_reference`, the plain
PyTorch versions of the same functions, which are also the kernels'
oracles.

Each kernel has two routes: bf16 rows of width :data:`ROW_WIDTH` with
every pointer 16-byte aligned (the model's FFN) run the row-resident
kernels, a group of warps a row with the row in registers; everything
else the generic kernels, a block a row with the row in shared memory.
The C entry points own the rule and the wrappers ask them
(:func:`card_route`); :func:`route` is its copy for the CPU. The backward
has two variants (:func:`wants_param_grads`): with ``dgamma``/``dbeta``,
and without them, as the train step asks, since it freezes the backbone.

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
from typing import Optional, Sequence, Tuple

import torch

from ..utils.tracing import span
from ._build import check_launch, load_library

# Kernel launches since the last reset (read by chip_smoke.py): K5f and K5b,
# and of those the row-resident route's and the backward variant's without
# dgamma and dbeta.
LAUNCHES = 0
BWD_LAUNCHES = 0
ROWS_LAUNCHES = 0
BWD_ROWS_LAUNCHES = 0
BWD_DX_ONLY_LAUNCHES = 0

# Widths the kernels take: the generic kernels keep a row in shared memory.
MAX_FEATURES = 8192
# The row-resident frame (``csrc/gelu_ln_common.cuh``), copied for the CPU
# emulation; ``mt_gelu_ln_row_frame`` exports the C constants and the card
# tests hold these equal to them. Its width, the model's ffn_dim: 8 bf16 a
# 16-byte vector, 128 lanes a row (four warps), 3 vectors a lane; groups a
# block; the reduce kernel's thread rows.
ROW_WIDTH = 3072
ROW_WARPS = 4
ROW_GROUPS = 2
REDUCE_ROWS = 8

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = ("generic", "rows")
_ROUTE_CODES = {way: code for code, way in enumerate(_ROUTES)}


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
                               dy: torch.Tensor, eps: float = 1e-5,
                               param_grads: bool = True
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                          Optional[torch.Tensor]]:
    """Plain PyTorch gradient of :func:`gelu_ln` from ``x`` alone.

    ``dyg = dy * gamma``; the LayerNorm input gradient
    ``dg = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))`` is rounded
    to x's dtype (the unfused chain hands the GELU a cotangent in that
    dtype); ``dx = dg * (cdf(x) + x * pdf(x))``; ``dgamma = sum_rows dy *
    xhat`` and ``dbeta = sum_rows dy`` are summed in fp32. Returns
    ``(dx in x's dtype, dgamma, dbeta in scale's dtype)``, the last two
    ``None`` unless ``param_grads``."""
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
    if not param_grads:
        return dx, None, None
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


def route(dtype: torch.dtype, f: int, *ptrs: int) -> str:
    """The kernels' route for rows of width ``f`` in ``dtype`` whose
    tensors start at the addresses ``ptrs``: ``"rows"``, the row-resident
    kernels, for bf16 at :data:`ROW_WIDTH` with every address 16-byte
    aligned, else ``"generic"``. The C entry points own the rule
    (``mt_gelu_ln_route``, asked by :func:`card_route`); this copy serves
    the CPU tests, and ``tests/test_torch_kernels_cuda.py`` holds it equal
    to the library's."""
    if dtype == torch.bfloat16 and f == ROW_WIDTH and \
            all(p % 16 == 0 for p in ptrs):
        return "rows"
    return "generic"


def card_route(dtype: torch.dtype, f: int, *ptrs: int) -> str:
    """The route the C entry points take for these rows; builds the
    library on first use. A dtype the kernels do not take is
    ``"generic"``, as in :func:`route`."""
    code = load_library().mt_gelu_ln_route(
        _DTYPE_CODES.get(dtype, -1), f, int(all(p % 16 == 0 for p in ptrs)))
    return _ROUTES[code]


def card_row_frame() -> Tuple[int, int, int, int]:
    """The C constants that :data:`ROW_WIDTH`, :data:`ROW_WARPS`,
    :data:`ROW_GROUPS` and :data:`REDUCE_ROWS` copy."""
    lib = load_library()
    return tuple(lib.mt_gelu_ln_row_frame(i) for i in range(4))


def wants_param_grads(needs_input_grad: Sequence[bool]) -> bool:
    """Whether the backward computes ``dgamma`` and ``dbeta``: when either
    is asked for (``needs_input_grad`` of ``(x, scale, bias, eps)``). The
    train step freezes them, and then runs the variant without."""
    return bool(needs_input_grad[1] or needs_input_grad[2])



def gelu_ln_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Launch K5f on ``x``'s device and current stream, by
    :func:`card_route`."""
    global LAUNCHES, ROWS_LAUNCHES
    _check(x, scale, bias)
    f = x.shape[-1]
    y = torch.empty_like(x)
    way = card_route(x.dtype, f, x.data_ptr(), y.data_ptr(),
                     scale.data_ptr(), bias.data_ptr())
    lib = load_library()
    with span("mt.op.k5f"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mt_gelu_ln_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel() // f, f, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[scale.dtype], _ROUTE_CODES[way], stream)
    check_launch(err, "mt_gelu_ln_fwd")
    LAUNCHES += 1
    ROWS_LAUNCHES += way == "rows"
    return y


def gelu_ln_backward_cuda(x: torch.Tensor, scale: torch.Tensor,
                          dy: torch.Tensor, eps: float = 1e-5,
                          param_grads: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """Launch K5b on ``x``'s device and current stream, by
    :func:`card_route`; returns ``(dx, dgamma, dbeta)`` as the plain
    version does. With ``param_grads`` the kernel also writes per-block
    partial ``dgamma``/``dbeta`` rows and a second kernel sums them in
    order; without, one kernel writes ``dx`` and no scratch is
    allocated."""
    global BWD_LAUNCHES, BWD_ROWS_LAUNCHES, BWD_DX_ONLY_LAUNCHES
    _check(x, scale, None, dy)
    f = x.shape[-1]
    rows = x.numel() // f
    dx = torch.empty_like(x)
    way = card_route(x.dtype, f, x.data_ptr(), dy.data_ptr(),
                     dx.data_ptr(), scale.data_ptr())
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
             _ROUTE_CODES[way])
    lib = load_library()
    with span("mt.op.k5b"), torch.cuda.device(x.device):
        n_blocks = lib.mt_gelu_ln_bwd_blocks(rows, f, *codes,
                                             int(param_grads))
        check_launch(-min(n_blocks, 0), "mt_gelu_ln_bwd_blocks")
        partial = total = None
        if param_grads:
            # per-block partial sums [dgamma | dbeta], then their totals
            partial = torch.empty((n_blocks, 2, f), dtype=torch.float32,
                                  device=x.device)
            total = torch.empty((2, f), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mt_gelu_ln_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if total is None else total.data_ptr(), rows, f, n_blocks,
            float(eps), *codes, stream)
    check_launch(err, "mt_gelu_ln_bwd")
    BWD_LAUNCHES += 1
    BWD_ROWS_LAUNCHES += way == "rows"
    BWD_DX_ONLY_LAUNCHES += not param_grads
    if not param_grads:
        return dx, None, None
    return dx, total[0].to(scale.dtype), total[1].to(scale.dtype)


class _GeluLn(torch.autograd.Function):
    """Saves only ``(x, scale)``; the kernels on CUDA tensors, the plain
    versions on CPU tensors; ``dgamma`` and ``dbeta`` only where they are
    asked for."""

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
        need = ctx.needs_input_grad
        backward = (gelu_ln_backward_cuda if x.device.type == "cuda"
                    else gelu_ln_backward_reference)
        dx, dg, db = backward(x, scale, dy, ctx.eps,
                              param_grads=wants_param_grads(need))
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
