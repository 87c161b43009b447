"""Exact (erf) GELU computed in fp32, with a lean backward.

Counterpart of ``modaltune_tpu/ops/activations.py::gelu_exact``. It is
not a Pallas kernel, so plain PyTorch is the port: the reference computes
every FFN activation in fp32 and casts back to the input dtype. The
autograd Function saves only the input (the fc1 output, which exists
anyway) and derives ``gelu'(x) = cdf(x) + x pdf(x)`` from it in fp32 in
the backward, so no fp32 copy of the activation is kept for the backward.
"""

from __future__ import annotations

import math

import torch

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


class _GeluExact(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        return (0.5 * xf * (1.0 + torch.erf(xf * _INV_SQRT2))).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.float()
        cdf = 0.5 * (1.0 + torch.erf(xf * _INV_SQRT2))
        pdf = torch.exp(-0.5 * xf * xf) * _INV_SQRT_2PI
        return (g.float() * (cdf + xf * pdf)).to(g.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``0.5 * x * (1 + erf(x / sqrt(2)))`` in fp32, in ``x``'s dtype."""
    return _GeluExact.apply(x)
