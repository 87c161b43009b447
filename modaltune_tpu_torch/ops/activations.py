"""Exact (erf) GELU computed in fp32.

Counterpart of ``modaltune_tpu/ops/activations.py::gelu_exact`` (forward
only). It is not a Pallas kernel, so plain PyTorch is the port: the
reference computes every FFN activation in fp32 and casts back to the
input dtype.
"""

from __future__ import annotations

import math

import torch

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``0.5 * x * (1 + erf(x / sqrt(2)))`` in fp32, in ``x``'s dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * _INV_SQRT2))).to(x.dtype)
