"""Output heads of the supervised baselines.

Counterpart of ``modaltune_tpu/models/heads.py``: class logits from a
dense kernel, and the survival transform ``S = cumprod(1 - sigmoid(logits))``
of the reference's "classifier" / "survival" modes
(``Aggregator.return_logits``, ``aggregators.py:43-58``). ``add_head``
registers the head's parameters under the JAX package's names
(``final_norm``, ``classifier_kernel`` (in, C), ``classifier_bias``), and
``head_outputs`` applies them: an fp32 LayerNorm, the logits, then the
mode's transform.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from .layers import fill_normal_

MODES = ("feature", "classifier", "survival")

Survival = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def classifier_logits(h: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    return h @ w + b


def survival_from_logits(logits: torch.Tensor) -> Survival:
    """-> (hazards, survival curve S, predicted bin)."""
    hazards = torch.sigmoid(logits)
    s = torch.cumprod(1.0 - hazards, dim=-1)
    return hazards, s, logits.argmax(dim=-1)


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise NotImplementedError(f"mode={mode}")
    return mode


def add_head(module: nn.Module, width: int, n_classes: int) -> None:
    """Give ``module`` the head's parameters; its ``init_weights`` must
    call :func:`init_head`."""
    module.final_norm = nn.LayerNorm(width, eps=1e-5)
    module.classifier_kernel = nn.Parameter(torch.empty(width, n_classes))
    module.classifier_bias = nn.Parameter(torch.empty(n_classes))


@torch.no_grad()
def init_head(module: nn.Module, g: torch.Generator) -> None:
    fill_normal_(module.classifier_kernel, 0.02, g)
    module.classifier_bias.zero_()


def head_outputs(module: nn.Module, h: torch.Tensor, mode: str
                 ) -> Union[torch.Tensor, Survival]:
    """The "classifier" logits or the "survival" tuple of ``h`` (B, width)
    through ``module``'s head."""
    logits = classifier_logits(module.final_norm(h.float()),
                               module.classifier_kernel,
                               module.classifier_bias)
    return logits if mode == "classifier" else survival_from_logits(logits)
