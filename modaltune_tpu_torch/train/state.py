"""Frozen/trainable split, optimizer and learning-rate schedule.

Counterpart of ``modaltune_tpu/train/state.py``. JAX splits the parameter
tree at its top-level ``backbone`` key and differentiates only the rest;
here the backbone's parameters get ``requires_grad=False`` (and may be
cast to a lower precision, as JAX's ``frozen_dtype``), and the optimizer
holds only the trainable ones.

The schedule mirrors GradualWarmupScheduler (x20 over 10 epochs) into
CosineAnnealingLR, quantised to epochs. The optimizer is AdamW with
optax's defaults (eps 1e-8, decoupled weight decay on every trainable
tensor); with ``grad_accum = k`` it applies one update per k micro-steps
on the mean gradient, as ``optax.MultiSteps`` does, and the schedule is
indexed by the count of applied updates, not of micro-steps.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn

from ..configs import TrainConfig

FROZEN_KEY = "backbone"


def freeze_backbone(model: nn.Module,
                    frozen_dtype: Optional[torch.dtype] = None
                    ) -> List[nn.Parameter]:
    """Freeze ``model.backbone`` (optionally casting it to ``frozen_dtype``)
    and return the trainable parameters: every other one."""
    frozen = getattr(model, FROZEN_KEY)
    if frozen_dtype is not None:
        frozen.to(frozen_dtype)
    for p in frozen.parameters():
        p.requires_grad_(False)
    return [p for name, p in model.named_parameters()
            if name.split(".")[0] != FROZEN_KEY]


def warmup_cosine_epoch_schedule(cfg: TrainConfig, steps_per_epoch: int
                                 ) -> Callable[[int], float]:
    """Epoch-quantised schedule: linear warmup from lr/factor to lr over
    ``warmup_epochs`` (GradualWarmup's ``base*(1+(m-1)*e/total)`` with
    base = lr/m), then cosine anneal to 0 over the remaining epochs."""
    base = cfg.lr / cfg.warmup_factor
    warm = cfg.warmup_epochs
    cosine_epochs = max(1, cfg.num_epochs - warm)

    def schedule(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        if epoch < warm:
            return base * (1.0 + (cfg.warmup_factor - 1.0) * epoch / warm)
        ce = min(max(epoch - warm, 0), cosine_epochs)
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * ce / cosine_epochs))

    return schedule


class TrainOptimizer:
    """AdamW on the trainable parameters, with the schedule and gradient
    accumulation above. Call :meth:`step` after every ``backward()``: it
    applies an update on every ``grad_accum``-th call (then clears the
    gradients) and leaves the summed gradients in place otherwise."""

    def __init__(self, cfg: TrainConfig, params: Iterable[nn.Parameter],
                 steps_per_epoch: int):
        self.schedule = warmup_cosine_epoch_schedule(cfg, steps_per_epoch)
        self.every = max(1, cfg.grad_accum)
        self.micro_steps = 0
        self.updates = 0        # applied updates: the schedule's index
        self.adamw = torch.optim.AdamW(
            list(params), lr=self.schedule(0), betas=(cfg.beta1, cfg.beta2),
            eps=1e-8, weight_decay=cfg.weight_decay)

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for group in self.adamw.param_groups for p in group["params"]]

    def lr(self) -> float:
        """The learning rate of the next applied update."""
        return self.schedule(self.updates)

    def step(self) -> bool:
        """Returns whether an update was applied."""
        self.micro_steps += 1
        if self.micro_steps % self.every:
            return False
        if self.every > 1:
            for p in self.params:
                if p.grad is not None:
                    p.grad.div_(self.every)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr()
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.updates += 1
        return True


# the JAX package's name for it: make_optimizer(cfg, params, steps_per_epoch)
make_optimizer = TrainOptimizer
