"""Multi-task forward, and the train, grad, eval and embed steps.

Counterpart of ``modaltune_tpu/train/train_step.py``: the three task
tokens run as one batched forward, the bag tiled across them, slide b /
task t at row ``b * T + t``. The train step runs the model in training
mode (dropout on, its bits drawn from the generator the caller passes),
the KD loss, the backward through the frozen backbone into the adapter,
and one optimizer step. Where the frozen backbone was cast below the
trainable parameters' precision (``freeze_backbone(model, torch.bfloat16)``,
JAX's ``frozen_dtype``), every step computes under autocast to the
backbone's dtype, so that the attention kernels see bf16 q/k/v while the
trainable parameters stay fp32, as the JAX package trains.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import TrainConfig
from ..data import Batch, device_put
from ..models.layers import dropout_generator
from ..utils.tracing import span
from .losses import kd_kl_per_slide, kd_loss
from .state import FROZEN_KEY, TrainOptimizer

Inputs = Dict[str, Optional[torch.Tensor]]


def batch_to_device(batch: Batch, device=None
                    ) -> Dict[str, Optional[torch.Tensor]]:
    """Batch -> dict of tensors on ``device`` (bag, coords, mask, genes,
    clinical). ``device=None`` is the card (an error where there is none),
    reached by an asynchronous copy from pinned memory. A field that is a
    tensor already (a loader's device prefetch put it there) is moved only
    if it lies elsewhere."""
    target = torch.device("cuda" if device is None else device)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(target, non_blocking=True)
        return device_put(a, target)

    return {name: put(getattr(batch, name))
            for name in ("bag", "coords", "mask", "genes", "clinical")}


def tile_tasks(inputs: Dict[str, Optional[torch.Tensor]],
               num_tasks: int) -> Dict[str, Optional[torch.Tensor]]:
    """Repeat every per-slide input ``num_tasks`` times along dim 0 and add
    one-hot ``task_token``s; slide b / task t lands at row ``b*T + t``."""
    out = {k: None if v is None else v.repeat_interleave(num_tasks, dim=0)
           for k, v in inputs.items()}
    first = next(v for v in inputs.values() if v is not None)
    eye = torch.eye(num_tasks, dtype=torch.float32, device=first.device)
    out["task_token"] = eye.repeat(first.shape[0], 1)
    return out


def multitask_logits(model: nn.Module, batch: Dict[str, Optional[torch.Tensor]],
                     num_tasks: int) -> torch.Tensor:
    """-> (B, num_tasks, output_dim) embeddings, one per task token."""
    inputs = dict(bag=batch["bag"], coords=batch["coords"],
                  genes=batch["genes"], clinical=batch.get("clinical"),
                  bag_mask=batch["mask"])
    tiled = tile_tasks(inputs, num_tasks)
    out = model(tiled["bag"], tiled["coords"], tiled["genes"],
                task_token=tiled["task_token"], clinical=tiled["clinical"],
                bag_mask=tiled["bag_mask"])
    return out.reshape(batch["bag"].shape[0], num_tasks, -1)


def make_embed_step(model: nn.Module, cfg: TrainConfig, mesh=None
                    ) -> Callable[[Dict[str, Optional[torch.Tensor]]],
                                  torch.Tensor]:
    """Feature-extraction step: ``step(batch) -> (B, T, output_dim)``
    embeddings, the model in eval mode and no autograd state kept, under
    the same autocast as the train and eval steps. With ``mesh`` (a
    ``parallel.mesh.make_mesh`` mesh) each rank embeds its rows of the
    batch (split over ``data``) and every rank gets all of them back in
    row order."""

    def step(batch: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        model.eval()
        n_rows = batch["bag"].shape[0]
        if mesh is not None:
            from ..parallel.mesh import shard_batch
            batch = shard_batch(batch, mesh)
        with torch.inference_mode(), _autocast(model, batch["bag"].device):
            out = multitask_logits(model, batch, cfg.num_tasks)
        if mesh is not None:
            from ..parallel.mesh import gather_rows
            out = gather_rows(out, n_rows, mesh)
        return out

    return step


def _autocast(model: nn.Module, device: torch.device):
    """Autocast to the frozen backbone's dtype where it is lower than the
    trainable parameters' (bf16 compute over an fp32 adapter); else none."""
    frozen = next(getattr(model, FROZEN_KEY).parameters()).dtype
    trainable = next(p for n, p in model.named_parameters()
                     if n.split(".")[0] != FROZEN_KEY).dtype
    if frozen.itemsize >= trainable.itemsize:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=frozen)


def _train_loss(model: nn.Module, cfg: TrainConfig, batch: Inputs,
                text_targets: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    model.train()
    with span("mt.step.forward"), dropout_generator(generator), \
            _autocast(model, batch["bag"].device):
        logits = multitask_logits(model, batch, cfg.num_tasks)
    with span("mt.step.loss"):
        return kd_loss(logits, text_targets, temperature=cfg.temperature,
                       scale=cfg.kd_loss_scale)


def make_train_step(model: nn.Module, cfg: TrainConfig,
                    optimizer: TrainOptimizer
                    ) -> Callable[[Inputs, torch.Tensor, torch.Generator],
                                  torch.Tensor]:
    """``step(batch, text_targets, generator) -> loss``: the KD loss of the
    batch (before the update), its gradient into the trainable parameters
    and one ``optimizer.step()``. ``text_targets``: (B, T, D) projected,
    normalised text targets (``losses.project_text``)."""

    def step(batch: Inputs, text_targets: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        loss = _train_loss(model, cfg, batch, text_targets, generator)
        with span("mt.step.backward"):
            loss.backward()
        with span("mt.step.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def make_grad_step(model: nn.Module, cfg: TrainConfig
                   ) -> Callable[..., Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]]:
    """``step(batch, text_targets, generator) -> (loss, grads)`` without the
    update: ``grads`` maps each trainable parameter's name to its
    gradient (the local half of data-parallel training)."""

    def step(batch: Inputs, text_targets: torch.Tensor,
             generator: torch.Generator):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        loss = _train_loss(model, cfg, batch, text_targets, generator)
        with span("mt.step.backward"):
            grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.detach(), {n: g for (n, _), g in zip(named, grads)}

    return step


def make_eval_step(model: nn.Module, cfg: TrainConfig, mesh=None
                   ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``step(batch, text_targets, row_valid) -> (logits, loss)``: the raw
    (B, T, D) embeddings in eval mode and the KD loss on their normalised
    form, averaged over the rows with ``row_valid`` (B,) set (padded rows
    of a short last batch are excluded). With ``mesh`` the batch, the text
    targets and ``row_valid`` are split over ``data``, the loss is the
    row-weighted mean over the real rows of every rank (its numerator and
    denominator summed over ``data``), and the logits come back whole, in
    row order, on every rank (JAX's ``_maybe_shard_eval`` contract)."""

    def step(batch: Inputs, text_targets: torch.Tensor,
             row_valid: torch.Tensor):
        model.eval()
        n_rows = batch["bag"].shape[0]
        if mesh is not None:
            from ..parallel.mesh import data_rows, shard_batch
            rows = data_rows(n_rows, mesh)
            batch = shard_batch(batch, mesh)
            text_targets, row_valid = text_targets[rows], row_valid[rows]
        with torch.inference_mode(), _autocast(model, batch["bag"].device):
            logits = multitask_logits(model, batch, cfg.num_tasks)
            per = kd_kl_per_slide(logits, text_targets,
                                  temperature=cfg.temperature)
            rv = row_valid.to(torch.float32)
            sums = torch.stack([(per * rv).sum(), rv.sum()])
            if mesh is not None:
                from ..parallel.mesh import data_sum, gather_rows
                sums = data_sum(sums, n_rows, mesh)
                logits = gather_rows(logits, n_rows, mesh)
            loss = sums[0] / sums[1].clamp_min(1.0) \
                * (cfg.temperature ** 2) * cfg.kd_loss_scale
        return logits, loss

    return step
