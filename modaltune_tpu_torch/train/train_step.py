"""Multi-task forward and the embed step.

Counterpart of ``modaltune_tpu/train/train_step.py`` (``tile_tasks``,
``multitask_logits`` and ``make_embed_step``): the three task tokens run
as one batched forward, the bag tiled across them, slide b / task t at
row ``b * T + t``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..configs import TrainConfig
from ..data import Batch


def batch_to_device(batch: Batch, device) -> Dict[str, Optional[torch.Tensor]]:
    """Host numpy batch -> dict of tensors on ``device`` (bag, coords, mask,
    genes, clinical), copied asynchronously from pinned memory on CUDA."""
    device = torch.device(device)

    def put(a):
        if a is None:
            return None
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    return dict(bag=put(batch.bag), coords=put(batch.coords),
                mask=put(batch.mask), genes=put(batch.genes),
                clinical=put(batch.clinical))


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


def make_embed_step(model: nn.Module, cfg: TrainConfig
                    ) -> Callable[[Dict[str, Optional[torch.Tensor]]],
                                  torch.Tensor]:
    """Feature-extraction step: ``step(batch) -> (B, T, output_dim)``
    embeddings, the model in eval mode and no autograd state kept."""

    def step(batch: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return multitask_logits(model, batch, cfg.num_tasks)

    return step
