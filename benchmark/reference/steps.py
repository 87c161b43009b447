"""The reference's side of a check: models built from the benchmark's
weights, rows padded from the raw cases, and the first train steps with
their readings (loss, first gradient, change of the weights).

``precision="fp8"`` runs the same with every product's operands rounded
to float8 e4m3: the control. ``fault="half_bag"`` masks the second half
of every bag's valid tiles: a planted fault for its reading.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from .common import (AdamW, Runtime, TextProjector, init_spec, kd_loss,
                     text_targets, tiled, warmup_cosine)

FROZEN = "backbone."


def _module(name: str):
    return importlib.import_module(f"{__package__}.{name}")


def _meta(name: str, cfg: dict, genes: dict, rt: Runtime):
    with torch.device("meta"):
        return _module(name).Model(rt, cfg, genes["n_pathways"],
                                   genes["max_pathway"])


def param_spec(name: str, cfg: dict, genes: dict) -> Dict[str, list]:
    """(name, shape, mean, std) of every weight the benchmark makes: the
    model's (``"model"``) and the text projector's (``"projector"``)."""
    rt = Runtime()
    with torch.device("meta"):
        proj = TextProjector(rt, *cfg["text_projector"])
    return {"model": init_spec(_meta(name, cfg, genes, rt)),
            "projector": init_spec(proj)}


def build(name: str, cfg: dict, genes: dict, weights: dict, device,
          precision: str = "fp32"):
    """-> (model, projector, runtime) in fp32 on ``device``, loaded with
    the benchmark's weights (the frozen ones as served, widened). TF32 is
    turned off: an fp32 product stays fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = Runtime(precision)
    model = _meta(name, cfg, genes, rt).to_empty(device=device)
    model.load_state_dict({k: v.float() for k, v in
                           weights["model"].items()})
    with torch.device("meta"):
        proj = TextProjector(rt, *cfg["text_projector"])
    proj = proj.to_empty(device=device)
    proj.load_state_dict({k: v.float() for k, v in
                          weights["projector"].items()})
    return model, proj, rt


def bucket_of(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def rows_of(case, cfg: dict, buckets, device, fault: str = "") -> dict:
    """One case's padded inputs, as the reference works them out from the
    raw case: (1, bucket, ...) tensors."""
    bag, coords = case.bag, case.coords
    n = bag.shape[0]
    b = bucket_of(n, buckets)
    n = min(n, b)
    pad_bag = np.zeros((b, bag.shape[1]), np.float32)
    pad_bag[:n] = bag[:n]
    pad_xy = np.zeros((b, 2), np.float32)
    pad_xy[:n] = coords[:n]
    mask = np.zeros(b, bool)
    mask[:n if fault != "half_bag" else (n + 1) // 2] = True
    t = lambda a: torch.from_numpy(a)[None].to(device)
    return dict(bag=t(pad_bag), coords=t(pad_xy), mask=t(mask),
                genes=t(case.genes))


def train_readings(model, proj, rt, rows: List[dict], texts: List[np.ndarray],
                   train: dict, dropout_seed: int, steps_per_epoch: int
                   ) -> dict:
    """The first ``len(rows)`` train steps from the loaded weights: each
    step's loss, each trainable leaf's first gradient (``first``) and its
    norm, and the norm of each leaf's change after the last step."""
    device = rows[0]["bag"].device
    params = {n: p for n, p in model.named_parameters()
              if not n.startswith(FROZEN)}
    for n, p in model.named_parameters():
        p.requires_grad_(n in params)
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = AdamW(params, warmup_cosine(train, steps_per_epoch),
                (train["beta1"], train["beta2"]), 1e-8, train["weight_decay"])
    rt.generator = torch.Generator(device=device).manual_seed(dropout_seed)
    losses, first = [], None
    for r, text in zip(rows, texts):
        target = text_targets(proj, torch.from_numpy(text)[None].to(device))
        loss = kd_loss(tiled(model, r, train["num_tasks"]), target,
                       train["temperature"], train["kd_loss_scale"])
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        del grads, loss
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in params.items()}
    rt.generator = None
    return dict(loss=losses, grad={n: float(g.norm()) for n, g in
                                   first.items()},
                change=change, first=first)
