"""The ``(data, seq)`` device mesh and the train steps over it.

Counterpart of ``modaltune_tpu/parallel/mesh.py``. JAX drives every chip
from one process through a ``Mesh`` and ``shard_map``; the PyTorch idiom is
one process per GPU, so here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group (NCCL on the card, gloo on the CPU), and each rank runs the
steps on its own share:

* **data parallel** — the batch's rows are split over ``data`` by the
  rank's coordinate (:func:`shard_batch`; an axis they do not divide stays
  whole), each rank runs the forward and backward on its rows, the
  gradients and the loss are averaged over ``data``, and every rank takes
  the same update (:func:`make_dp_train_step`, the DDP equivalent);
* **sequence parallel** — a model whose ``LongNetConfig.seq_axes`` is set
  runs its frozen backbone's spans on the rank's token shard of ``seq``,
  attention through the island (``ops/dilated_sp.py``), under the ambient
  mesh that :func:`make_spmd_train_step` sets.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.dilated_sp import use_mesh
from .collectives import all_gather_dim, all_reduce_sum
from .multihost import DdpGradSync

DATA_AXIS = "data"
SEQ_AXIS = "seq"

__all__ = ["DATA_AXIS", "SEQ_AXIS", "data_generator",
           "data_rows", "gather_rows", "make_dp_train_step", "make_mesh",
           "make_spmd_train_step", "shard_batch", "use_mesh"]


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1):
    """A ``(n_data, n_seq)`` mesh named ``(data, seq)`` over the ranks of
    the default process group (``n_data`` defaults to the world size over
    ``n_seq``); rank ``i`` sits at ``(i // n_seq, i % n_seq)``. Its groups
    take the default group's backend."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_seq
    if n_data * n_seq != world:
        raise ValueError(f"a ({n_data}, {n_seq}) mesh needs {n_data * n_seq} "
                         f"ranks; the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_seq),
                            mesh_dim_names=(DATA_AXIS, SEQ_AXIS))


def _data_coord(mesh):
    return mesh.get_local_rank(DATA_AXIS), mesh[DATA_AXIS].size()


def data_rows(n_rows: int, mesh) -> slice:
    """This rank's rows of ``n_rows``: its ``data`` coordinate's equal
    share, or all of them where ``data`` does not divide ``n_rows`` (an
    uneven axis stays whole, as JAX's ``shard_batch`` keeps it)."""
    idx, n = _data_coord(mesh)
    if n_rows % n:
        return slice(0, n_rows)
    per = n_rows // n
    return slice(idx * per, (idx + 1) * per)


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every field of ``batch`` (tensors or arrays with
    rows first; None stays None). Every field's rows split over ``data``
    (JAX's ``batch_pspec``); the token axis is split inside the model, by
    the spans of a ``seq_axes`` LongNet, never here."""
    out = {}
    for k, v in batch.items():
        out[k] = None if v is None else v[data_rows(v.shape[0], mesh)]
    return out


def gather_rows(x: torch.Tensor, n_rows: int, mesh) -> torch.Tensor:
    """The inverse of :func:`data_rows` for an output: every rank's rows in
    row order (``x`` itself where the rows were not split)."""
    if data_rows(n_rows, mesh) == slice(0, n_rows):
        return x
    return all_gather_dim(x.contiguous(), 0, mesh.get_group(DATA_AXIS))


def data_sum(x: torch.Tensor, n_rows: int, mesh) -> torch.Tensor:
    """``x`` summed over ``data`` where ``n_rows`` were split, else ``x``."""
    if data_rows(n_rows, mesh) == slice(0, n_rows):
        return x
    return all_reduce_sum(x, mesh.get_group(DATA_AXIS))


def data_generator(seed: int, mesh, device) -> torch.Generator:
    """A dropout generator on ``device`` seeded from ``(seed, the rank's
    data index)``, JAX's ``fold_in(rng, axis_index(data))``: the ranks of
    one data index (its ``seq`` group) draw the same bits, other indices
    others."""
    idx, _ = _data_coord(mesh)
    s = int(np.random.SeedSequence([seed, idx]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def _mesh_step(model, cfg, optimizer, mesh, ambient: bool):
    from ..train.train_step import make_grad_step
    grad_step = make_grad_step(model, cfg)
    sync = DdpGradSync(optimizer, {n: p for n, p in model.named_parameters()
                                   if p.requires_grad},
                       group=mesh.get_group(DATA_AXIS))

    def step(batch, text_targets: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        rows = data_rows(text_targets.shape[0], mesh)
        with use_mesh(mesh) if ambient else contextlib.nullcontext():
            loss, grads = grad_step(shard_batch(batch, mesh),
                                    text_targets[rows], generator)
        return sync.step(grads, loss)

    return step


def make_dp_train_step(model, cfg, optimizer, mesh):
    """Data-parallel train step, the counterpart of JAX's ``shard_map``
    step: ``step(batch, text_targets, generator) -> loss``. The rank runs
    the forward and backward on its rows of the batch and of the (B, T, D)
    text targets (B a multiple of the ``data`` size), the gradients and
    the loss are averaged over ``data`` (:class:`DdpGradSync`), and
    ``optimizer`` (a ``TrainOptimizer``) takes one step on every rank; the
    mean loss is returned. ``generator`` is this rank's
    (:func:`data_generator`)."""
    return _mesh_step(model, cfg, optimizer, mesh, ambient=False)


def make_spmd_train_step(model, cfg, optimizer, mesh):
    """The step over a ``(data, seq)`` mesh: rows over ``data`` as
    :func:`make_dp_train_step`, with ``mesh`` the ambient mesh while the
    model runs, so that a model whose ``LongNetConfig.seq_axes`` is
    ``(data, seq)`` runs its backbone's spans on the rank's token shard of
    ``seq``. Its loss is the single-device step's; the ranks of a ``seq``
    group compute the same gradients, and the mean over ``data`` is taken
    as in data parallelism."""
    return _mesh_step(model, cfg, optimizer, mesh, ambient=True)
