"""Multi-process data parallelism: the bootstrap, shards and gathers.

Counterpart of ``modaltune_tpu/parallel/multihost.py``, on
``torch.distributed`` with one process per GPU (the reference's own DDP
idiom, ``utils/base_trainer.py:160-211``):

* :func:`init_distributed` — ``init_process_group`` with the environment
  bootstrap order the reference uses: explicit arguments, then
  torchrun-style ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``,
  then SLURM variables, else single-process (no group at all). NCCL on the
  card (``LOCAL_RANK`` picks the GPU), gloo on the CPU.
* :func:`process_datalist` — the deterministic case-modulo shard of a
  case list (the ``DistributedSampler`` equivalent).
* :func:`allgather_embeddings` — eval embeddings and case ids of every
  process, uneven counts padded to the largest (the ``Join`` /
  ``gather_object`` equivalent, ``base_trainer.py:379-421``).
* :class:`DdpGradSync` — the DDP gradient mean: one ``all_reduce`` of the
  gradients and the loss, divided by the world size, then the same AdamW
  step on every rank, so the replicas stay bit-identical.
* :func:`process_sum`, :func:`global_steps_min` — the eval loss sums and
  the common step count (the ``Join`` uneven-input equivalent).
* :func:`global_mesh`, :func:`global_batch_to_devices` — the device mesh
  over every rank and this rank's rows of a global batch.

Every function is a passthrough in a process without a process group; in
a group of one it runs its collectives (``chip_smoke.py`` drives them so
over NCCL on one card).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_reduce_mean


def _first_slurm_host(nodelist: str) -> str:
    """First real hostname of a SLURM nodelist.

    Compressed lists like ``node[001-004,007],other`` must expand to
    ``node001`` — the naive ``split("[")[0]`` yields the bare prefix
    ``node``, an invalid coordinator hostname. Prefers ``scontrol show
    hostnames`` when available (authoritative), else expands the first
    bracket range textually, preserving zero-padding.
    """
    try:
        import subprocess
        out = subprocess.run(
            ["scontrol", "show", "hostnames", nodelist],
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.split()[0]
    except (OSError, ValueError):
        pass
    head = nodelist.split(",")[0]
    if "[" not in head:
        return head
    prefix, rng = nodelist.split("[", 1)
    first = rng.split("]", 1)[0].split(",")[0].split("-")[0]
    return prefix + first


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None,
                     device: str = "cuda") -> Tuple[int, int]:
    """Initialise the default process group; returns ``(process_id,
    num_processes)``.

    Bootstrap order mirrors ``base_trainer.init_distributed``
    (``base_trainer.py:160-203``): explicit args > torchrun-style env >
    SLURM (``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_STEP_NODELIST``) >
    single-process (no group). ``coordinator_address`` is ``host:port`` or
    a whole init method (``tcp://...``, ``file://...``). ``device``:
    ``"cuda"`` runs NCCL on the GPU ``local_device_ids`` (an index, or
    ``LOCAL_RANK`` / ``SLURM_LOCALID``, else 0), which becomes the current
    device; ``"cpu"`` runs gloo. An existing group is taken as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if num_processes is None:
        if "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env.get("RANK", 0))
            coordinator_address = coordinator_address or (
                f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                f"{env.get('MASTER_PORT', '12355')}")
        elif "SLURM_NTASKS" in env and int(env["SLURM_NTASKS"]) > 1:
            num_processes = int(env["SLURM_NTASKS"])
            process_id = int(env["SLURM_PROCID"])
            node = _first_slurm_host(env["SLURM_STEP_NODELIST"])
            coordinator_address = coordinator_address or f"{node}:12355"
    if not num_processes or num_processes <= 1:
        return 0, 1
    method = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    if device == "cuda":
        local = local_device_ids if local_device_ids is not None else int(
            env.get("LOCAL_RANK", env.get("SLURM_LOCALID", 0)))
        torch.cuda.set_device(int(local))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=method, world_size=num_processes,
                            rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def process_datalist(items: Sequence, process_id: Optional[int] = None,
                     num_processes: Optional[int] = None) -> List:
    """Deterministic per-process shard of a case/slide list (the
    ``DistributedSampler`` equivalent): item ``i`` belongs to process
    ``i % num_processes``. Disjoint, stable across epochs, and uneven
    by at most one item — :func:`allgather_embeddings` absorbs the
    unevenness at eval."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return [it for i, it in enumerate(items) if i % n == pid]


def _comm_device() -> torch.device:
    """Where the default group's tensors live: the current GPU under NCCL,
    else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_rows(x: np.ndarray) -> np.ndarray:
    """``(P, ...)``: every process's ``x`` (one shape on every process)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def allgather_embeddings(x: np.ndarray,
                         case_ids: Optional[Sequence[str]] = None):
    """Gather per-process eval embeddings to every process.

    x: ``(n_local, ...)`` with ``n_local`` varying per process (uneven
    inputs — the reference handles this with DDP ``Join`` + rank-0
    ``gather_object``, ``base_trainer.py:379-421``). Returns the
    concatenated ``(n_total, ...)`` array in process order (every process
    gets it) and, when ``case_ids`` is given, the matching flat id list;
    the ids travel as fixed-width uint8 rows.
    """
    if not dist.is_initialized():
        return (np.asarray(x), list(case_ids)) if case_ids is not None \
            else np.asarray(x)
    x = np.asarray(x)
    counts = _allgather_rows(np.asarray([x.shape[0]], np.int64)).reshape(-1)
    n_max = int(counts.max())
    pad = np.zeros((n_max - x.shape[0],) + x.shape[1:], x.dtype)
    padded = np.concatenate([x, pad], axis=0) if pad.shape[0] else x
    gathered = _allgather_rows(padded)
    out = np.concatenate([gathered[p, :counts[p]]
                          for p in range(len(counts))], axis=0)
    if case_ids is None:
        return out
    ids = [str(c) for c in case_ids]
    width_local = max([len(c.encode()) for c in ids], default=0)
    width = int(_allgather_rows(np.asarray([width_local], np.int64)).max())
    enc = np.zeros((n_max, max(width, 1)), np.uint8)
    for i, c in enumerate(ids):
        b = c.encode()[:width]
        enc[i, :len(b)] = np.frombuffer(b, np.uint8)
    genc = _allgather_rows(enc)
    all_ids = [bytes(genc[p, i][genc[p, i] != 0]).decode()
               for p in range(len(counts)) for i in range(counts[p])]
    return out, all_ids


class DdpGradSync:
    """Cross-process DDP gradient synchronization (the reference's DDP
    all-reduce, ``utils/base_trainer.py:205-211``): each process computes
    its local gradients on its own batch (any bucket shape), then
    :meth:`step` means them and the loss over the group in one
    ``all_reduce`` of a flat fp32 buffer and applies the update of
    ``optimizer`` (a ``TrainOptimizer``) on every rank. Every rank adds the
    same sums to the same parameters, so the replicas stay bit-identical.

    ``params``: name -> parameter, the keys of the gradients that
    :meth:`step` takes (``make_grad_step``'s)."""

    def __init__(self, optimizer, params: Dict[str, torch.nn.Parameter],
                 group=None):
        self.optimizer = optimizer
        self.params = dict(params)
        self.group = group

    def mean(self, grads: Dict[str, torch.Tensor], loss: torch.Tensor):
        """``(mean grads, mean loss)`` over the group."""
        names = list(self.params)
        flat = torch.cat([grads[n].detach().float().reshape(-1)
                          for n in names] + [loss.detach().float()
                                             .reshape(1)])
        flat = all_reduce_mean(flat, self.group)
        out, at = {}, 0
        for n in names:
            p = self.params[n]
            out[n] = flat[at:at + p.numel()].view_as(p).to(p.dtype)
            at += p.numel()
        return out, flat[at]

    def step(self, grads: Dict[str, torch.Tensor],
             loss: torch.Tensor) -> torch.Tensor:
        """Mean the gradients and the loss over the group, add the mean
        gradients to the parameters' ``.grad`` (as ``backward()`` would) and
        take one optimizer step; returns the mean loss."""
        mean, mloss = self.mean(grads, loss)
        for n, g in mean.items():
            p = self.params[n]
            p.grad = g if p.grad is None else p.grad + g
        self.optimizer.step()
        return mloss


def process_sum(values: np.ndarray) -> np.ndarray:
    """Elementwise sum of a small host array across processes — the
    scalar half of the reference's rank-0 eval aggregation (loss numerator
    / denominator counts alongside the ``gather_object`` of outputs,
    ``base_trainer.py:379-421``). Passthrough in single-process runs."""
    if not dist.is_initialized():
        return np.asarray(values)
    return _allgather_rows(np.asarray(values, np.float64)).sum(axis=0)


def global_steps_min(n_local: int) -> int:
    """Minimum per-process step count — every process must run the same
    number of synchronized steps per epoch (the DDP ``Join`` uneven-input
    equivalent, ``train_modaltune.py:215``)."""
    if not dist.is_initialized():
        return n_local
    return int(_allgather_rows(np.asarray([n_local], np.int64)).min())


def global_mesh(n_seq: int = 1):
    """The ``(data, seq)`` device mesh over every rank of every process
    (``n_data`` = world size // ``n_seq``)."""
    from .mesh import make_mesh
    return make_mesh(n_data=process_count() // n_seq, n_seq=n_seq)


def global_batch_to_devices(batch: Dict[str, Optional[np.ndarray]], mesh,
                            device=None) -> Dict[str, Optional[torch.Tensor]]:
    """This rank's rows of a global batch (the same ``(B, ...)`` arrays on
    every rank, ``B`` split over the mesh's ``data`` axis), as tensors on
    ``device`` (None: the card)."""
    from .mesh import shard_batch
    target = torch.device("cuda" if device is None else device)
    rows = shard_batch(batch, mesh)
    return {k: None if v is None else torch.as_tensor(v).to(target)
            for k, v in rows.items()}
