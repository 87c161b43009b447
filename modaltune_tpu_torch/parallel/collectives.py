"""Collectives over a process group, chosen by the group's backend.

NCCL takes CUDA tensors as they are. Gloo takes CPU tensors; a CUDA tensor
on a gloo group (two processes sharing one card, where NCCL refuses two
ranks on one GPU) travels through a CPU copy. Only the list form of
``all_gather`` is used, which every torch release of the port's range has
under one name, and ``all_to_all_single``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks (a new tensor)."""
    n = dist.get_world_size(group)
    y = x.detach().cpu() if _staged(x, group) else x.detach().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device).div_(n)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor)."""
    y = x.detach().cpu() if _staged(x, group) else x.detach().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    staged = _staged(x, group)
    y = (x.cpu() if staged else x).contiguous()
    if y.dtype == torch.bool:       # gloo and NCCL move bytes, not bools
        y = y.to(torch.uint8)
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    return out.bool() if x.dtype == torch.bool else out


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` on every rank of the group."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _exchange(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"all_to_all_dim: dim {dim} of {tuple(x.shape)} "
                         f"does not split into {n} chunks")
    y = x.movedim(dim, 0)
    y = (y.cpu() if _staged(x, group) else y).contiguous()
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=group)
    return out.to(x.device).movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    """The exchange, differentiable: its gradient is the reverse exchange
    of the gradient, as the reference's ``_AllToAll``
    (``xmoe/moe_layer.py:49-64``); JAX differentiates ``all_to_all``
    itself."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _exchange(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.dim, ctx.group), None, None


def all_to_all_dim(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """``x`` cut into as many equal chunks along ``dim`` as the group has
    ranks: chunk i goes to rank i, and the result holds the chunks this
    rank received, concatenated along ``dim`` in source-rank order
    (``jax.lax.all_to_all(x, axis, dim, dim, tiled=True)``; with ``x.shape[0]``
    equal to the world size and ``dim`` 0, the untiled form). Autograd
    takes the gradient back by the reverse exchange."""
    return _AllToAll.apply(x, dim, group)
