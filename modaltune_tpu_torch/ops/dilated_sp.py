"""Sequence-parallel dilated attention over a process group (the island).

Counterpart of ``modaltune_tpu/ops/dilated_sp.py``. The reference's
``gather_kv`` (``torchscale/component/dilated_attention.py:61-80``)
all-gathers K/V across the sequence-parallel group whenever a dilated
segment exceeds the local token shard. JAX partitions the whole model along
tokens under GSPMD and drops dilated attention into a ``shard_map``
island; PyTorch has no partitioner, so the port shards where the cost is:
a model whose ``LongNetConfig.seq_axes`` is set runs every span of its
frozen backbone on this rank's token shard (``models/longnet.py``), and
each layer's attention is the island here:

* forward: ``all_gather`` q, k, v and the mask along tokens over the
  ``seq`` group, K1 with ``q_token_range`` = this rank's tokens
  (:func:`.dilated_mega.mega_dilated_attention_cuda`; the plain version on
  CPU tensors), keep the local rows;
* backward: every rank's cotangent rows (and, on the card, its stats
  columns) are gathered, and each rank takes dq of its own queries and
  dk/dv of its own keys over every query, so the step's gradients are one
  process's bits. In K1b's bf16 tensor-core family (D = 48, GigaPath's
  path) each rank does half the work: K1b's part 0 gives its dq and its
  queries' delta, the group sums the delta planes (each row is one
  rank's), and part 1 streams every query tile over the rank's key tiles
  in the whole call's order
  (:func:`.dilated_mega.mega_dilated_attention_backward_part_cuda`).
  Elsewhere (K1b's fp32 families, the 3xTF32 core at D = 48 and the CUDA
  cores at another D, and bf16 at another D; the plain version on CPU
  tensors) the rank runs the whole sequence's backward and keeps its rows. JAX's island instead sums every rank's partial dk/dv over the
  group (a reduce-scatter): partial sums added across ranks round
  otherwise than one sequential sum, which in bf16 read 2.344e-2 against
  the 2e-2 row-scaled gate of ``chip_smoke.phase_parallel``.

The ambient mesh (JAX's ``jax.set_mesh``) is set with :func:`use_mesh`; the
island and the span sharding read it. :func:`sp_mega_eligible` keeps the
JAX package's rule, the kernel's whole comb slabs, and with it the JAX
kernel's own eligibility (:func:`mega_eligible`, the Pallas kernel's VMEM
budget included, so that both packages shard the same shapes).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence

import torch

from ..parallel.collectives import all_gather_dim, all_reduce_sum
from .dilated import dilated_attention
from .dilated_fused import card_family
from .dilated_mega import (mega_dilated_attention_backward_cuda,
                           mega_dilated_attention_backward_part_cuda,
                           mega_dilated_attention_cuda, part_scratch)
from .kept import kept

# ---------------------------------------------------------------------------
# The JAX package's mega-kernel eligibility (ops/dilated_mega.py::mega_mode),
# copied with its default budgets.
# ---------------------------------------------------------------------------

_FWD_SCORE_BUDGET = 6 * 1024 * 1024
_BWD_SCORE_BUDGET = 4 * 1024 * 1024
_MAX_BQ = 512
_MAX_BRANCHES = 8
_VMEM_BUDGET = 118 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pick_bq(wr: int, budget: int) -> int:
    bq = _MAX_BQ
    while bq > 8 and bq * wr * 4 > budget:
        bq //= 2
    return bq if bq * wr * 4 <= budget else -1


def _max_window_rows(w: int, r: int, S: int, R: int) -> int:
    """The JAX kernel's largest key window of a branch, in comb rows of its
    head group (``_MegaPlan.max_wr``)."""
    mb, cw, best = S // R, w // R, 0
    for n in range(-(-S // w)):
        t0, t1 = n * cw, min((n + 1) * cw, mb)
        krows = min(_round_up(t1, 8), mb) - (t0 // 8) * 8
        best = max(best, (R // r) * krows)
    return best


def _lanes(n: int) -> int:
    return _round_up(max(n, 1), 128)


def _vmem(S: int, D: int, nbr: int, max_wr: int, itemsize: int) -> bool:
    """Whether the JAX kernel's forward and one of its backward flavours
    fit its VMEM budget (``_vmem_estimate*``)."""
    lane_d, stats = _lanes(D), _round_up(nbr + 2, 8) * S * 4
    fwd = (S * lane_d * 4 + S * _lanes(_MAX_BRANCHES + 3) * 4
           + 3 * max_wr * _lanes(D + 1) * itemsize
           + 2 * (3 * S * lane_d * itemsize + 8 * S * 4)
           + 2 * (S * lane_d * itemsize + stats))
    bwd_scr = (3 * S * lane_d * 4 + S * _lanes(_MAX_BRANCHES + 8) * 4
               + 5 * max_wr * _lanes(D + 1) * itemsize
               + 2 * max_wr * lane_d * 4)
    mono = bwd_scr + 2 * (4 * S * lane_d * itemsize + 8 * S * 4 + stats) \
        + 2 * 3 * S * lane_d * itemsize
    if mono <= _VMEM_BUDGET:
        return True
    hbm = bwd_scr + 2 * S * lane_d * itemsize + \
        2 * (2 * S * lane_d * itemsize + 8 * S * 4 + stats)
    return fwd <= _VMEM_BUDGET and hbm <= _VMEM_BUDGET


def mega_eligible(S: int, H: int, D: int, segment_lengths: Sequence[int],
                  dilated_ratios: Sequence[int], itemsize: int = 2) -> bool:
    """The JAX package's ``mega_eligible``: whole comb slabs (R = max ratio
    divides S, S / R rows a multiple of 8, every segment a multiple of R,
    every ratio dividing H and R, a branch of ratio 1), key windows the
    Pallas kernel can tile, and its VMEM budget."""
    if len(segment_lengths) != len(dilated_ratios) or \
            len(segment_lengths) > _MAX_BRANCHES:
        return False
    R = max(int(r) for r in dilated_ratios)
    if R < 2 or S % R or (S // R) % 8:
        return False
    if not any(int(r) == 1 for r in dilated_ratios):
        return False
    max_wr = 0
    for w, r in zip(segment_lengths, dilated_ratios):
        w, r = min(int(w), S), int(r)
        if w % R or H % r or R % r or w // R < 1:
            return False
        wr = _max_window_rows(w, r, S, R)
        max_wr = max(max_wr, wr)
        if wr > 8192 or _pick_bq(wr, _FWD_SCORE_BUDGET) < 8 or \
                _pick_bq(wr, _BWD_SCORE_BUDGET) < 8:
            return False
    return _vmem(S, D, len(segment_lengths), max_wr, itemsize)


def sp_mega_eligible(S: int, n_shards: int, H: int, D: int,
                     segment_lengths: Sequence[int],
                     dilated_ratios: Sequence[int]) -> bool:
    """Static eligibility of the sequence-parallel path (the JAX rule): the
    full sequence must be mega-eligible and each shard's token range whole
    comb slabs (``S / n_shards`` a multiple of R = max ratio)."""
    if n_shards < 2 or S % n_shards:
        return False
    if not mega_eligible(S, H, D, segment_lengths, dilated_ratios):
        return False
    R = max(int(r) for r in dilated_ratios)
    return (S // n_shards) % R == 0


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

_MESH = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, ``parallel.mesh.make_mesh``) the
    ambient mesh of the island and the span sharding while the block runs
    (JAX's ``jax.set_mesh``)."""
    global _MESH
    previous, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = previous


class SeqShard(NamedTuple):
    """This rank's place in a ``seq`` group: its tokens are the
    ``rank``-th of ``n`` equal shards."""
    group: object
    rank: int
    n: int


def seq_shard(batch_axis: str, seq_axis: str) -> Optional[SeqShard]:
    """The ambient mesh's ``seq_axis`` group, or None where the mesh is
    missing, lacks either axis, or holds one rank along ``seq_axis``."""
    mesh = _MESH
    if mesh is None or mesh.mesh_dim_names is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    if seq_axis not in names or batch_axis not in names:
        return None
    n = mesh[seq_axis].size()
    if n < 2:
        return None
    return SeqShard(mesh.get_group(seq_axis), mesh.get_local_rank(seq_axis),
                    n)


# ---------------------------------------------------------------------------
# The island
# ---------------------------------------------------------------------------

class _SpMega(torch.autograd.Function):
    """One rank's rows of the dilated attention over the gathered
    sequence; see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, mask, shard, segment_lengths, dilated_ratios,
                scale):
        qf, kf, vf = (all_gather_dim(t, 1, shard.group) for t in (q, k, v))
        mf = None if mask is None else all_gather_dim(mask, 1, shard.group)
        s_loc = q.shape[1]
        rng = (shard.rank * s_loc, (shard.rank + 1) * s_loc)
        branches = (segment_lengths, dilated_ratios, scale)
        if q.device.type == "cuda":
            out, stats = kept(lambda: mega_dilated_attention_cuda(
                qf, kf, vf, mf, *branches, with_stats=True,
                q_token_range=rng))
            saved = (qf, kf, vf, mf, stats)
        else:
            out, = kept(lambda: (dilated_attention(
                qf, kf, vf, segment_lengths=segment_lengths,
                dilated_ratios=dilated_ratios, mask=mf, scale=scale,
                q_token_range=rng),))
            saved = (qf, kf, vf, mf)
        ctx.save_for_backward(*saved)
        ctx.args = (shard, branches, rng)
        return out[:, rng[0]:rng[1]].contiguous()

    @staticmethod
    def backward(ctx, dout):
        shard, branches, rng = ctx.args
        saved = ctx.saved_tensors   # read once: a checkpoint unpacks once
        qf, kf, vf, mf = saved[:4]
        r0, r1 = rng
        if qf.device.type == "cuda" and \
                card_family(qf.shape[-1], qf.dtype) == "wgmma":
            grads = _split_backward(qf, kf, vf, mf, saved[4], dout, shard,
                                    branches, rng)
        else:
            dmix = all_gather_dim(dout.contiguous(), 1, shard.group)
            if qf.device.type == "cuda":
                stats = all_gather_dim(saved[4][..., r0:r1].contiguous(), 2,
                                       shard.group)
                grads = mega_dilated_attention_backward_cuda(
                    qf, kf, vf, mf, dmix, stats, *branches)
            else:
                leaves = [t.detach().requires_grad_() for t in (qf, kf, vf)]
                with torch.enable_grad():
                    out = dilated_attention(
                        *leaves, segment_lengths=branches[0],
                        dilated_ratios=branches[1], mask=mf,
                        scale=branches[2])
                    grads = torch.autograd.grad(out, leaves, dmix)
        return tuple(g[:, r0:r1].contiguous() for g in grads) + (None,) * 5


def _split_backward(qf, kf, vf, mf, stats, dout, shard, branches, rng):
    """K1b in two parts (see the module docstring): part 0 gives this
    rank's dq and its queries' delta; with every rank's delta (summed:
    each row is one rank's, 0 on the others), cotangent and stats columns,
    part 1 gives dk and dv of this rank's keys over every query, in the
    order the whole call sums them. Returns the whole sequence's (dq, dk,
    dv), meaningful in this rank's rows."""
    r0, r1 = rng
    dmix = dout.new_zeros(qf.shape)
    dmix[:, r0:r1] = dout
    scratch = part_scratch(qf, *branches[:2])
    dq, _, _ = mega_dilated_attention_backward_part_cuda(
        qf, kf, vf, mf, dmix, stats, *branches, 0, rng, scratch)
    scratch[0][2] = all_reduce_sum(scratch[0][2], shard.group)
    dmix = all_gather_dim(dout.contiguous(), 1, shard.group)
    stats = all_gather_dim(stats[..., r0:r1].contiguous(), 2, shard.group)
    _, dk, dv = mega_dilated_attention_backward_part_cuda(
        qf, kf, vf, mf, dmix, stats, *branches, 1, rng, scratch)
    return dq, dk, dv


class _EnterSpan(torch.autograd.Function):
    """Replicated ``(B, S, ...)`` -> this rank's token shard; the
    gradient of the shard is gathered back to the whole sequence."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return torch.chunk(x, shard.n, dim=1)[shard.rank].contiguous()

    @staticmethod
    def backward(ctx, dx):
        return all_gather_dim(dx.contiguous(), 1, ctx.shard.group), None


class _LeaveSpan(torch.autograd.Function):
    """This rank's token shard -> the gathered, replicated sequence; the
    gradient is the local slice of the replicated one (every rank computes
    the same gradient downstream, so no sum)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return all_gather_dim(x, 1, shard.group)

    @staticmethod
    def backward(ctx, dy):
        shard = ctx.shard
        return torch.chunk(dy, shard.n, dim=1)[shard.rank].contiguous(), None


def enter_span(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """A span's entry: the rank's tokens of a replicated sequence."""
    return _EnterSpan.apply(x, shard)


def leave_span(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """A span's exit: the group's shards gathered into the sequence."""
    return _LeaveSpan.apply(x, shard)


def local_tokens(x: Optional[torch.Tensor], shard: SeqShard):
    """The rank's tokens of ``x`` (a mask: no gradient), or None."""
    return None if x is None else \
        torch.chunk(x, shard.n, dim=1)[shard.rank].contiguous()


def span_shard(cfg, length: int) -> Optional[SeqShard]:
    """How a span of a LongNet of ``cfg`` (a ``LongNetConfig``) over
    ``length`` tokens runs: on this rank's token shard (its
    :class:`SeqShard`) when ``cfg.seq_axes`` is set, the attention is on a
    kernel route (``fused_attention``) and not the LoRA layer (which,
    as in JAX, calls no island), the ambient mesh holds both axes with
    more than one rank along the second, and :func:`sp_mega_eligible`
    takes the shape; else None, and the span runs whole (the same
    function)."""
    if cfg.seq_axes is None or not cfg.fused_attention or cfg.lora_adapter:
        return None
    shard = seq_shard(*cfg.seq_axes)
    if shard is None or not sp_mega_eligible(
            length, shard.n, cfg.num_heads, cfg.head_dim,
            cfg.segment_lengths, cfg.dilated_ratios):
        return None
    return shard


def sp_mega_dilated_attention(q, k, v, mask, *, shard: SeqShard,
                              segment_lengths: Sequence[int],
                              dilated_ratios: Sequence[int],
                              scale: Optional[float] = None) -> torch.Tensor:
    """This rank's ``(B, S_loc, H, D)`` attention rows from its local
    q/k/v ``(B, S_loc, H, D)`` and mask ``(B, S_loc)`` (or None), the
    sequence being the concatenation of the group's shards in rank order;
    differentiable in q, k, v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _SpMega.apply(q, k, v, mask, shard,
                         tuple(int(w) for w in segment_lengths),
                         tuple(int(r) for r in dilated_ratios), float(scale))


def sp_island_attention(q, k, v, mask, *, segment_lengths: Sequence[int],
                        dilated_ratios: Sequence[int], batch_axis: str,
                        seq_axis: str, scale: Optional[float] = None
                        ) -> Optional[torch.Tensor]:
    """The island for a span that runs on this rank's token shard: q/k/v
    are the local ``(B, S_loc, H, D)`` rows, ``mask`` the local ``(B,
    S_loc)`` validity (or None). Returns the local attention rows, or None
    where JAX's returns None: no ambient mesh (:func:`use_mesh`), a mesh
    without ``batch_axis`` or ``seq_axis``, one rank along ``seq_axis``, or
    a sequence (``S_loc`` times the ranks) that :func:`sp_mega_eligible`
    refuses. (The rows were split over ``batch_axis`` before the model ran,
    so every rank's batch is whole.)

    The model does not call it: a LongNet span resolves its shard once
    (:func:`span_shard`) and every layer calls
    :func:`sp_mega_dilated_attention` with it. This function is the
    counterpart of the JAX package's public ``sp_island_attention``, which
    ``tests/test_torch_dilated_sp.py`` holds it against."""
    shard = seq_shard(batch_axis, seq_axis)
    if shard is None:
        return None
    _, s_loc, heads, d = q.shape
    if not sp_mega_eligible(s_loc * shard.n, shard.n, heads, d,
                            segment_lengths, dilated_ratios):
        return None
    return sp_mega_dilated_attention(q, k, v, mask, shard=shard,
                                     segment_lengths=segment_lengths,
                                     dilated_ratios=dilated_ratios,
                                     scale=scale)
