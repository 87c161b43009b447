"""The LongNet extras that every shipped configuration turns off.

Counterpart of ``modaltune_tpu/models/extras.py``, in plain PyTorch (none
of them has a kernel of its own):

* :class:`LoraDilatedSelfAttention`: frozen q/k/v/out projections around
  the per-branch dilated attention, with per-modality (img/gene/task) LoRA
  deltas on q, k and v; :class:`..longnet.LongNetEncoderLayer` builds it
  under ``LongNetConfig.lora_adapter``. Its attention is
  :func:`..ops.dilated.dilated_attention` with every branch on
  :func:`..ops.flash_attention` (the K2 kernels on CUDA tensors), the
  function the JAX layer calls.
* :func:`top1_gating`, :func:`top2_gating` and :class:`MoeFeedForward`:
  GShard token routing with capacity and a load-balance loss, and with a
  process group the experts shared out over its ranks, the dispatched
  tokens exchanged by :func:`..parallel.collectives.all_to_all_dim`.
* :func:`apply_xpos` (xPos rotary embedding) and
  :class:`RelativePositionBias` (the T5 bucketed bias).

Parameter names and layouts are the JAX package's, so
:func:`..utils.convert.params_from_jax` carries a JAX tree by its rules.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..configs import LongNetConfig
from ..ops.activations import gelu_exact
from ..ops.dilated import dilated_attention
from ..parallel.collectives import all_to_all_dim
from .layers import Dense, Dropout, ambient_generator, fill_normal_

_MODALITIES = ("img", "gene", "task")


class LoraDilatedSelfAttention(nn.Module):
    """Dilated self-attention with per-modality LoRA deltas::

        q = W_q x + (s_i B_i A_i x + s_m B_g A_g gene + s_m B_t A_t task) / 3

    with ``s = lora_alpha / rank`` per branch; k and v likewise. ``gene``
    and ``task`` are ``(B, 1, D)`` context vectors broadcast over the
    tokens. The A matrices start He-uniform, the B matrices at zero, so at
    initialisation the layer is the plain attention on its base
    projections."""

    def __init__(self, cfg: LongNetConfig, lora_alpha: float = 32.0,
                 img_rank: int = 4, mm_rank: int = 8,
                 lora_dropout: float = 0.0):
        super().__init__()
        d = cfg.embed_dim
        self.cfg, self.lora_alpha = cfg, lora_alpha
        self.ranks = dict(img=img_rank, gene=mm_rank, task=mm_rank)
        for name in "qkv":
            self.add_module(f"{name}_proj", Dense(d, d))
            for tag in _MODALITIES:
                rank = self.ranks[tag]
                self.add_module(f"{name}_lora_A_{tag}",
                                Dense(d, rank, "he_uniform", bias=False))
                self.add_module(f"{name}_lora_B_{tag}",
                                Dense(rank, d, "zeros", bias=False))
        self.inner_attn_ln = (nn.LayerNorm(d, eps=cfg.layernorm_eps)
                              if cfg.subln else None)
        self.out_proj = Dense(d, d)
        self.lora_dropout = Dropout(lora_dropout)

    def _proj(self, name: str, x, contexts) -> torch.Tensor:
        deltas = None
        for tag, ctx in zip(_MODALITIES, contexts):
            a = getattr(self, f"{name}_lora_A_{tag}")(self.lora_dropout(ctx))
            delta = getattr(self, f"{name}_lora_B_{tag}")(a) * (
                self.lora_alpha / self.ranks[tag])
            deltas = delta if deltas is None else deltas + delta
        return getattr(self, f"{name}_proj")(x) + deltas / 3.0

    def forward(self, x: torch.Tensor, gene: torch.Tensor,
                task: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return self.output(self.attend(*self.project(x, gene, task), mask))

    def project(self, x: torch.Tensor, gene: torch.Tensor,
                task: torch.Tensor):
        """x (B, L, d) and the contexts -> q, k, v (B, L, heads,
        head_dim), each with its LoRA deltas."""
        c = self.cfg
        b, length, _ = x.shape
        contexts = (x, gene, task)
        return tuple(self._proj(name, x, contexts)
                     .view(b, length, c.num_heads, c.head_dim)
                     for name in "qkv")

    def attend(self, q, k, v, mask: Optional[torch.Tensor] = None,
               shard=None) -> torch.Tensor:
        """The per-branch dilated attention of q, k, v -> (B, L, d). It
        has no sequence-parallel island: ``shard`` raises."""
        if shard is not None:
            raise RuntimeError("the LoRA attention has no sequence-parallel "
                               "island; its spans run whole")
        c = self.cfg
        out = dilated_attention(
            q, k, v, segment_lengths=c.segment_lengths,
            dilated_ratios=c.dilated_ratios,
            mask=mask if c.mask_padding else None, kernel=True)
        return out.reshape(q.shape[0], q.shape[1], c.embed_dim)

    def output(self, out: torch.Tensor) -> torch.Tensor:
        if self.inner_attn_ln is not None:
            out = self.inner_attn_ln(out)
        return self.out_proj(out)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot rows; an index outside ``[0, n)`` gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def _queue_positions(mask: torch.Tensor) -> torch.Tensor:
    """Each token's 0-based place in its expert's queue (an fp32 cumsum,
    exact below 2^24 tokens), 0 where ``mask`` is 0."""
    return torch.cumsum(mask, dim=0) * mask - mask


def top1_gating(logits: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-1 gating with capacity dropping: logits ``(S, E)`` ->
    (combine ``(S, E, C)`` fp32, dispatch ``(S, E, C)`` bool, aux loss)."""
    s, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _one_hot(torch.argmax(probs, dim=-1), e)
    pos = _queue_positions(onehot).sum(dim=-1).to(torch.int32)
    keep = (pos < capacity).float()
    gate = (probs * onehot).sum(dim=-1) * keep
    aux = (onehot.mean(dim=0) * probs.mean(dim=0)).sum() * e
    dispatch = onehot[:, :, None] * _one_hot(pos, capacity)[:, None, :]
    dispatch = dispatch * keep[:, None, None]
    combine = dispatch * gate[:, None, None]
    return combine, dispatch.bool(), aux


def gumbel_noise(shape, like: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws ``-log(E)``, ``E ~ Exp(1)``, from
    ``generator`` on ``like``'s device."""
    e = torch.empty(shape, dtype=torch.float32, device=like.device)
    return -torch.log(e.exponential_(generator=generator))


def top2_gating(logits: torch.Tensor, capacity: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-2 gating: logits ``(S, E)`` -> (combine ``(S, E, C)``,
    dispatch ``(S, E, C)`` bool, aux loss).

    Capacity ``2 * ceil(S / E)`` unless given. The second expert is the
    argmax of the other logits plus Gumbel noise: ``noise`` where given
    (a draw of the caller's), else drawn from ``generator`` where given,
    else none. The gate weights are normalised ``g / (g1 + g2)`` after
    capacity dropping, and the aux loss ``mean(me * ce) * E^2`` uses the
    top-1 dispatch alone."""
    s, e = logits.shape
    if capacity is None:
        capacity = 2 * -(-s // e)
    logits = logits.float()
    gates = torch.softmax(logits, dim=-1)
    mask1 = _one_hot(torch.argmax(gates, dim=-1), e)
    if noise is None and generator is not None:
        noise = gumbel_noise(logits.shape, logits, generator)
    noisy = logits if noise is None else logits + noise
    mask2 = _one_hot(torch.argmax(
        torch.where(mask1 > 0, -math.inf, noisy), dim=-1), e)

    # queue positions; the second experts' queues start after the first's
    loc1 = _queue_positions(mask1)
    loc2 = _queue_positions(mask2) + mask1.sum(dim=0, keepdim=True)
    aux = torch.mean(gates.mean(dim=0) * mask1.mean(dim=0)) * e * e

    mask1 = mask1 * (loc1 < capacity)
    mask2 = mask2 * (loc2 < capacity)
    g1 = (gates * mask1).sum(dim=-1)
    g2 = (gates * mask2).sum(dim=-1)
    denom = torch.clamp_min(g1 + g2, torch.finfo(torch.float32).eps)
    g1, g2 = g1 / denom, g2 / denom
    pos1 = (loc1 * mask1).sum(dim=-1).to(torch.int32)
    pos2 = (loc2 * mask2).sum(dim=-1).to(torch.int32)
    combine = ((g1[:, None] * mask1)[:, :, None]
               * _one_hot(pos1, capacity)[:, None, :]
               + (g2[:, None] * mask2)[:, :, None]
               * _one_hot(pos2, capacity)[:, None, :])
    return combine, combine > 0, aux


class MoeFeedForward(nn.Module):
    """Token-routed expert FFN: ``(out, aux)`` of ``x (B, L, D)``.

    Each expert is fc1 -> exact fp32 GELU -> fc2 over the tokens routed to
    it; the gate computes in fp32 outside autocast. With ``group`` (a
    process group of n ranks, each holding its own tokens), this rank
    holds experts ``rank * E / n ..`` of the E: the dispatched blocks go to
    the ranks that hold their experts and come back by
    :func:`..parallel.collectives.all_to_all_dim`. ``w1 (E_local, D, F)``,
    ``b1 (E_local, 1, F)``, ``w2 (E_local, F, D)`` and ``b2 (E_local, 1,
    D)`` keep the JAX layout. In training mode top-2 gating draws its
    Gumbel noise from the enclosing
    :func:`..layers.dropout_generator`, as JAX draws it from the
    ``"dropout"`` stream."""

    def __init__(self, dim: int, ffn_dim: int, num_experts: int,
                 capacity_factor: float = 1.0, gate_type: str = "top1",
                 group=None):
        super().__init__()
        if gate_type not in ("top1", "top2"):
            raise ValueError(f"unknown gate_type {gate_type!r}")
        n = 1 if group is None else dist.get_world_size(group)
        if num_experts % n:
            raise ValueError(f"{num_experts} experts do not share out over "
                             f"{n} ranks")
        local = num_experts // n
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.gate_type, self.group = gate_type, group
        self.gate = Dense(dim, num_experts, bias=False)
        self.w1 = nn.Parameter(torch.empty(local, dim, ffn_dim))
        self.b1 = nn.Parameter(torch.zeros(local, 1, ffn_dim))
        self.w2 = nn.Parameter(torch.empty(local, ffn_dim, dim))
        self.b2 = nn.Parameter(torch.zeros(local, 1, dim))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """The gate by :class:`..layers.Dense`'s rule; each expert's
        matrices LeCun-normal over its fan-in, the biases zero."""
        self.gate.init_weights(g)
        for w in (self.w1, self.w2):
            fill_normal_(w, w.shape[1] ** -0.5, g)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, length, d = x.shape
        s, e = b * length, self.num_experts
        tokens = x.reshape(s, d)
        with torch.autocast(x.device.type, enabled=False):
            logits = self.gate(tokens.float())
        if self.gate_type == "top2":
            capacity = max(1, int(self.capacity_factor * 2 * s / e))
            g = ambient_generator(x) if self.training else None
            combine, dispatch, aux = top2_gating(logits, capacity, g)
        else:
            capacity = max(1, int(self.capacity_factor * s / e))
            combine, dispatch, aux = top1_gating(logits, capacity)

        expert_in = torch.einsum("sec,sd->ecd", dispatch.to(x.dtype), tokens)
        local = self.w1.shape[0]
        n = e // local
        if self.group is not None:
            # (rank, E_local, C, D) blocks out; (source, E_local, C, D) in
            expert_in = all_to_all_dim(
                expert_in.reshape(n, local, capacity, d), 0, self.group)
            expert_in = expert_in.transpose(0, 1).reshape(
                local, n * capacity, d)
        h = torch.einsum("ecd,edf->ecf", expert_in,
                         self.w1.to(expert_in.dtype)) + self.b1.to(x.dtype)
        h = gelu_exact(h)
        h = torch.einsum("ecf,efd->ecd", h,
                         self.w2.to(h.dtype)) + self.b2.to(x.dtype)
        if self.group is not None:
            h = h.reshape(local, n, capacity, d).transpose(0, 1)
            h = all_to_all_dim(h, 0, self.group)
            h = h.reshape(e, capacity, d)
        out = torch.einsum("sec,ecd->sd", combine.to(h.dtype), h)
        return out.reshape(b, length, d), aux


# ---------------------------------------------------------------------------
# xPos rotary embedding and the T5 relative position bias
# ---------------------------------------------------------------------------


def apply_xpos(x: torch.Tensor, offset: int = 0, scale_base: float = 512.0,
               downscale: bool = False) -> torch.Tensor:
    """xPos, rotary embedding with exponential length scaling, in fp32:
    ``x (B, L, D_head)`` -> the same shape and dtype."""
    b, length, d = x.shape
    half = d // 2
    dev = x.device
    frac = torch.arange(half, device=dev, dtype=torch.float32) / half
    freqs = 1.0 / (10000.0 ** frac)
    pos = torch.arange(offset, offset + length, device=dev,
                       dtype=torch.float32)
    angles = pos[:, None] * freqs[None, :]
    zeta = ((frac + 0.4) / 1.4)[None, :] ** (pos[:, None] / scale_base)
    if downscale:
        zeta = 1.0 / zeta
    sin, cos = torch.sin(angles), torch.cos(angles)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1 * zeta, rot2 * zeta], dim=-1).to(x.dtype)


class RelativePositionBias(nn.Module):
    """T5 bucketed relative position bias: ``(H, qlen, klen)`` from the
    learnt ``rel_attn_bias (num_buckets, num_heads)``."""

    def __init__(self, num_buckets: int = 32, max_distance: int = 128,
                 num_heads: int = 12):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.rel_attn_bias = nn.Parameter(torch.empty(num_buckets, num_heads))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fill_normal_(self.rel_attn_bias, 0.02, g)

    @staticmethod
    def _bucket(rel: torch.Tensor, num_buckets: int,
                max_distance: int) -> torch.Tensor:
        n = -rel
        num_buckets //= 2
        ret = (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
        max_exact = num_buckets // 2
        is_small = n < max_exact
        # the product cast to int32 before max_exact is added, as in JAX
        val_large = max_exact + (
            torch.log(n.float() / max_exact + 1e-9)
            / math.log(max_distance / max_exact)
            * (num_buckets - max_exact)).to(torch.int32)
        val_large = torch.clamp_max(val_large, num_buckets - 1)
        return ret + torch.where(is_small, n.to(torch.int32), val_large)

    def forward(self, qlen: int, klen: int) -> torch.Tensor:
        dev = self.rel_attn_bias.device
        ctx = torch.arange(qlen, device=dev)[:, None]
        mem = torch.arange(klen, device=dev)[None, :]
        buckets = self._bucket(mem - ctx, self.num_buckets,
                               self.max_distance)
        return self.rel_attn_bias[buckets.long()].permute(2, 0, 1)
