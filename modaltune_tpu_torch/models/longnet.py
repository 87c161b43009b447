"""LongNet dilated-attention encoder (the frozen GigaPath backbone's layers).

Counterpart of ``modaltune_tpu/models/longnet.py``: pre-norm sub-LN
encoder layers whose self-attention is
:func:`..ops.dilated_mega.mega_dilated_attention` (the K1 kernel on CUDA)
or, with ``LongNetConfig.mega_attention`` off,
:func:`..ops.dilated_fused.fused_dilated_attention` (K3) or, with
``LongNetConfig.fused_attention`` off, :func:`..ops.dilated.dilated_attention`
with every branch on the K2 flash kernels, and whose FFN is
fc1 -> exact fp32 GELU -> sub-LN -> fc2, the GELU and the sub-LN as two ops
or, when asked for, as the one fused op :func:`..ops.gelu_ln.gelu_ln` (K5).
With ``LongNetConfig.lora_adapter`` the self-attention is
:class:`.extras.LoraDilatedSelfAttention` (per-modality LoRA deltas on
q/k/v, every branch on K2), as the JAX encoder builds it.
Padded tokens are masked out of every attention and re-zeroed after every
layer. The JAX package's span stacking and comb layouts are TPU machinery
and have no counterpart: the layers are a plain ``nn.ModuleList`` and
:meth:`LongNetEncoder.run_layers` runs any ``[lo, hi)``.

With ``LongNetConfig.remat`` every layer run under autograd is
rematerialized (JAX's ``nn.remat`` around the scanned layer) under the
policy named by ``remat_policy`` (:func:`remat_policy`): its activations
are recomputed in the backward, the attention call's included or not.
The kernels are reached through ``ctypes``, so no selective checkpoint
policy can see them by name; the layer is split instead. Under
``"flash"`` one checkpointed region runs LayerNorm -> q/k/v -> the
attention call, whose Function keeps its kernel's outputs across the
recompute (:mod:`..ops.kept`): the backward holds the layer's output, the
attention's output and what the attention's backward kernel reads besides
q/k/v (K1's stats; K3's compact lses and mix statistics; the per-branch
route's K2 outputs and lses), JAX's tagged set, and recomputes q/k/v
without launching the forward kernel again. A second region runs the
output projection, the residuals, the FFN and the re-mask. Under
``"flash_ffn"`` the first region ends at q/k/v, which the attention call
keeps as JAX's ``attn_qkv`` tag does, and the second is cut after fc1.
Under ``"full"`` the whole layer is one region. The forward-only steps
run no grad, and there remat does nothing.

With ``LongNetConfig.seq_axes`` set and an ambient mesh
(:func:`..ops.dilated_sp.use_mesh`) that the shape suits
(:func:`..ops.dilated_sp.span_shard`), a span runs on this rank's token
shard of the ``seq`` group: it enters by a slice, every layer's attention
is the sequence-parallel island on that shard
(:func:`..ops.dilated_sp.sp_mega_dilated_attention`, which takes the place
of K1 and K3) and every other op is position-wise, and it leaves by a
gather. The JAX package partitions the whole model along
tokens instead (GSPMD); outside the spans the port's adapter runs
replicated on every rank.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
from torch import nn

from ..configs import LongNetConfig
from ..ops.activations import gelu_exact
from ..ops.dilated import dilated_attention
from ..ops.dilated_fused import fused_dilated_attention
from ..ops.dilated_mega import mega_dilated_attention
from ..ops.dilated_sp import (SeqShard, enter_span, leave_span,
                              local_tokens, sp_mega_dilated_attention,
                              span_shard)
from ..ops.gelu_ln import gelu_ln
from ..utils.tracing import span
from .layers import Dense, DropPath, Dropout, rematerialized


def remat_policy(name: str) -> Optional[str]:
    """How a rematerialized layer is cut, by the JAX package's policy name
    (``modaltune_tpu/models/longnet.py::remat_policy``): None for
    ``"full"``, ``"none"`` and ``""``, whose layer is one checkpointed
    region, so its backward keeps nothing but the layer's input and
    recomputes everything, the attention's forward kernel included; the
    name itself for ``"flash"`` (a region through the attention call, which
    keeps its kernel's outputs: K1's out and stats; K3's mixed out, compact
    lses, m and Z; the per-branch route's K2 out and lse; the recompute
    rebuilds q/k/v and launches no attention kernel; then a region of the
    rest of the layer) and ``"flash_ffn"`` (the attention call between a
    region that ends at q/k/v, which it keeps, and one cut after fc1,
    whose pre-activation is kept too). Any other name raises ValueError,
    as JAX's does."""
    if name in ("full", "none", ""):
        return None
    if name in ("flash", "flash_ffn"):
        return name
    raise ValueError(f"unknown remat policy {name!r}")


class DilatedSelfAttention(nn.Module):
    """q/k/v/out projections around multi-branch dilated attention, with
    the sub-LN ``inner_attn_ln`` before the output projection. The
    attention is the one-launch K1 with ``cfg.mega_attention``, else the
    per-branch K3; with ``cfg.fused_attention`` off (the CLI's
    ``--fused_attention 0``) it is :func:`..ops.dilated.dilated_attention`
    with each branch on the K2 flash kernels, as the JAX package then runs
    ``dilated_attention(use_pallas=None)``. In a span sharded over tokens
    (``shard``) it is the island on that shard. All compute one function.
    :meth:`project`, :meth:`attend` and :meth:`output` are the three
    steps of :meth:`forward`, which the encoder layer's remat calls apart."""

    def __init__(self, cfg: LongNetConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.q_proj = Dense(d, d)
        self.k_proj = Dense(d, d)
        self.v_proj = Dense(d, d)
        self.out_proj = Dense(d, d)
        self.inner_attn_ln = (nn.LayerNorm(d, eps=cfg.layernorm_eps)
                              if cfg.subln else None)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shard: Optional[SeqShard] = None) -> torch.Tensor:
        return self.output(self.attend(*self.project(x), mask, shard))

    def project(self, x: torch.Tensor):
        """x (B, L, d) -> q, k, v (B, L, heads, head_dim)."""
        b, length, _ = x.shape
        c = self.cfg
        return tuple(p(x).view(b, length, c.num_heads, c.head_dim)
                     for p in (self.q_proj, self.k_proj, self.v_proj))

    def attend(self, q, k, v, mask: Optional[torch.Tensor] = None,
               shard: Optional[SeqShard] = None) -> torch.Tensor:
        """The attention of q, k, v -> (B, L, d)."""
        c = self.cfg
        if shard is not None:
            attn = functools.partial(sp_mega_dilated_attention, shard=shard)
        elif not c.fused_attention:
            attn = functools.partial(dilated_attention, kernel=True)
        elif c.mega_attention:
            attn = mega_dilated_attention
        else:
            attn = fused_dilated_attention
        out = attn(q, k, v, segment_lengths=c.segment_lengths,
                   dilated_ratios=c.dilated_ratios,
                   mask=mask if c.mask_padding else None)
        return out.reshape(q.shape[0], q.shape[1], c.embed_dim)

    def output(self, out: torch.Tensor) -> torch.Tensor:
        if self.inner_attn_ln is not None:
            out = self.inner_attn_ln(out)
        return self.out_proj(out)


def fused_gelu_ln_requested() -> bool:
    """The JAX package's switch for the fused GELU -> LayerNorm FFN route,
    the environment variable ``MODALTUNE_FUSED_GELU_LN``."""
    return os.environ.get("MODALTUNE_FUSED_GELU_LN", "0") == "1"


class FeedForwardNetwork(nn.Module):
    """fc1 -> exact GELU (fp32) -> dropout -> [sub-LN] -> fc2 -> dropout.

    With ``fused_gelu_ln`` (``None`` reads ``MODALTUNE_FUSED_GELU_LN`` once,
    here), sub-LN, and no activation dropout to apply, the GELU and the
    LayerNorm run as the one op :func:`..ops.gelu_ln.gelu_ln` on
    ``ffn_layernorm``'s parameters; the ``state_dict`` is the same on
    either route."""

    def __init__(self, cfg: LongNetConfig,
                 fused_gelu_ln: Optional[bool] = None):
        super().__init__()
        self.fused_gelu_ln = (fused_gelu_ln_requested()
                              if fused_gelu_ln is None else bool(fused_gelu_ln))
        self.fc1 = Dense(cfg.embed_dim, cfg.ffn_dim)
        self.fc2 = Dense(cfg.ffn_dim, cfg.embed_dim)
        self.ffn_layernorm = (nn.LayerNorm(cfg.ffn_dim, eps=cfg.layernorm_eps)
                              if cfg.subln else None)
        self.activation_dropout = Dropout(cfg.activation_dropout)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.after_fc1(self.fc1(x))

    def after_fc1(self, x: torch.Tensor) -> torch.Tensor:
        """Everything past fc1, on its pre-activation ``x``."""
        ln = self.ffn_layernorm
        if self.fused_gelu_ln and ln is not None and not (
                self.training and self.activation_dropout.rate > 0):
            x = gelu_ln(x, ln.weight, ln.bias, ln.eps)
        else:
            x = self.activation_dropout(gelu_exact(x))
            if ln is not None:
                x = ln(x)
        return self.dropout(self.fc2(x))


class LongNetEncoderLayer(nn.Module):
    """Pre-norm encoder layer; padded positions are re-zeroed at the end.

    With ``cfg.lora_adapter`` its self-attention is
    :class:`.extras.LoraDilatedSelfAttention` (the JAX package's
    ``LongNetLoraAdapterEncoder`` variant), given a zero gene and task
    context, as the JAX layer is when its caller passes none. With
    ``cfg.remat`` and grad enabled it runs rematerialized (see the module
    docstring); an unknown ``cfg.remat_policy`` raises here."""

    def __init__(self, cfg: LongNetConfig, drop_path_rate: float = 0.0,
                 fused_gelu_ln: Optional[bool] = None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.split = remat_policy(cfg.remat_policy) if cfg.remat else None
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.layernorm_eps)
        if cfg.lora_adapter:
            from .extras import LoraDilatedSelfAttention
            self.self_attn = LoraDilatedSelfAttention(
                cfg, lora_alpha=cfg.lora_alpha, img_rank=cfg.img_lora_dim,
                mm_rank=cfg.mm_lora_dim, lora_dropout=cfg.lora_dropout)
        else:
            self.self_attn = DilatedSelfAttention(cfg)
        self.dropout = Dropout(cfg.dropout)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layernorm_eps)
        self.ffn = FeedForwardNetwork(cfg, fused_gelu_ln)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shard: Optional[SeqShard] = None) -> torch.Tensor:
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return self._layer(x, mask, shard)
        if self.split is None:
            return rematerialized(self._layer, x, mask, shard)
        if self.split == "flash":
            out = rematerialized(self._attention, x, mask, shard,
                                 keep_attention=True)
            return rematerialized(self._rest, x, out, mask)
        with span("mt.backbone.attention"):
            q, k, v = rematerialized(self._qkv, x)
            out = self.self_attn.attend(q, k, v, mask, shard)
        with span("mt.backbone.ffn"):
            x, h = rematerialized(self._to_fc1, x, out)
            return rematerialized(self._from_fc1, x, h, mask)

    def _layer(self, x, mask, shard):
        return self._rest(x, self._attention(x, mask, shard), mask)

    def _attention(self, x, mask, shard):
        with span("mt.backbone.attention"):
            return self.self_attn.attend(*self._qkv(x), mask, shard)

    def _qkv(self, x):
        h = self.self_attn_layer_norm(x)
        if self.cfg.lora_adapter:
            zero = h.new_zeros(h.shape[0], 1, h.shape[2])
            return self.self_attn.project(h, zero, zero)
        return self.self_attn.project(h)

    def _rest(self, x, out, mask):
        with span("mt.backbone.ffn"):
            return self._from_fc1(*self._to_fc1(x, out), mask)

    def _to_fc1(self, x, out):
        x = x + self.drop_path(self.dropout(self.self_attn.output(out)))
        return x, self.ffn.fc1(self.final_layer_norm(x))

    def _from_fc1(self, x, h, mask):
        x = x + self.drop_path(self.ffn.after_fc1(h))
        if mask is not None and self.cfg.mask_padding:
            x = x * mask[..., None].to(x.dtype)
        return x


class LongNetEncoder(nn.Module):
    """The encoder with the split API the Modal Adapter needs:
    :meth:`prepare` (embedding dropout, zero padded positions),
    :meth:`run_layers` over any ``[lo, hi)``, and :meth:`finalize` (the
    encoder LayerNorm, used only when the backbone pools by itself)."""

    def __init__(self, cfg: LongNetConfig, with_final_norm: bool = True,
                 fused_gelu_ln: Optional[bool] = None):
        super().__init__()
        n = cfg.num_layers
        rates = ([cfg.drop_path_rate * i / (n - 1) for i in range(n)]
                 if cfg.drop_path_rate > 0 and n > 1 else [0.0] * n)
        self.cfg = cfg
        self.embed_dropout = Dropout(cfg.dropout)
        self.layers = nn.ModuleList(
            LongNetEncoderLayer(cfg, rates[i], fused_gelu_ln)
            for i in range(n))
        self.layer_norm = (
            nn.LayerNorm(cfg.embed_dim, eps=cfg.layernorm_eps)
            if with_final_norm and cfg.normalize_output
            and cfg.normalize_before else None)

    def prepare(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed_dropout(x)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x

    def run_layers(self, x: torch.Tensor, lo: int, hi: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not 0 <= lo <= hi <= len(self.layers):
            raise ValueError(f"run_layers({lo}, {hi}) outside "
                             f"[0, {len(self.layers)}]")
        shard = span_shard(self.cfg, x.shape[1]) if hi > lo else None
        if shard is None:
            for layer in self.layers[lo:hi]:
                x = layer(x, mask)
            return x
        x, mask = enter_span(x, shard), local_tokens(mask, shard)
        for layer in self.layers[lo:hi]:
            x = layer(x, mask, shard)
        return leave_span(x, shard)

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.layer_norm is None else self.layer_norm(x)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.prepare(x, mask)
        x = self.run_layers(x, 0, len(self.layers), mask)
        return self.finalize(x)
