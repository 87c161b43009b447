"""Shared building blocks of the Modal Adapter, and weight initialisation.

Counterpart of ``modaltune_tpu/models/layers.py``: dropout, stochastic
depth, alpha dropout, a torch ``nn.MultiheadAttention``-style attention with
separate q/k/v input widths whose inner product runs through
:func:`..ops.flash_attention` (the K2 kernel on CUDA), and the pre-norm
cross-attention, self-attention and FFN layers of the adapter.
Parameter names follow the JAX package, so ``utils.convert`` maps one
onto the other by name.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import NEG_INF, flash_attention
from ..ops.kept import KeptOutputs

_DROPOUT_GENERATOR: contextvars.ContextVar[Optional[torch.Generator]] = \
    contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(g: torch.Generator) -> Iterator[torch.Generator]:
    """Every dropout of a model in training mode run inside this context
    draws its random bits from ``g`` (a generator on the tensors' device),
    as the JAX modules draw from the ``"dropout"`` rng stream."""
    token = _DROPOUT_GENERATOR.set(g)
    try:
        yield g
    finally:
        _DROPOUT_GENERATOR.reset(token)


def ambient_generator(x: torch.Tensor) -> torch.Generator:
    """The generator of the enclosing :func:`dropout_generator`, which
    must lie on ``x``'s device type."""
    g = _DROPOUT_GENERATOR.get()
    if g is None:
        raise RuntimeError("dropout in training mode needs a generator: run "
                           "the model inside dropout_generator(g)")
    if g.device.type != x.device.type:
        raise ValueError(f"dropout generator on {g.device}, tensor on "
                         f"{x.device}")
    return g


def rematerialized(fn: Callable, *args, keep_attention: bool = False):
    """``fn(*args)`` with the tensors its backward needs dropped after the
    forward and recomputed by running ``fn`` again in the backward
    (non-reentrant ``torch.utils.checkpoint``: gradients reach ``args``,
    none reaches a frozen parameter).

    The recompute runs in a copy of this call's context, so inside the
    enclosing :func:`dropout_generator` whatever thread the backward runs
    on, with that generator set back to its state at this call: it draws
    the forward's bits again, and the generator is left where the backward
    found it. (``torch.utils.checkpoint``'s ``preserve_rng_state`` saves
    only the default generators, from which the models draw nothing.)

    With ``keep_attention`` the attention Functions inside keep the outputs
    their backward needs across the recompute (:mod:`..ops.kept`): the
    recompute takes those back instead of running their forward kernels
    again, and recomputes everything else, their inputs included."""
    g = _DROPOUT_GENERATOR.get()
    state = None if g is None else g.get_state()
    context = contextvars.copy_context()
    outputs = KeptOutputs() if keep_attention else None
    calls = []

    def run(*a):
        if not calls:       # the forward
            calls.append(True)
            with _keeping(outputs, replay=False):
                return fn(*a)
        return context.run(_replay, g, state, fn, a, outputs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _keeping(outputs: Optional[KeptOutputs], replay: bool):
    return contextlib.nullcontext() if outputs is None else \
        outputs.active(replay)


def _replay(g: Optional[torch.Generator], state, fn: Callable, args,
            outputs: Optional[KeptOutputs]):
    with _keeping(outputs, replay=True):
        if g is None:
            return fn(*args)
        now = g.get_state()
        g.set_state(state)
        try:
            return fn(*args)
        finally:
            g.set_state(now)


def _uniform(shape, x: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=ambient_generator(x), device=x.device)


class Dropout(nn.Module):
    """Element dropout scaling kept values by 1/keep; identity in eval mode
    or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        return torch.where(_uniform(x.shape, x) < keep, x / keep, 0.0)


class AlphaDropout(Dropout):
    """SELU-preserving dropout (torch ``nn.AlphaDropout`` semantics)."""

    ALPHA_P = -1.7580993408473766  # -scale * alpha of SELU

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        p = self.rate
        a = ((1.0 - p) * (1.0 + p * self.ALPHA_P ** 2)) ** -0.5
        b = -a * p * self.ALPHA_P
        keep = _uniform(x.shape, x) < 1.0 - p
        return a * torch.where(keep, x, self.ALPHA_P) + b


def fill_normal_(p: torch.Tensor, std: float, g: torch.Generator) -> None:
    """``p <- N(0, std)`` drawn on ``g``'s device (the CPU, as a rule) and
    copied to ``p``'s, so the values do not depend on where ``p`` lies."""
    p.copy_(torch.empty(p.shape, dtype=torch.float32, device=g.device)
            .normal_(0.0, std, generator=g))


class Dense(nn.Linear):
    """``nn.Linear`` that names the JAX package's initialiser for it:
    ``"lecun"`` (flax's Dense default), ``"xavier"``, ``"normal02"``,
    ``"he_uniform"`` or ``"zeros"`` (a LoRA adapter's A and B)."""

    def __init__(self, in_features: int, out_features: int,
                 init: str = "lecun", bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        if init not in ("lecun", "xavier", "normal02", "he_uniform", "zeros"):
            raise ValueError(f"unknown initialiser {init!r}")
        self.init_name = init

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fan_out, fan_in = self.weight.shape
        if self.init_name in ("xavier", "he_uniform"):
            bound = math.sqrt(6.0 / (fan_in + fan_out)
                              if self.init_name == "xavier" else 6.0 / fan_in)
            self.weight.copy_(torch.empty(self.weight.shape, device=g.device)
                              .uniform_(-bound, bound, generator=g))
        elif self.init_name == "zeros":
            self.weight.zero_()
        else:
            std = 0.02 if self.init_name == "normal02" else fan_in ** -0.5
            fill_normal_(self.weight, std, g)
        if self.bias is not None:
            self.bias.zero_()


def init_weights(model: nn.Module, g: torch.Generator) -> nn.Module:
    """Initialise every parameter of ``model`` from the generator ``g``:
    a module with an ``init_weights(g)`` method sets its own parameters,
    a LayerNorm gets ones and zeros. Raises if a parameter is left out."""
    done = set()
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(g)
        elif isinstance(m, nn.LayerNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    missed = [n for n, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise RuntimeError(f"parameters without an initialiser: {missed}")
    return model


class DropPath(Dropout):
    """Per-sample stochastic depth (timm semantics: scale kept samples by
    1/keep); identity in eval mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.where(_uniform(shape, x) < keep, x / keep, 0.0)


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """(.., L) bool validity mask -> additive fp32 bias (0 / NEG_INF)."""
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


class TorchMHA(nn.Module):
    """torch ``nn.MultiheadAttention``-style attention with separate q/k/v
    input widths (the adapter compresses queries while keys and values
    stay at the model width); the inner product is :func:`flash_attention`.
    """

    def __init__(self, embed_dim: int, num_heads: int,
                 kdim: Optional[int] = None, vdim: Optional[int] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"{embed_dim} is not divisible by {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.q_proj = Dense(embed_dim, embed_dim, "xavier")
        self.k_proj = Dense(kdim or embed_dim, embed_dim, "xavier")
        self.v_proj = Dense(vdim or embed_dim, embed_dim, "xavier")
        self.out_proj = Dense(embed_dim, embed_dim, "xavier")

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        dh = e // h
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        b, lq, lk = q.shape[0], q.shape[1], k.shape[1]

        def split(t, length):
            return (t.reshape(b, length, h, dh).transpose(1, 2)
                    .reshape(b * h, length, dh))

        bias = None
        if key_mask is not None:
            # row b*h + head, as jnp.repeat(.., h, axis=0) lays it out
            bias = mask_to_bias(key_mask).repeat_interleave(h, dim=0)
        out, _ = flash_attention(split(q, lq), split(k, lk), split(v, lk),
                                 bias, scale=dh ** -0.5)
        out = out.reshape(b, h, lq, dh).transpose(1, 2).reshape(b, lq, e)
        return self.out_proj(out)


class CrossAttentionLayer(nn.Module):
    """Pre-norm cross-attention with an optional compressed bottleneck.

    The layer returns ``tgt + attn``, its own residual; Injector and
    Extractor add a second residual on top, as the reference does.
    """

    def __init__(self, d_model: int, nheads: int, with_cffn: bool = True,
                 cffn_ratio: float = 0.25):
        super().__init__()
        inner = int(d_model * cffn_ratio) if with_cffn else d_model
        self.with_cffn = with_cffn
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.norm_kq = nn.LayerNorm(d_model, eps=1e-5)
        if with_cffn:
            self.q_proj = Dense(d_model, inner, "xavier")
            self.output_proj = Dense(inner, d_model, "xavier")
        self.multihead_attn = TorchMHA(inner, nheads, kdim=d_model,
                                       vdim=d_model)

    def forward(self, tgt, memory, pos=None, query_pos=None,
                memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        tgt2 = self.norm(tgt)
        mem = self.norm_kq(memory)
        q_in = tgt2 if query_pos is None else tgt2 + query_pos
        if self.with_cffn:
            q_in = self.q_proj(q_in)
        kv = mem if pos is None else mem + pos
        attn = self.multihead_attn(q_in, kv, kv, key_mask=memory_mask)
        if self.with_cffn:
            attn = self.output_proj(attn)
        return tgt + attn


class SelfAttentionLayer(nn.Module):
    """Pre-norm self-attention over the modal tokens: q and k carry the
    position embedding, the value (``tgt2``) does not."""

    def __init__(self, d_model: int, nheads: int, with_cffn: bool = True,
                 cffn_ratio: float = 0.25, dropout: float = 0.0):
        super().__init__()
        inner = int(d_model * cffn_ratio) if with_cffn else d_model
        self.with_cffn = with_cffn
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        if with_cffn:
            self.q_proj = Dense(d_model, inner, "xavier")
            self.output_proj = Dense(inner, d_model, "xavier")
        self.self_attn = TorchMHA(inner, nheads, kdim=d_model, vdim=d_model)
        self.dropout = Dropout(dropout)

    def forward(self, tgt: torch.Tensor,
                query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        tgt2 = self.norm(tgt)
        qk = tgt2 if query_pos is None else tgt2 + query_pos
        q_in = self.q_proj(qk) if self.with_cffn else qk
        attn = self.self_attn(q_in, qk, tgt2)
        if self.with_cffn:
            attn = self.output_proj(attn)
        return tgt + self.dropout(attn)


class FFNLayer(nn.Module):
    """Pre-norm FFN that returns the branch only (no residual inside)."""

    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Dense(d_model, dim_feedforward, "xavier")
        self.linear2 = Dense(dim_feedforward, d_model, "xavier")

    def forward(self, tgt: torch.Tensor) -> torch.Tensor:
        return self.linear2(torch.relu(self.linear1(self.norm(tgt))))
