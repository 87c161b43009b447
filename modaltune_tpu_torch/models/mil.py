"""ABMIL and TransMIL, the supervised baselines over cached feature bags.

Counterpart of ``modaltune_tpu/models/mil.py``: gated-attention MIL (Ilse
et al. 2018) and TransMIL (Shao et al. 2021) with masked Nystrom
self-attention and the PPEG positional convs, over bucket-padded bags with
a validity mask; the "(cat)" variants run the pathway-grouped gene mixer
and concatenate its token mean before the head; outputs in "feature",
"classifier" or "survival" mode. They compute in fp32, as the JAX CLI
builds them, and call no kernel of the port: dense products and
convolutions are torch's.

Unlike Flax, torch needs the bag's width at construction (``in_dim``,
GigaPath's 1,536 by default). Submodules and raw parameters keep the Flax
names and layouts (``fc1``, ``attn_pool.attn_v``, ``head.final_norm``,
``head.classifier_kernel`` (in, C), ``cls_token``, ``layer1_norm``,
``layer1.res_conv`` (33, 1, heads), ``ppeg.conv7``, ``norm``, ...), so
``utils.convert.params_from_jax`` carries a JAX tree across by name.

Two properties of the JAX function are kept as they are: the PPEG's
output includes its input, and the model adds it to the instance tokens,
so those become ``2 h + sum(conv(h))`` (the original TransMIL replaces
``h``); and only the Nystrom third factor masks keys.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import GeneEncoderConfig
from .gene import GeneMixerEncoder
from .heads import add_head, check_mode, head_outputs, init_head
from .layers import Dense, Dropout, fill_normal_

_NEG = -1e9


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over ``dim`` counting only mask-true rows (the count clamped to
    >= 1, so an empty segment gives zeros, not NaN)."""
    m = mask.to(x.dtype)
    return (x * m).sum(dim) / m.sum(dim).clamp_min(1.0)


class GatedAttentionPool(nn.Module):
    """``a = softmax(w^T (tanh(V h) * sigmoid(U h)))`` over the valid
    instances -> (pooled (B, C), attention (B, N))."""

    def __init__(self, dim: int, attn_dim: int = 256):
        super().__init__()
        self.attn_v = Dense(dim, attn_dim, "normal02")
        self.attn_u = Dense(dim, attn_dim, "normal02")
        self.attn_w = Dense(attn_dim, 1, "normal02")

    def forward(self, h: torch.Tensor, mask: torch.Tensor):
        v = torch.tanh(self.attn_v(h))
        u = torch.sigmoid(self.attn_u(h))
        scores = self.attn_w(v * u)[..., 0]
        scores = torch.where(mask, scores.float(), _NEG)
        attn = torch.softmax(scores, dim=-1).to(h.dtype)
        return torch.einsum("bn,bnc->bc", attn, h), attn


class MilHead(nn.Module):
    """The feature / classifier / survival epilogue, with the optional gene
    "(cat)" fusion: the gene mixer's token mean joins the pooled vector."""

    def __init__(self, dim: int, n_classes: int, mode: str,
                 gene_cfg: Optional[GeneEncoderConfig], n_gene_groups: int,
                 max_group_len: int):
        super().__init__()
        self.mode = check_mode(mode)
        self.gene_encoder = None
        if gene_cfg is not None:
            self.gene_encoder = GeneMixerEncoder(gene_cfg, n_gene_groups,
                                                 max_group_len)
            dim += gene_cfg.output_dim
        if mode != "feature":
            add_head(self, dim, n_classes)

    def init_weights(self, g: torch.Generator) -> None:
        if self.mode != "feature":
            init_head(self, g)

    def forward(self, pooled: torch.Tensor,
                genes: Optional[torch.Tensor] = None):
        if self.gene_encoder is not None:
            if genes is None:
                raise ValueError("(cat) fusion model called without genes")
            gtok = self.gene_encoder(genes)
            pooled = torch.cat([pooled, gtok.mean(dim=1).to(pooled.dtype)],
                               dim=-1)
        if self.mode == "feature":
            return pooled
        return head_outputs(self, pooled, self.mode)


class _MilModel(nn.Module):
    """What the two MIL models share: ``fc1`` -> ReLU -> dropout on the
    bag, the head, and the "(cat)" switch."""

    def __init__(self, in_dim: int, hidden: int, n_classes: int, mode: str,
                 dropout: float, gene_cfg: Optional[GeneEncoderConfig],
                 n_gene_groups: int, max_group_len: int):
        super().__init__()
        self.n_classes, self.mode = n_classes, check_mode(mode)
        self.fc1 = Dense(in_dim, hidden, "normal02")
        self.drop = Dropout(dropout)
        self.head = MilHead(hidden, n_classes, mode, gene_cfg, n_gene_groups,
                            max_group_len)

    @property
    def use_genes(self) -> bool:
        return self.head.gene_encoder is not None

    def embed_bag(self, bag: torch.Tensor,
                  mask: Optional[torch.Tensor]):
        if mask is None:
            mask = torch.ones(bag.shape[:2], dtype=torch.bool,
                              device=bag.device)
        return self.drop(torch.relu(self.fc1(bag.float()))), mask


class AbmilModel(_MilModel):
    """Attention-based MIL: ``bag (B, N, in_dim)``, ``mask (B, N)`` bool
    [, ``genes`` for "(cat)"] -> feature (B, hidden [+ gene dim]), logits,
    or the survival tuple."""

    def __init__(self, in_dim: int = 1536, hidden: int = 512,
                 attn_dim: int = 256, n_classes: int = 2,
                 mode: str = "classifier", dropout: float = 0.25,
                 gene_cfg: Optional[GeneEncoderConfig] = None,
                 n_gene_groups: int = 0, max_group_len: int = 0):
        super().__init__(in_dim, hidden, n_classes, mode, dropout, gene_cfg,
                         n_gene_groups, max_group_len)
        self.attn_pool = GatedAttentionPool(hidden, attn_dim)

    def forward(self, bag: torch.Tensor, mask: Optional[torch.Tensor] = None,
                genes: Optional[torch.Tensor] = None):
        h, mask = self.embed_bag(bag, mask)
        pooled, _ = self.attn_pool(h, mask)
        return self.head(pooled, genes)


def _newton_schulz_pinv(a: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of batched (.., m, m) matrices by the
    cubic Newton-Schulz iteration (Nystromformer appendix B), started from
    ``a^T`` over max column-sum x max row-sum."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    scale = a.abs().sum(-2).amax(-1) * a.abs().sum(-1).amax(-1)
    z = a.transpose(-1, -2) / scale.clamp_min(1e-6)[..., None, None]
    for _ in range(iters):
        az = a @ z
        z = 0.25 * z @ (13.0 * eye - az @ (15.0 * eye - az @ (7.0 * eye - az)))
    return z


class NystromSelfAttention(nn.Module):
    """Masked Nystrom self-attention: landmark queries and keys are masked
    means over ``ceil(n / landmarks)``-row segments, only the third factor
    attends over individual keys (padded keys masked), the landmark kernel
    is inverted by Newton-Schulz in fp32; plus a per-head depthwise conv
    over the tokens on the value path (kernel 33, shared by a head's
    lanes; ``res_conv`` keeps the JAX layout (33, 1, heads))."""

    def __init__(self, dim: int, heads: int = 8, landmarks: int = 64,
                 pinv_iters: int = 6, conv_kernel: int = 33):
        super().__init__()
        self.dim, self.heads, self.landmarks = dim, heads, landmarks
        self.pinv_iters = pinv_iters
        self.qkv = Dense(dim, 3 * dim, "normal02", bias=False)
        self.res_conv = nn.Parameter(torch.empty(conv_kernel, 1, heads))
        self.proj = Dense(dim, dim, "normal02")

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fill_normal_(self.res_conv, 0.02, g)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh = self.heads, self.dim // self.heads
        q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        q = q * dh ** -0.5
        # zero the padded rows, so landmark means and the value product
        # never see padding
        mrow = mask[:, None, :, None].to(q.dtype)
        q, k, v = q * mrow, k * mrow, v * mrow

        m = self.landmarks
        pad = (-n) % m
        qp, kp = F.pad(q, (0, 0, 0, pad)), F.pad(k, (0, 0, 0, pad))
        mp = F.pad(mask, (0, pad))
        seg = qp.shape[2] // m
        segmask = mp.reshape(b, 1, m, seg, 1)
        q_l = masked_mean(qp.reshape(b, h, m, seg, dh), segmask, dim=3)
        k_l = masked_mean(kp.reshape(b, h, m, seg, dh), segmask, dim=3)

        sim1 = torch.einsum("bhnd,bhmd->bhnm", q, k_l).float()
        sim2 = torch.einsum("bhmd,bhld->bhml", q_l, k_l).float()
        sim3 = torch.einsum("bhmd,bhnd->bhmn", q_l, k).float()
        sim3 = torch.where(mask[:, None, None, :], sim3, _NEG)
        a1 = torch.softmax(sim1, dim=-1).to(x.dtype)
        a2inv = _newton_schulz_pinv(torch.softmax(sim2, dim=-1),
                                    self.pinv_iters).to(x.dtype)
        a3 = torch.softmax(sim3, dim=-1).to(x.dtype)
        out = a1 @ a2inv @ (a3 @ v)

        # channel c = head * dh + lane, as the JAX conv lays it out
        weight = self.res_conv[:, 0, :].t().repeat_interleave(dh, dim=0)
        vt = v.transpose(1, 2).reshape(b, n, h * dh).transpose(1, 2)
        vc = F.conv1d(vt, weight[:, None, :].to(vt.dtype),
                      padding=self.res_conv.shape[0] // 2, groups=h * dh)
        out = out + vc.reshape(b, h, dh, n).transpose(2, 3)

        out = out.transpose(1, 2).reshape(b, n, self.dim)
        return self.proj(out * mask[:, :, None].to(out.dtype))


class DepthwiseConv2d(nn.Conv2d):
    """``nn.Conv2d(groups=C)`` with "SAME" padding and flax's initialiser
    for it (N(0, 0.02) kernel, zero bias). ``utils.convert`` turns a Flax
    (kh, kw, 1, C) kernel into this (C, 1, kh, kw) weight."""

    def __init__(self, channels: int, size: int):
        super().__init__(channels, channels, size, padding=size // 2,
                         groups=channels)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fill_normal_(self.weight, 0.02, g)
        self.bias.zero_()


class PPEG(nn.Module):
    """Pyramid position encoding: the instance tokens squared into a
    (side, side) grid, ``x + conv7(x) + conv5(x) + conv3(x)`` (depthwise),
    padded cells zeroed before and after."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv7 = DepthwiseConv2d(dim, 7)
        self.conv5 = DepthwiseConv2d(dim, 5)
        self.conv3 = DepthwiseConv2d(dim, 3)

    def forward(self, tokens: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        b, n, c = tokens.shape
        side = math.isqrt(n)
        if side * side < n:
            side += 1
        keep = mask[:, :, None].to(tokens.dtype)
        x = F.pad(tokens * keep, (0, 0, 0, side * side - n))
        x = x.reshape(b, side, side, c).permute(0, 3, 1, 2)
        y = x + self.conv7(x) + self.conv5(x) + self.conv3(x)
        y = y.permute(0, 2, 3, 1).reshape(b, side * side, c)[:, :n]
        return y * keep


class TransMilModel(_MilModel):
    """TransMIL: fc1 -> cls token -> Nystrom layer -> PPEG on the instance
    tokens -> Nystrom layer -> LayerNorm -> the cls token's head."""

    def __init__(self, in_dim: int = 1536, hidden: int = 512, heads: int = 8,
                 landmarks: int = 64, n_classes: int = 2,
                 mode: str = "classifier", dropout: float = 0.1,
                 gene_cfg: Optional[GeneEncoderConfig] = None,
                 n_gene_groups: int = 0, max_group_len: int = 0):
        super().__init__(in_dim, hidden, n_classes, mode, dropout, gene_cfg,
                         n_gene_groups, max_group_len)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.layer1_norm = nn.LayerNorm(hidden, eps=1e-5)
        self.layer1 = NystromSelfAttention(hidden, heads, landmarks)
        self.ppeg = PPEG(hidden)
        self.layer2_norm = nn.LayerNorm(hidden, eps=1e-5)
        self.layer2 = NystromSelfAttention(hidden, heads, landmarks)
        self.norm = nn.LayerNorm(hidden, eps=1e-5)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        self.cls_token.zero_()

    def forward(self, bag: torch.Tensor, mask: Optional[torch.Tensor] = None,
                genes: Optional[torch.Tensor] = None):
        h, mask = self.embed_bag(bag, mask)
        b = h.shape[0]
        h = torch.cat([self.cls_token.to(h.dtype).expand(b, 1, -1), h], dim=1)
        m1 = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
        h = h + self.layer1(self.layer1_norm(h), m1)
        # the PPEG runs on the instance tokens only; cls passes through
        h = torch.cat([h[:, :1], h[:, 1:] + self.ppeg(h[:, 1:], mask)], dim=1)
        h = h + self.layer2(self.layer2_norm(h), m1)
        return self.head(self.norm(h)[:, 0], genes)
