"""Pathway-grouped gene encoder: S-MLP blocks, MLP-Mixer, compression;
and the genomics-only baseline on it.

Counterpart of ``modaltune_tpu/models/gene.py`` (``GeneMixerEncoder``,
``GeneOnlyModel``). The
data layer packs the genes into a zero-padded ``(n_groups, max_group_len)``
block, so the per-pathway SNN layers are stacked einsums; zero-padded
gene slots contribute nothing to the first layer. The raw parameters keep
the JAX package's names and layouts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import GeneEncoderConfig
from ..ops.activations import gelu_exact
from ..utils.tracing import span
from .heads import add_head, check_mode, head_outputs, init_head
from .layers import AlphaDropout, Dense, Dropout, fill_normal_


def _normal02(g: torch.Generator, *params: nn.Parameter) -> None:
    for p in params:
        fill_normal_(p, 0.02, g)


class TokenFeedForward(nn.Module):
    """Mixer token mixing: a dense layer over the group axis of (B, G, C)."""

    def __init__(self, groups: int, expansion: float, dropout: float):
        super().__init__()
        inner = int(groups * expansion)
        self.w1 = nn.Parameter(torch.empty(groups, inner))
        self.b1 = nn.Parameter(torch.empty(inner))
        self.w2 = nn.Parameter(torch.empty(inner, groups))
        self.b2 = nn.Parameter(torch.empty(groups))
        self.dropout = Dropout(dropout)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        _normal02(g, self.w1, self.w2)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.einsum("bgc,gi->bic", x, self.w1) + self.b1[None, :, None]
        h = self.dropout(gelu_exact(h))
        h = torch.einsum("bic,ig->bgc", h, self.w2) + self.b2[None, :, None]
        return self.dropout(h)


class ChannelFeedForward(nn.Module):
    """Mixer channel mixing over the latent axis."""

    def __init__(self, dim: int, expansion: float, dropout: float):
        super().__init__()
        inner = int(dim * expansion)
        self.fc1 = Dense(dim, inner, "normal02")
        self.fc2 = Dense(inner, dim, "normal02")
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(gelu_exact(self.fc1(x)))
        return self.dropout(self.fc2(h))


class _MixerBlock(nn.Module):
    def __init__(self, n_tokens: int, cfg: GeneEncoderConfig):
        super().__init__()
        self.token_norm = nn.LayerNorm(cfg.latent_dim, eps=1e-5)
        self.token = TokenFeedForward(n_tokens, cfg.expansion_groups,
                                      cfg.dropout)
        self.chan_norm = nn.LayerNorm(cfg.latent_dim, eps=1e-5)
        self.chan = ChannelFeedForward(cfg.latent_dim, cfg.expansion_dim,
                                       cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.token(self.token_norm(x))
        return x + self.chan(self.chan_norm(x))


class GeneMixerEncoder(nn.Module):
    """``genes (B, n_groups, max_group_len)`` -> gene tokens
    ``(B, final_groups, output_dim)``."""

    def __init__(self, cfg: GeneEncoderConfig, n_groups: int,
                 max_group_len: int):
        super().__init__()
        g, m, latent = n_groups, max_group_len, cfg.latent_dim
        self.cfg = cfg
        self.n_groups, self.max_group_len = n_groups, max_group_len
        self.snn1_kernel = nn.Parameter(torch.empty(g, m, latent))
        self.snn1_bias = nn.Parameter(torch.empty(g, latent))
        self.snn2_kernel = nn.Parameter(torch.empty(g, latent, latent))
        self.snn2_bias = nn.Parameter(torch.empty(g, latent))
        self.snn1_drop = AlphaDropout(cfg.dropout)
        self.snn2_drop = AlphaDropout(cfg.dropout)
        n_tokens = g + int(cfg.cls_token)
        self.cls_token = (nn.Parameter(torch.empty(1, 1, latent))
                          if cfg.cls_token else None)
        self.mix = nn.ModuleList(_MixerBlock(n_tokens, cfg)
                                 for _ in range(cfg.depth))
        self.mixer_norm = nn.LayerNorm(latent, eps=1e-5)
        self.mixer_out = Dense(latent, cfg.output_dim, "normal02")
        self.compress_kernel = nn.Parameter(
            torch.empty(n_tokens, cfg.final_groups))
        self.compress_bias = nn.Parameter(torch.empty(cfg.final_groups))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        _normal02(g, self.snn1_kernel, self.snn2_kernel, self.compress_kernel)
        for p in (self.snn1_bias, self.snn2_bias, self.compress_bias):
            p.zero_()
        if self.cls_token is not None:
            self.cls_token.zero_()

    def forward(self, genes: torch.Tensor) -> torch.Tensor:
        if tuple(genes.shape[-2:]) != (self.n_groups, self.max_group_len):
            raise ValueError(f"genes {tuple(genes.shape)} do not match "
                             f"({self.n_groups}, {self.max_group_len})")
        with span("mt.gene.mixer"):
            x = torch.einsum("bgm,gml->bgl", genes, self.snn1_kernel) \
                + self.snn1_bias
            x = self.snn1_drop(F.elu(x))
            x = torch.einsum("bgl,glk->bgk", x, self.snn2_kernel) \
                + self.snn2_bias
            x = self.snn2_drop(F.elu(x))
            if self.cls_token is not None:
                cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
                x = torch.cat([cls, x], dim=1)
            for block in self.mix:
                x = block(x)
            x = self.mixer_out(self.mixer_norm(x))
            return torch.einsum("bgc,gf->bfc", x, self.compress_kernel) \
                + self.compress_bias[None, :, None]


class GeneOnlyModel(nn.Module):
    """Genomics-only baseline (``gene_mixer_group``): the gene mixer, then
    the mode's output. ``feature`` returns the gene tokens (B,
    final_groups, output_dim); ``classifier`` the logits of the fp32 mean
    over tokens through LayerNorm and the head; ``survival`` the cumprod
    hazard tuple of those logits."""

    def __init__(self, cfg: GeneEncoderConfig, n_gene_groups: int,
                 max_group_len: int, n_classes: int = 2,
                 mode: str = "classifier"):
        super().__init__()
        self.n_classes, self.mode = n_classes, check_mode(mode)
        self.gene_encoder = GeneMixerEncoder(cfg, n_gene_groups,
                                             max_group_len)
        if mode != "feature":
            add_head(self, cfg.output_dim, n_classes)

    def init_weights(self, g: torch.Generator) -> None:
        if self.mode != "feature":
            init_head(self, g)

    def forward(self, genes: torch.Tensor):
        x = self.gene_encoder(genes)
        if self.mode == "feature":
            return x
        return head_outputs(self, x.float().mean(dim=1), self.mode)
