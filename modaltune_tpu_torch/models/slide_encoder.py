"""LongNetViT slide encoder (the frozen Prov-GigaPath backbone).

Counterpart of ``modaltune_tpu/models/slide_encoder.py``. The 2-D sin-cos
position embedding is computed from the tile coordinates on the fly
instead of gathered from a ``(1000^2 + 1, 768)`` table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs import LongNetConfig, SlideEncoderConfig
from .layers import Dense, fill_normal_
from .longnet import LongNetEncoder


def sincos_1d(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """MAE-style 1-D sin-cos embedding ``[sin(pos*w), cos(pos*w)]`` with
    ``w_k = 10000^(-k/(dim/2))``, in fp32."""
    if dim % 2:
        raise ValueError(f"sincos_1d needs an even dim, got {dim}")
    omega = torch.arange(dim // 2, dtype=torch.float32,
                         device=pos.device) / (dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    out = pos[..., None].float() * omega
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def coords_pos_embed(coords: torch.Tensor, embed_dim: int,
                     tile_size: int = 256) -> torch.Tensor:
    """2-D sin-cos position embedding at tile coordinates ``(..., 2)``:
    grid cell ``(i, j) = floor(coords / tile)`` embeds as
    ``[sincos(j), sincos(i)]``, the reference table's row order."""
    g = torch.floor(coords.float() / float(tile_size))
    half = embed_dim // 2
    return torch.cat([sincos_1d(g[..., 1], half), sincos_1d(g[..., 0], half)],
                     dim=-1)


class PatchEmbed(nn.Module):
    """Tile-feature embedding: Linear in_chans -> embed_dim."""

    def __init__(self, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Dense(in_chans, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class LongNetViT(nn.Module):
    """Frozen slide-level backbone with the split API the adapter uses:
    :meth:`embed`, :meth:`run_layers` and :meth:`pool`.

    ``pool_head=False`` leaves out the encoder and ViT output LayerNorms,
    which only :meth:`pool` uses; ModalTune never pools through the
    backbone, and the JAX package's ModalTune parameters have neither.
    ``longnet`` overrides the encoder configuration ``cfg.longnet()`` (to
    turn ``mega_attention`` off, say); ``fused_gelu_ln`` picks the FFN
    route (:class:`.longnet.FeedForwardNetwork`).
    """

    def __init__(self, cfg: SlideEncoderConfig, pool_head: bool = True,
                 longnet: Optional[LongNetConfig] = None,
                 fused_gelu_ln: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.in_chans, cfg.embed_dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.embed_dim))
        self.encoder = LongNetEncoder(
            cfg.longnet() if longnet is None else longnet,
            with_final_norm=pool_head, fused_gelu_ln=fused_gelu_ln)
        self.norm = (nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
                     if pool_head else None)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fill_normal_(self.cls_token, 0.02, g)

    def embed(self, x: torch.Tensor, coords: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (tokens (B, 1+L, D), seq_mask (B, 1+L) or None): patch embed
        plus position, the cls token prepended (its mask entry is 1), then
        the encoder's prepare."""
        c = self.cfg
        h = self.patch_embed(x)
        h = h + coords_pos_embed(coords, c.embed_dim, c.tile_size).to(h.dtype)
        cls = self.cls_token.to(h.dtype).expand(h.shape[0], 1, c.embed_dim)
        h = torch.cat([cls, h], dim=1)
        seq_mask = None
        if mask is not None:
            ones = torch.ones((h.shape[0], 1), dtype=mask.dtype,
                              device=mask.device)
            seq_mask = torch.cat([ones, mask], dim=1)
        return self.encoder.prepare(h, seq_mask), seq_mask

    def run_layers(self, h: torch.Tensor, lo: int, hi: int,
                   seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder.run_layers(h, lo, hi, seq_mask)

    def pool(self, h: torch.Tensor,
             seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder LayerNorm, then the cls token (or the masked mean of the
        patch tokens with ``global_pool``), then the output LayerNorm."""
        if self.norm is None:
            raise RuntimeError("LongNetViT was built without its pool head")
        h = self.encoder.finalize(h)
        if self.cfg.global_pool:
            tokens = h[:, 1:]
            if seq_mask is not None:
                m = seq_mask[:, 1:, None].to(h.dtype)
                pooled = (tokens * m).sum(1) / m.sum(1).clamp_min(1.0)
            else:
                pooled = tokens.mean(1)
            return self.norm(pooled)
        return self.norm(h)[:, 0]

    def forward(self, x: torch.Tensor, coords: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, seq_mask = self.embed(x, coords, mask)
        h = self.run_layers(h, 0, len(self.encoder.layers), seq_mask)
        return self.pool(h, seq_mask)
