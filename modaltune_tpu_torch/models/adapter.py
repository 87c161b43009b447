"""Modal Adapter interaction blocks: Injector, Extractor, InteractionBlock.

Counterpart of ``modaltune_tpu/models/adapter.py``: inject the modal tokens
into the frozen image stream, run a span of frozen LongNet layers, extract
back into the modal tokens; the last block carries two extra extractors.
The double residual of the reference (the inner cross-attention already
returns ``tgt + attn``) is kept. The image validity mask is the
extractor's key mask.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..utils.tracing import span
from .layers import CrossAttentionLayer, DropPath, FFNLayer


class Injector(nn.Module):
    """image tokens += gamma * CrossAttn(q=image, kv=modal)."""

    def __init__(self, dim: int, num_heads: int, init_values: float = 0.0,
                 with_cffn: bool = True, cffn_ratio: float = 0.25):
        super().__init__()
        self.init_values = init_values
        self.attn = CrossAttentionLayer(dim, num_heads, with_cffn=with_cffn,
                                        cffn_ratio=cffn_ratio)
        self.gamma = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        self.gamma.fill_(self.init_values)

    def forward(self, query: torch.Tensor, feat: torch.Tensor,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("mt.adapter.injector"):
            attn = self.attn(query, feat, pos=pos, query_pos=None)
            return query + self.gamma.to(query.dtype) * attn


class Extractor(nn.Module):
    """modal tokens <- CrossAttn(q=modal (+pe), kv=image) + FFN."""

    def __init__(self, dim: int, num_heads: int, with_cffn: bool = True,
                 cffn_ratio: float = 0.25, drop_path: float = 0.0):
        super().__init__()
        self.attn = CrossAttentionLayer(dim, num_heads, with_cffn=with_cffn,
                                        cffn_ratio=cffn_ratio)
        self.ffn = FFNLayer(dim, int(dim * cffn_ratio)) if with_cffn else None
        self.drop_path = DropPath(drop_path)

    def forward(self, query: torch.Tensor, feat: torch.Tensor,
                pos: Optional[torch.Tensor] = None,
                feat_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("mt.adapter.extractor"):
            query = query + self.attn(query, feat, pos=None, query_pos=pos,
                                      memory_mask=feat_mask)
            if self.ffn is not None:
                query = query + self.drop_path(self.ffn(query))
            return query


class InteractionBlock(nn.Module):
    """Inject -> frozen LongNet span -> extract (+2 extra extractors on the
    last block). The span is run by the caller's ``run_span`` so that this
    module owns only adapter parameters."""

    def __init__(self, dim: int, num_heads: int, init_values: float = 0.0,
                 drop_path: float = 0.0, with_cffn: bool = True,
                 cffn_ratio: float = 0.25, extra_extractor: bool = False):
        super().__init__()
        self.injector = Injector(dim, num_heads, init_values, with_cffn,
                                 cffn_ratio)
        self.extractor = Extractor(dim, num_heads, with_cffn, cffn_ratio,
                                   drop_path=drop_path)
        self.extra_extractors = nn.ModuleList(
            Extractor(dim, num_heads, with_cffn, cffn_ratio,
                      drop_path=drop_path)
            for _ in range(2 if extra_extractor else 0))

    def forward(self, x: torch.Tensor, modal: torch.Tensor, cls: torch.Tensor,
                run_span: Callable[[torch.Tensor], torch.Tensor],
                query_pos: Optional[torch.Tensor] = None,
                x_mask: Optional[torch.Tensor] = None):
        """x: (B, L, D) patch tokens (no cls); modal: (B, M, D); cls:
        (B, 1, D); ``run_span`` runs the frozen layers on the cls-prefixed
        sequence. Returns ``(x, modal, cls)``."""
        x = self.injector(x, modal, pos=query_pos)
        h = run_span(torch.cat([cls, x], dim=1))
        cls, x = h[:, :1], h[:, 1:]
        modal = self.extractor(modal, x, pos=query_pos, feat_mask=x_mask)
        for extractor in self.extra_extractors:
            modal = extractor(modal, x, pos=query_pos, feat_mask=x_mask)
        return x, modal, cls
