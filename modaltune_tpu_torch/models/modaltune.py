"""ModalTune: the frozen LongNetViT backbone plus the trainable Modal Adapter.

Counterpart of ``modaltune_tpu/models/modaltune.py::ModalTuneModel`` (both
``longnetvit_gene_adapter`` and the clinical variant, which is
``AdapterConfig.clinfeat_dim > 0``):

  patch embed + sin-cos position + cls -> encoder prepare ->
  modal tokens [clinical][task][gene cls][gene tokens] ->
  (pre-interaction frozen span) ->
  per interaction { prompt self-attention (from the 2nd on) -> inject ->
  frozen span -> extract } ->
  fuse (cls or masked-mean image, task, gene, clinical) -> LN -> project.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..configs import LongNetConfig, ModalTuneConfig
from .adapter import InteractionBlock
from .gene import GeneMixerEncoder
from .layers import Dense, SelfAttentionLayer, fill_normal_
from .slide_encoder import LongNetViT


class ModalTuneModel(nn.Module):
    """``longnet`` and ``fused_gelu_ln`` pick the LongNet backbone's kernel
    route (:class:`.slide_encoder.LongNetViT`): ``longnet=
    cfg.backbone.longnet(mega_attention=False)`` runs the per-branch
    attention kernels, ``fused_gelu_ln=True`` the fused GELU -> LayerNorm."""

    def __init__(self, cfg: ModalTuneConfig, n_gene_groups: int,
                 max_group_len: int, longnet: Optional[LongNetConfig] = None,
                 fused_gelu_ln: Optional[bool] = None):
        super().__init__()
        a, b = cfg.adapter, cfg.backbone
        d = b.embed_dim
        self.cfg = cfg
        if (longnet is not None or fused_gelu_ln is not None) and \
                type(self).build_backbone is not ModalTuneModel.build_backbone:
            raise ValueError(f"{type(self).__name__} has no LongNet backbone "
                             f"to route")
        self._longnet_route = dict(longnet=longnet,
                                   fused_gelu_ln=fused_gelu_ln)
        self.backbone = self.build_backbone(b)

        gene_cfg = cfg.gene
        if gene_cfg.output_dim != d:
            gene_cfg = dataclasses.replace(gene_cfg, output_dim=d)
        self.gene_encoder = GeneMixerEncoder(gene_cfg, n_gene_groups,
                                             max_group_len)

        n_int = len(a.interaction_indexes)
        self.interactions = nn.ModuleList(
            InteractionBlock(
                dim=d, num_heads=a.num_heads, init_values=a.init_values,
                drop_path=a.drop_path_rate, with_cffn=a.with_cffn,
                cffn_ratio=a.cffn_ratio,
                extra_extractor=(i == n_int - 1) and a.use_extra_extractor)
            for i in range(n_int))
        # interaction i >= 1 starts with a prompt self-attention, held at
        # prompt_sa[i - 1]; interaction 0 has none
        self.prompt_sa = nn.ModuleList(
            SelfAttentionLayer(d, a.num_heads, with_cffn=a.with_cffn,
                               cffn_ratio=a.cffn_ratio,
                               dropout=a.prompt_dropout)
            for _ in range(1, n_int if a.use_prompt_sa else 1))

        n_modal = gene_cfg.final_groups
        self.gene_cls = None
        if a.prompt_agg == "cls":
            self.gene_cls = nn.Parameter(torch.empty(1, 1, d))
            n_modal += 1
        if a.is_multi:
            self.task_dense = Dense(a.multi_task, d, "normal02")
            self.task_norm = nn.LayerNorm(d, eps=1e-5)
            n_modal += 1
        if a.with_clinical:
            self.clinical_fc1 = Dense(a.clinfeat_dim, d // 2, "normal02")
            self.clinical_fc2 = Dense(d // 2, d, "normal02")
            self.clinical_norm = nn.LayerNorm(d, eps=1e-5)
            n_modal += 1
        self.n_modal = n_modal
        self.gene_pe = nn.Parameter(torch.empty(n_modal, d))

        if a.token_agg == "sum":
            n_cat = 1
        elif a.token_agg == "cat":
            n_cat = 2 + int(a.is_multi) + int(a.with_clinical)
        else:
            raise ValueError(f"unknown token_agg {a.token_agg!r}")
        if a.prompt_agg not in ("avg", "cls"):
            raise ValueError(f"unknown prompt_agg {a.prompt_agg!r}")
        self.final_norm = nn.LayerNorm(d * n_cat, eps=1e-5)
        self.final_project = Dense(d * n_cat, a.output_dim, "normal02")

    def build_backbone(self, cfg) -> nn.Module:
        """The frozen slide encoder (``self.backbone``) for ``cfg.backbone``."""
        return LongNetViT(cfg, pool_head=False, **self._longnet_route)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fill_normal_(self.gene_pe, 0.02, g)
        if self.gene_cls is not None:
            fill_normal_(self.gene_cls, 0.02, g)

    def compute_dtype(self, device: torch.device) -> torch.dtype:
        """The dtype every input is cast to: autocast's dtype on
        ``device`` while autocast is on (bf16 compute over fp32 trainable
        and bf16 frozen parameters, as the JAX package trains), else the
        parameters' dtype."""
        if torch.is_autocast_enabled(device.type):
            return torch.get_autocast_dtype(device.type)
        return self.gene_pe.dtype

    def modal_tokens(self, genes: torch.Tensor,
                     task_token: Optional[torch.Tensor],
                     clinical: Optional[torch.Tensor],
                     dt: torch.dtype) -> torch.Tensor:
        """-> (B, n_modal, D): [clinical][task][gene cls][gene tokens]."""
        a = self.cfg.adapter
        modal = self.gene_encoder(genes.to(dt))               # (B, G', D)
        bsz, d = modal.shape[0], modal.shape[-1]
        if self.gene_cls is not None:
            modal = torch.cat([self.gene_cls.expand(bsz, 1, d), modal], dim=1)
        if a.is_multi:
            if task_token is None:
                raise ValueError("a multi-task model needs task_token")
            t = self.task_norm(self.task_dense(task_token.to(dt)))[:, None]
            modal = torch.cat([t, modal], dim=1)
        if a.with_clinical:
            if clinical is None:
                raise ValueError("a clinical model needs clinical features")
            ce = torch.relu(self.clinical_fc1(clinical.to(dt)))
            ce = self.clinical_norm(self.clinical_fc2(ce))[:, None]
            modal = torch.cat([ce, modal], dim=1)
        return modal

    def fuse(self, img: torch.Tensor, modal: torch.Tensor) -> torch.Tensor:
        """Image outcome ``img`` (B, 1, D) and the modal tokens after the
        last interaction -> (B, output_dim): sum or concatenation of the
        image, task, gene and clinical tokens, LayerNorm, projection."""
        a = self.cfg.adapter
        off = 0
        clin_out = task_out = None
        if a.with_clinical:
            clin_out = modal[:, off:off + 1]
            off += 1
        if a.is_multi:
            task_out = modal[:, off:off + 1]
            off += 1
        if a.prompt_agg == "cls":
            gene_out = modal[:, off:off + 1]
        else:
            gene_out = modal[:, off:].mean(dim=1, keepdim=True)

        if a.token_agg == "sum":
            outcome = img + gene_out
            if task_out is not None:
                outcome = outcome + task_out
            if clin_out is not None:
                outcome = outcome + clin_out
        else:
            parts = [img] + ([task_out] if task_out is not None else []) \
                + [gene_out] + ([clin_out] if clin_out is not None else [])
            outcome = torch.cat(parts, dim=-1)
        outcome = self.final_project(self.final_norm(outcome))
        return outcome[:, 0]

    def interact(self, h: torch.Tensor, modal: torch.Tensor, run_layers,
                 x_mask: Optional[torch.Tensor]):
        """The adapter's loop over the frozen backbone. ``h`` (B, 1 + L, D)
        is the embedded sequence, cls token first; ``run_layers(t, lo,
        hi)`` runs the backbone's layers lo..hi-1 on it; ``x_mask`` (B, L)
        marks the valid tokens. Returns (cls, x, modal) after the last
        interaction."""
        idx = self.cfg.adapter.interaction_indexes
        if idx[0][0] != 0:
            h = run_layers(h, 0, idx[0][0])
        cls, x = h[:, :1], h[:, 1:]
        for i, block in enumerate(self.interactions):
            lo, hi = idx[i]
            if 1 <= i <= len(self.prompt_sa):
                modal = self.prompt_sa[i - 1](modal, query_pos=self.gene_pe)

            def run_span(t, lo=lo, hi=hi):
                return run_layers(t, lo, hi + 1)

            x, modal, cls = block(x, modal, cls, run_span,
                                  query_pos=self.gene_pe, x_mask=x_mask)
        return cls, x, modal

    def forward(self, bag: torch.Tensor, coords: torch.Tensor,
                genes: torch.Tensor, task_token: Optional[torch.Tensor] = None,
                clinical: Optional[torch.Tensor] = None,
                bag_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bag (B, L, in_chans) padded tile features; coords (B, L, 2);
        genes (B, n_groups, max_group_len); task_token (B, n_tasks) one-hot;
        clinical (B, clinfeat_dim); bag_mask (B, L) bool validity.
        Returns (B, output_dim) task-conditioned embeddings."""
        dt = self.compute_dtype(bag.device)
        h, seq_mask = self.backbone.embed(bag.to(dt), coords, bag_mask)
        modal = self.modal_tokens(genes, task_token, clinical, dt)
        x_mask = None if seq_mask is None else seq_mask[:, 1:]
        cls, x, modal = self.interact(
            h, modal,
            lambda t, lo, hi: self.backbone.run_layers(t, lo, hi, seq_mask),
            x_mask)

        if self.cfg.backbone.global_pool:
            if x_mask is not None:
                m = x_mask[..., None].to(x.dtype)
                img = ((x * m).sum(1) / m.sum(1).clamp_min(1.0))[:, None]
            else:
                img = x.mean(dim=1, keepdim=True)
        else:
            img = cls
        return self.fuse(img, modal)
