"""ModalTune-GigaPath in plain PyTorch: the reference of the
``gigapath_modaltune`` configuration.

The Prov-GigaPath LongNetViT slide encoder (tile features -> linear patch
embedding + 2-D sin-cos position of the tile's grid cell, a cls token,
pre-norm sub-LN LongNet layers whose self-attention mixes five dilated
branches by their log-sum-exp) under the Modal Adapter of
``common.AdapterModel``. Each dilated branch (segment length w, ratio r)
cuts the sequence into segments of min(w, L) tokens; in a segment, the
heads of group g (H / r heads each) attend the positions = g (mod r). The
branches are mixed per token and head with softmax weights of their
log-sum-exps, which carry no gradient (LongNet's stop-gradient). Padded
tiles are masked out of every attention and zeroed after every layer.
For the control (``Runtime("fp8")``) the residual stream and the GELU's
output are rounded too, where the program under bf16 autocast holds them
in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (NEG_INF, AdapterModel, Dropout, DropPath, LayerNorm,
                     Linear, Runtime, attention, gelu, remat)


def _sincos(pos, dim):
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 2, dtype=torch.float32,
                                           device=pos.device) / (dim / 2.0))
    out = pos[..., None].float() * omega
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def position(coords, dim, tile):
    cell = torch.floor(coords.float() / tile)
    return torch.cat([_sincos(cell[..., 1], dim // 2),
                      _sincos(cell[..., 0], dim // 2)], dim=-1)


def dilated_branch(rt, q, k, v, mask, w: int, r: int, scale: float):
    """One branch: dense fp32 out (B, L, H, D) and lse (B, L, H), 0 and
    NEG_INF where a (position, head) takes no part in it."""
    b, length, h, d = q.shape
    sl = min(w, length)
    n = -(-length // sl)
    s = -(-sl // r)
    hg = -(-h // r)
    hp = hg * r

    def grouped(x):
        # (B, L, H, ...) -> (B * n * r * hg, s, ...): segment, residue g,
        # head of group g, position l*r + g of the segment
        tail = tuple(x.shape[3:])
        x = F.pad(x, (0, 0) * len(tail) + (0, hp - h, 0, n * sl - length))
        x = x.reshape((b, n, sl, hp) + tail)
        x = F.pad(x, (0, 0) * len(tail) + (0, 0, 0, s * r - sl))
        x = x.reshape((b, n, s, r, r, hg) + tail)
        x = torch.stack([x[:, :, :, g, g] for g in range(r)], dim=2)
        x = x.movedim(4, 3)                       # (B, n, r, hg, s, ...)
        return x.reshape((b * n * r * hg, s) + tail)

    valid = grouped(mask[..., None].expand(b, length, h))
    bias = torch.where(valid, 0.0, NEG_INF).float()
    out, lse = attention(rt, grouped(q), grouped(k), grouped(v),
                         lambda bs, qs: bias[bs][:, None, :], scale)
    out = out.reshape(b, n, r, hg, s, d).permute(0, 1, 4, 2, 3, 5)
    lse = lse.reshape(b, n, r, hg, s).permute(0, 1, 4, 2, 3)

    def dense(x, fill):
        # (B, n, s, r, hg, ...) -> (B, L, H, ...): group g's heads at the
        # positions of residue g, ``fill`` elsewhere
        rows = []
        for g in range(r):
            parts = []
            for c in range(r):
                part = x[:, :, :, g]
                parts.append(part if c == g else torch.full_like(part, fill))
            rows.append(torch.cat(parts, dim=3))   # (B, n, s, hp, ...)
        x = torch.stack(rows, dim=3)               # (B, n, s, r, hp, ...)
        x = x.reshape((b, n, s * r, hp) + tuple(x.shape[5:]))[:, :, :sl]
        x = x.reshape((b, n * sl, hp) + tuple(x.shape[4:]))
        return x[:, :length, :h]

    return dense(out, 0.0), dense(lse.detach(), NEG_INF)


def dilated_attention(rt, q, k, v, mask, segments, ratios):
    scale = q.shape[-1] ** -0.5
    outs, lses = zip(*(dilated_branch(rt, q, k, v, mask, w, r, scale)
                       for w, r in zip(segments, ratios)))
    wts = torch.softmax(torch.stack(lses), dim=0)
    return sum(o * wt[..., None] for o, wt in zip(outs, wts))


class DilatedSelfAttention(nn.Module):
    def __init__(self, rt, c):
        super().__init__()
        d = c["embed_dim"]
        self.rt, self.c = rt, c
        self.q_proj, self.k_proj = Linear(rt, d, d), Linear(rt, d, d)
        self.v_proj, self.out_proj = Linear(rt, d, d), Linear(rt, d, d)
        self.inner_attn_ln = LayerNorm(d, c["layernorm_eps"])

    def forward(self, x, mask):
        b, length, d = x.shape
        h = self.c["num_heads"]
        q, k, v = (p(x).view(b, length, h, d // h)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = dilated_attention(self.rt, q, k, v, mask,
                                self.c["segment_lengths"],
                                self.c["dilated_ratios"])
        return self.out_proj(self.inner_attn_ln(out.reshape(b, length, d)))


class FeedForwardNetwork(nn.Module):
    def __init__(self, rt, c):
        super().__init__()
        self.rt = rt
        self.fc1 = Linear(rt, c["embed_dim"], c["ffn_dim"])
        self.fc2 = Linear(rt, c["ffn_dim"], c["embed_dim"])
        self.ffn_layernorm = LayerNorm(c["ffn_dim"], c["layernorm_eps"])
        self.dropout = Dropout(rt, c["dropout"])

    def forward(self, x):
        h = self.rt.rnd(gelu(self.fc1(x)))
        return self.dropout(self.fc2(self.ffn_layernorm(h)))


class EncoderLayer(nn.Module):
    def __init__(self, rt, c, drop_path):
        super().__init__()
        d = c["embed_dim"]
        self.rt = rt
        self.self_attn_layer_norm = LayerNorm(d, c["layernorm_eps"])
        self.self_attn = DilatedSelfAttention(rt, c)
        self.dropout = Dropout(rt, c["dropout"])
        self.final_layer_norm = LayerNorm(d, c["layernorm_eps"])
        self.ffn = FeedForwardNetwork(rt, c)
        self.drop_path = DropPath(rt, drop_path)

    def forward(self, x, mask):
        r = self.rt.rnd
        a = self.self_attn(self.self_attn_layer_norm(x), mask)
        x = r(x + self.drop_path(self.dropout(a)))
        x = r(x + self.drop_path(self.ffn(self.final_layer_norm(x))))
        return x * mask[..., None].float()


class Encoder(nn.Module):
    def __init__(self, rt, c):
        super().__init__()
        n = c["num_layers"]
        rates = [c["drop_path_rate"] * i / (n - 1) for i in range(n)] \
            if c["drop_path_rate"] > 0 and n > 1 else [0.0] * n
        self.rt = rt
        self.embed_dropout = Dropout(rt, c["dropout"])
        self.layers = nn.ModuleList(EncoderLayer(rt, c, rates[i])
                                    for i in range(n))


class PatchEmbed(nn.Module):
    def __init__(self, rt, n_in, d):
        super().__init__()
        self.proj = Linear(rt, n_in, d)


class Backbone(nn.Module):
    """``b``: the slide encoder's sizes; ``c``: its LongNet encoder's."""

    def __init__(self, rt, b, c):
        super().__init__()
        self.b = b
        self.patch_embed = PatchEmbed(rt, b["in_chans"], b["embed_dim"])
        self.cls_token = nn.Parameter(torch.empty(1, 1, b["embed_dim"]))
        self.encoder = Encoder(rt, c)


class Model(AdapterModel):
    """``forward(bag, coords, genes, task_token, mask) -> (rows, out)``."""

    def __init__(self, rt: Runtime, cfg: dict, n_groups: int,
                 max_group_len: int):
        super().__init__(rt, cfg, n_groups, max_group_len)
        self.backbone = Backbone(rt, cfg["model"]["backbone"], cfg["longnet"])

    def forward(self, bag, coords, genes, task_token, mask):
        bb, rt = self.backbone, self.rt
        d = bb.b["embed_dim"]
        h = rt.rnd(bb.patch_embed.proj(bag.float())
                   + position(coords, d, bb.b["tile_size"]))
        h = torch.cat([bb.cls_token.float().expand(h.shape[0], 1, d), h], 1)
        seq_mask = torch.cat([mask.new_ones((mask.shape[0], 1)), mask], 1)
        h = bb.encoder.embed_dropout(h) * seq_mask[..., None].float()
        modal = self.modal_tokens(genes.float(), task_token)

        def run_layers(t, lo, hi):
            for layer in bb.encoder.layers[lo:hi]:
                t = remat(rt, layer, t, seq_mask)
            return t

        cls, _, modal = self.interact(h, modal, run_layers, mask)
        return self.fuse(cls, modal)
