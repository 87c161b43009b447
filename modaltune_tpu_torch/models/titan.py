"""TITAN backbone and the ModalTune-TITAN adapter.

Counterpart of ``modaltune_tpu/models/titan.py``. The data layer scatters a
slide's patch features onto a 2-D grid (:func:`grid_scatter_bag`) and pads
the foreground cells to a bucket; the ViT embeds the cells, prepends a cls
token, and runs pre-norm blocks whose attention carries a 2-D ALiBi bias
from the grid coordinates. Background and padding cells are removed by the
attention key mask. The bias is computed inside the attention op
(:func:`..ops.alibi_flash.alibi_flash_attention`: the K4 kernels on CUDA,
the plain version on the CPU), so the dense (H, N, N) tensor of
:func:`alibi_bias` is on no path of the model. Parameter names follow the
original torch checkpoint (``blocks.N.attn.qkv``, ``blocks.N.mlp.fc1``,
``patch_embed.fc1``, ``attn_pool.*``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import TitanConfig, TitanModalTuneConfig
from ..ops.activations import gelu_exact
from ..ops.alibi_flash import alibi_flash_attention
from ..ops.flash_attention import NEG_INF
from .layers import Dense, DropPath, fill_normal_, mask_to_bias
from .modaltune import ModalTuneModel


# ---------------------------------------------------------------------------
# host-side grid scatter (data layer helper)
# ---------------------------------------------------------------------------


def grid_scatter_bag(features: np.ndarray, coords: np.ndarray,
                     patch_size_lv0: int = 1024,
                     bucket: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scatter a patch-feature bag onto a 2-D grid and flatten to a
    padded token list.

    Coords are offset to the grid origin, features falling in the same
    cell are summed, background = all-zero cells. Returns
    ``(tokens (N, D), grid_coords (N, 2) float, valid (N,) bool)`` where
    N = bucket (or the grid cell count if bucket is None) and only
    foreground cells are valid.
    """
    features = np.asarray(features, np.float32)
    coords = np.asarray(coords, np.float64)
    g = np.floor_divide(coords - coords.min(axis=0), patch_size_lv0)
    g = g - g.min(axis=0)
    h, w = (int(g[:, 0].max()) + 1, int(g[:, 1].max()) + 1)
    flat_idx = (g[:, 0] * w + g[:, 1]).astype(np.int64)
    grid = np.zeros((h * w, features.shape[1]), np.float32)
    np.add.at(grid, flat_idx, features)
    valid = np.any(grid != 0, axis=1)
    gy, gx = np.divmod(np.arange(h * w), w)
    gcoords = np.stack([gy, gx], axis=1).astype(np.float32)

    # keep only foreground cells first (so buckets truncate background
    # last), then pad to the bucket
    order = np.argsort(~valid, kind="stable")
    grid, gcoords, valid = grid[order], gcoords[order], valid[order]
    n = bucket if bucket is not None else grid.shape[0]
    if grid.shape[0] >= n:
        return grid[:n], gcoords[:n], valid[:n]
    pad = n - grid.shape[0]
    return (np.pad(grid, ((0, pad), (0, 0))),
            np.pad(gcoords, ((0, pad), (0, 0))),
            np.pad(valid, (0, pad)))


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Standard ALiBi head slopes 2^(-8i/n)."""
    return np.array([2.0 ** (-8.0 * (i + 1) / num_heads)
                     for i in range(num_heads)], np.float32)


def alibi_bias(grid_coords: torch.Tensor, num_heads: int,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense 2-D ALiBi: bias[h, i, j] = -slope_h * ||c_i - c_j||_2, with
    invalid keys masked to NEG_INF. grid_coords: (B, N, 2); returns
    (B, H, N+1, N+1) fp32 including a cls row/col with zero bias. The
    model never builds it; tests and timings of a library attention call
    do."""
    d = grid_coords[:, :, None, :] - grid_coords[:, None, :, :]
    dist = torch.sqrt((d.float() ** 2).sum(dim=-1))
    slopes = torch.from_numpy(alibi_slopes(num_heads)).to(dist.device)
    b, n = grid_coords.shape[:2]
    out = torch.zeros((b, num_heads, n + 1, n + 1), dtype=torch.float32,
                      device=dist.device)
    out[:, :, 1:, 1:] = -slopes[None, :, None, None] * dist[:, None]
    if valid is not None:
        keymask = torch.cat([valid.new_ones((b, 1)), valid], dim=1)
        out = torch.where(keymask[:, None, None, :], out, NEG_INF)
    return out


# ---------------------------------------------------------------------------
# ViT modules
# ---------------------------------------------------------------------------


class BiasedMHA(nn.Module):
    """timm-style fused-qkv self-attention with ALiBi.

    ``bias`` is an ``("alibi", coords3, slopes, key_mask)`` context: the
    bias is computed inside :func:`alibi_flash_attention` on either device.
    ``bias=None`` (a backbone without ALiBi) is a plain softmax."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"{dim} is not divisible by {num_heads}")
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)          # (B, H, N, dh)
        if bias is None:
            s = torch.matmul(q, k.transpose(-1, -2)).float() * dh ** -0.5
            out = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
        else:
            kind, coords3, slopes, key_mask = bias
            if kind != "alibi":
                raise ValueError(f"unknown attention bias {kind!r}")
            out = alibi_flash_attention(q, k, v, coords3, slopes,
                                        key_mask=key_mask)
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, out_dim or dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))


class TitanBlock(nn.Module):
    """Pre-norm ViT block: x += attn(norm1(x)); x += mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = BiasedMHA(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x), bias))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class AttentionalPooler(nn.Module):
    """CoCa-style attentional pooling: learned queries cross-attend over
    the token sequence. Returns (pooled_first_query, all_queries). The JAX
    package computes it outside any Pallas kernel, and so do plain torch
    products here."""

    def __init__(self, dim: int, num_queries: int = 128, num_heads: int = 12,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.dim, self.num_queries, self.num_heads = dim, num_queries, num_heads
        self.query = nn.Parameter(torch.empty(num_queries, dim))
        self.ln_k = nn.LayerNorm(dim, eps=norm_eps)
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim)
        self.v_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)
        self.ln_out = nn.LayerNorm(dim, eps=norm_eps)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fill_normal_(self.query, 0.02, g)

    def forward(self, tokens: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None):
        b, h = tokens.shape[0], self.num_heads
        dh = self.dim // h
        q = self.query.to(tokens.dtype).expand(b, self.num_queries, self.dim)
        tokens_n = self.ln_k(tokens)
        qh, kh, vh = (self.q_proj(q), self.k_proj(tokens_n),
                      self.v_proj(tokens_n))

        def split(t):
            return t.reshape(b, -1, h, dh).transpose(1, 2)

        s = torch.matmul(split(qh), split(kh).transpose(-1, -2)).float() \
            * dh ** -0.5
        if key_mask is not None:
            s = s + mask_to_bias(key_mask)[:, None, None, :]
        p = torch.softmax(s, dim=-1).to(vh.dtype)
        out = torch.matmul(p, split(vh)).transpose(1, 2) \
            .reshape(b, self.num_queries, self.dim)
        out = self.ln_out(self.out_proj(out))
        return out[:, 0], out


class TitanViT(nn.Module):
    """TITAN slide-encoder ViT over grid-scattered patch features, with the
    split API the adapter uses: :meth:`embed`, :meth:`run_blocks`,
    :meth:`pool`."""

    def __init__(self, cfg: TitanConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = Mlp(c.in_dim, c.mlp_patch_embed_dim, c.embed_dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.embed_dim))
        self.norm_pre = nn.LayerNorm(c.embed_dim, eps=c.norm_eps)
        self.blocks = nn.ModuleList(
            TitanBlock(c.embed_dim, c.num_heads, c.mlp_ratio, c.qkv_bias,
                       drop_path=c.drop_path_rate, norm_eps=c.norm_eps)
            for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=c.norm_eps)
        self.attn_pool = AttentionalPooler(
            c.embed_dim, c.attn_pooler_queries, c.attn_pooler_heads,
            norm_eps=c.norm_eps)
        # a plain attribute, not a buffer: casting the frozen backbone to
        # bf16 must not round the slopes
        self._slopes = torch.from_numpy(alibi_slopes(c.num_heads))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        fill_normal_(self.cls_token, 0.02, g)

    def embed(self, tokens: torch.Tensor, grid_coords: torch.Tensor,
              valid: torch.Tensor):
        """tokens: (B, N, in_dim) grid-cell features; grid_coords:
        (B, N, 2); valid: (B, N) bool. -> (x (B, N+1, D), bias, seq_mask):
        the cls token first, invalid tokens zeroed, ``bias`` the ALiBi
        context ``("alibi", coords3, slopes, seq_mask)`` with ``coords3``
        = [row, col, is_cls] (None without ALiBi)."""
        c = self.cfg
        h = self.patch_embed(tokens)
        b = h.shape[0]
        cls = self.cls_token.to(h.dtype).expand(b, 1, c.embed_dim)
        x = self.norm_pre(torch.cat([cls, h], dim=1))
        seq_mask = torch.cat([valid.new_ones((b, 1)), valid], dim=1)
        bias = None
        if c.pos_encode_type == "alibi":
            gc = grid_coords.to(torch.float32)
            coords3 = torch.cat([
                torch.cat([gc.new_zeros((b, 1, 2)), gc], dim=1),
                torch.cat([gc.new_ones((b, 1, 1)),
                           gc.new_zeros((b, gc.shape[1], 1))], dim=1)],
                dim=-1)
            if self._slopes.device != gc.device:
                self._slopes = self._slopes.to(gc.device)
            bias = ("alibi", coords3, self._slopes, seq_mask)
        x = x * seq_mask[..., None].to(x.dtype)
        return x, bias, seq_mask

    def run_blocks(self, x: torch.Tensor, lo: int, hi: int,
                   bias=None) -> torch.Tensor:
        for i in range(lo, hi):
            x = self.blocks[i](x, bias)
        return x

    def pool(self, x: torch.Tensor,
             seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pooled, _ = self.attn_pool(self.norm(x), key_mask=seq_mask)
        return pooled

    def forward(self, tokens: torch.Tensor, grid_coords: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        x, bias, seq_mask = self.embed(tokens, grid_coords, valid)
        x = self.run_blocks(x, 0, self.cfg.depth, bias)
        return self.pool(x, seq_mask)


class TitanModalTuneModel(ModalTuneModel):
    """ModalTune over the TITAN backbone (``titan_gene_adapter`` and the
    clinical variant). The same modal tokens and fusion as the GigaPath
    variant; it differs in the backbone, the ALiBi context threaded
    through the frozen spans, and the attention-pooled image outcome
    (with ``token_agg='cat'`` in the shipped config)."""

    cfg: TitanModalTuneConfig

    def build_backbone(self, cfg: TitanConfig) -> nn.Module:
        return TitanViT(cfg)

    def forward(self, bag: torch.Tensor, coords: torch.Tensor,
                genes: torch.Tensor, task_token: Optional[torch.Tensor] = None,
                clinical: Optional[torch.Tensor] = None,
                bag_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bag (B, N, in_dim) grid-cell features (see
        :func:`grid_scatter_bag`); coords (B, N, 2) *grid* coordinates;
        bag_mask (B, N) foreground validity. Returns (B, output_dim)."""
        dt = self.compute_dtype(bag.device)
        if bag_mask is None:
            bag_mask = torch.ones(bag.shape[:2], dtype=torch.bool,
                                  device=bag.device)
        h, bias, seq_mask = self.backbone.embed(bag.to(dt), coords, bag_mask)
        modal = self.modal_tokens(genes, task_token, clinical, dt)
        cls, x, modal = self.interact(
            h, modal,
            lambda t, lo, hi: self.backbone.run_blocks(t, lo, hi, bias),
            seq_mask[:, 1:])
        # image outcome: final norm + attention pool over cls + tokens
        img = self.backbone.pool(torch.cat([cls, x], dim=1), seq_mask)
        return self.fuse(img[:, None], modal)
