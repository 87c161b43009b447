"""LongNet dilated attention as plain PyTorch: the oracle of the kernels in
``csrc/dilated_attention_fwd.cu`` and ``csrc/dilated_attention_bwd.cu``.

Counterpart of ``modaltune_tpu/ops/dilated.py`` ("diagonal" layout). Per
(segment length ``w``, dilation ratio ``r``) branch:

1. the sequence is cut into ``sl = min(w, L)``-token segments, the last
   one padded;
2. inside a segment, head group ``g`` (heads ``g*hg .. (g+1)*hg - 1`` once
   the heads are padded to a multiple of ``r``) attends the positions
   ``≡ g (mod r)`` — the head-rotated gather of :func:`dense_to_sparse`;
3. each branch runs :func:`flash_attention_reference` (or, with
   ``kernel=True``, :func:`flash_attention`: K2f and K2b on CUDA tensors,
   the JAX package's per-branch route with ``fused_attention=False``) and
   returns
   ``(out, lse)``, scattered back to dense layout by
   :func:`sparse_to_dense` (off-pattern slots get lse ``NEG_INF``);
4. the branches are mixed per token and head with fp32 ``softmax(lse)``
   weights, which carry no gradient.

With ``q_token_range=(p0, p1)`` the result is the full one with every row
outside ``[p0, p1)`` zeroed, so autograd gives dq zero there and only the
range's queries' share of dk/dv: the oracle of K1's range variant, the
sequence-parallel shard's work (:mod:`.dilated_sp`).

Padded positions, both past ``L`` and past the segment length inside the
sparse layout, are always masked out of the softmax. (The JAX oracle
attends zero-valued padding slots when ``mask`` is None and ``sl % r != 0``;
with a mask, and on every shape its mega kernel accepts, the two agree.)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import (MASK_THRESHOLD, NEG_INF, flash_attention,
                              flash_attention_reference)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dense_to_sparse(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Head-rotated dilation gather.

    x: ``(B, S, H, ...)`` segments. Returns ``(B, ceil(S/r), H, ...)``
    where the entry for head ``g*hg + j`` at sparse position ``l`` is the
    dense entry at position ``l*r + g`` (``hg = round_up(H, r) / r``).
    Positions past ``S`` are zero.
    """
    if ratio == 1:
        return x
    b, s, h = x.shape[:3]
    trailing = tuple(x.shape[3:])
    sp, hp = _round_up(s, ratio), _round_up(h, ratio)
    if sp != s or hp != h:
        pad = [0, 0] * len(trailing) + [0, hp - h, 0, sp - s]
        x = F.pad(x, pad)
    hg = hp // ratio
    # (B, S/r, r1, r2, hg, ...) with position = l*r + r1, head = r2*hg + j
    x = x.reshape((b, sp // ratio, ratio, ratio, hg) + trailing)
    x = torch.diagonal(x, dim1=2, dim2=3)        # (B, S/r, hg, ..., r)
    x = torch.movedim(x, -1, 2)                  # (B, S/r, r, hg, ...)
    x = x.reshape((b, sp // ratio, hp) + trailing)
    return x[:, :, :h]


def sparse_to_dense(out: torch.Tensor, lse: torch.Tensor, ratio: int,
                    seg_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`dense_to_sparse` for a branch's ``(out, lse)``.

    out: ``(B, S/r, H, D)``; lse: ``(B, S/r, H)``. Returns dense
    ``out (B, seg_len, H, D)`` and ``lse (B, seg_len, H)``; (position,
    head) slots outside the dilation pattern get 0 and ``NEG_INF``.
    """
    if ratio == 1:
        return out[:, :seg_len], lse[:, :seg_len]
    b, ls, h, d = out.shape
    hp = _round_up(h, ratio)
    if hp != h:
        out = F.pad(out, (0, 0, 0, hp - h))
        lse = F.pad(lse, (0, hp - h), value=NEG_INF)
    hg = hp // ratio
    # dense[:, l, r1, r2] holds sparse[:, l, r2] where r1 == r2: write the
    # diagonal of a (B, S/r, r1, r2, hg, ...) block
    dense_out = out.new_zeros(b, ls, ratio, ratio, hg, d)
    dense_lse = lse.new_full((b, ls, ratio, ratio, hg), NEG_INF)
    dense_out.diagonal(dim1=2, dim2=3).copy_(
        out.reshape(b, ls, ratio, hg, d).movedim(2, -1))
    dense_lse.diagonal(dim1=2, dim2=3).copy_(
        lse.reshape(b, ls, ratio, hg).movedim(2, -1))
    dense_out = dense_out.reshape(b, ls * ratio, hp, d)
    dense_lse = dense_lse.reshape(b, ls * ratio, hp)
    return dense_out[:, :seg_len, :h], dense_lse[:, :seg_len, :h]


def _branch(q, k, v, mask, seg_len: int, ratio: int, scale: float,
            attention):
    """One (segment_length, dilation_ratio) branch, its attention computed
    by ``attention`` (:func:`flash_attention_reference` or
    :func:`flash_attention`).

    q/k/v: ``(B, L, H, D)``; mask: ``(B, L)`` bool. Returns dense fp32
    ``out (B, L, H, D)`` and ``lse (B, L, H)``.
    """
    b, length, h, d = q.shape
    sl = min(seg_len, length)
    lp = _round_up(length, sl)
    n = lp // sl

    def seg(x):
        if lp != length:
            pad = [0, 0] * (x.dim() - 2) + [0, lp - length]
            x = F.pad(x, pad)
        return x.reshape((b * n, sl) + tuple(x.shape[2:]))

    qs = dense_to_sparse(seg(q), ratio)          # (B*n, S, H, D)
    ks = dense_to_sparse(seg(k), ratio)
    vs = dense_to_sparse(seg(v), ratio)
    ms = dense_to_sparse(seg(mask[..., None].expand(b, length, h)), ratio)

    bn, s = qs.shape[0], qs.shape[1]
    # (B*n*H, S, D) layout for the attention
    qk = qs.movedim(2, 1).reshape(bn * h, s, d).contiguous()
    kk = ks.movedim(2, 1).reshape(bn * h, s, d).contiguous()
    vk = vs.movedim(2, 1).reshape(bn * h, s, d).contiguous()
    bias = torch.where(ms.movedim(2, 1).reshape(bn * h, s), 0.0, NEG_INF)
    out, lse = attention(qk, kk, vk, bias.contiguous(), scale)

    out = out.reshape(bn, h, s, d).movedim(1, 2)  # (B*n, S, H, D)
    lse = lse.reshape(bn, h, s).movedim(1, 2)     # (B*n, S, H)
    out, lse = sparse_to_dense(out.float(), lse, ratio, sl)
    out = out.reshape(b, lp, h, d)[:, :length]
    lse = lse.reshape(b, lp, h)[:, :length]
    return out, lse


def _branches(q, k, v, mask, segment_lengths, dilated_ratios, scale,
              kernel=False):
    """Every branch's dense ``(out, lse)``; see :func:`_branch`."""
    attention = flash_attention if kernel else flash_attention_reference
    if len(segment_lengths) != len(dilated_ratios):
        raise ValueError("one dilation ratio per segment length")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    return zip(*(_branch(q, k, v, mask.bool(), int(sl), int(r), float(scale),
                         attention)
                 for sl, r in zip(segment_lengths, dilated_ratios)))


def check_q_token_range(q_token_range: Tuple[int, int],
                        dilated_ratios: Sequence[int],
                        length: int) -> Tuple[int, int]:
    """``(p0, p1)`` as ints, or ``ValueError``: the bounds must be
    multiples of R = max ratio (the JAX package's rule and text) and
    ``0 <= p0 < p1 <= length``."""
    r_max = max(int(r) for r in dilated_ratios)
    p0, p1 = q_token_range
    if p0 % r_max or p1 % r_max:
        raise ValueError(f"q_token_range {q_token_range} must be multiples "
                         f"of R={r_max}")
    if not 0 <= p0 < p1 <= length:
        raise ValueError(f"q_token_range {q_token_range} must lie in "
                         f"[0, {length}] and not be empty")
    return int(p0), int(p1)


def keep_query_rows(out: torch.Tensor,
                    q_token_range: Optional[Tuple[int, int]]) -> torch.Tensor:
    """``out (B, L, ...)`` with the rows outside ``q_token_range`` zeroed
    (``out`` itself when there is no range)."""
    if q_token_range is None:
        return out
    p0, p1 = q_token_range
    pos = torch.arange(out.shape[1], device=out.device)
    keep = ((pos >= p0) & (pos < p1)).to(out.dtype)
    return out * keep.view((1, -1) + (1,) * (out.dim() - 2))


def dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      segment_lengths: Sequence[int],
                      dilated_ratios: Sequence[int],
                      mask: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None,
                      kernel: bool = False,
                      q_token_range: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Multi-branch LongNet dilated attention, plain PyTorch.

    q/k/v: ``(B, L, H, D)`` (after the projections); mask: ``(B, L)`` bool
    token validity, None meaning all valid. Returns ``(B, L, H, D)`` in
    q's dtype: the branches' outputs mixed per (token, head) with fp32
    ``softmax(lse)`` weights. The weights carry no gradient (the JAX
    package's ``stop_gradient``, which the K1 backward assumes).
    ``kernel=True`` runs each branch's attention through
    :func:`flash_attention` (the K2 kernels on CUDA tensors).
    ``q_token_range=(p0, p1)`` zeroes the rows outside ``[p0, p1)`` (see
    the module docstring; the bounds as :func:`check_q_token_range` asks).
    """
    if q_token_range is not None:
        q_token_range = check_q_token_range(q_token_range, dilated_ratios,
                                            q.shape[1])
    outs, lses = _branches(q, k, v, mask, segment_lengths, dilated_ratios,
                           scale, kernel)
    if len(outs) == 1:
        return keep_query_rows(outs[0], q_token_range).to(q.dtype)
    w = torch.softmax(torch.stack(lses).detach(), dim=0)  # (n_br, B, L, H)
    out = sum(o * wi[..., None] for o, wi in zip(outs, w))
    return keep_query_rows(out, q_token_range).to(q.dtype)


def dilated_attention_stats(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            segment_lengths: Sequence[int],
                            dilated_ratios: Sequence[int],
                            mask: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The statistics the K1 forward saves for its backward, plain PyTorch.

    Returns fp32 ``(B*H, n_br + 2, L)``: rows ``0..n_br-1`` each branch's
    lse (``NEG_INF`` where a token takes no part in the branch or sees no
    valid key), row ``n_br`` ``m = max_b lse_b``, row ``n_br + 1``
    ``Z = sum_b exp(lse_b - m)`` over the branches with a valid lse (0
    when there is none). The layout of the JAX package's stats plane.
    """
    with torch.no_grad():
        _, lses = _branches(q, k, v, mask, segment_lengths, dilated_ratios,
                            scale)
        lse = torch.stack(lses)                   # (n_br, B, L, H)
        m = lse.amax(dim=0)
        z = torch.where(lse > MASK_THRESHOLD, torch.exp(lse - m), 0.0).sum(0)
        stats = torch.cat([lse, m[None], z[None]])  # (n_br + 2, B, L, H)
        b, length, h = m.shape
        return stats.permute(1, 3, 0, 2).reshape(b * h, -1, length) \
            .contiguous()
