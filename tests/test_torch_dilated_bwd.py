"""The tensor-core families of the dilated attention backward (K1b and K3b
at D = 48: bf16 on wgmma, fp32 on 3xTF32) emulated step by step on the CPU,
against the plain versions and JAX's Pallas kernels.

``csrc/dilated_bwd_wgmma.cu`` and ``csrc/dilated_bwd_tf32.cu`` cannot run
here. What they compute is written out below in the order the card
computes it (the fp32 core's differences after the list):

* a prep writes per compact row (``ops/dilated_fused.py``'s layout) the
  branch's lse and the demix weight ``w = exp(lse - m) / Z``: K1b's from
  K1f's saved ``stats`` (dense, read at each compact row's position),
  K3b's from K3f's compact ``lse_c`` and the mix statistics. No branch
  output enters: the forward keeps none, as the Pallas kernels keep none;
* the gradient core: a block owns one 64-row compact tile of one (batch,
  head, branch, segment) and streams the 64-row tiles of the same
  (segment, head group), rows past ``n_real`` zero-filled and masked; the
  dq kernel skips key tiles without a valid key, the dk/dv kernel writes
  zeros for an own tile without one; scores in base 2 (``exp2`` of
  ``s * scale * log2(e) + key term - lse * log2(e)``), bf16 operands with
  fp32 sums, P and dS entering ``dv += (P^T w) dmix``, ``dq += dS k`` and
  ``dk += dS^T q`` as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi);
* delta in the dq kernel, ``w * rowsum(P * dP)`` in fp32, each thread of
  a row's quad summing its 16 columns of every live key tile in order and
  the quad adding its four sums pairwise, in the one pass over the key
  tiles with a second accumulator ``B = sum P k`` and
  ``dq = scale (A - delta B)``, ``A = sum P w dP k``; the dk/dv kernel
  reads the dq kernel's delta;
* the combine: the branches' compact fp32 gradients summed in branch order
  per (token, head) and rounded once to the input dtype.

The compact gradients and delta start as NaN; the core writes every row,
zeros in the rows that are no real position.

The fp32 core (``"tf32x3"``) runs the same tiles, preps, delta and combine
on fp32 operands, every product as ``mma.sync`` m16n8k8 steps of 8 along
its inner dimension: each operand, P, P w dP and dS included, split into
hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna.tf32.f32``: nearest, ties
away from zero, 10 mantissa bits), and each step adding lo hi, hi lo and
hi hi to the fp32 accumulator in that order; dq's, dk's and dv's products
sum each half tile (32 keys or queries) into a fresh accumulator, added to
the running sum in fp32.
It is held to the plain version and to JAX's kernels at the fp32 limits
below; one TF32 product (``"tf32"``) is shown to miss them.

In fp32 the emulation is held against JAX's ``mega_dilated_attention`` and
``fused_dilated_attention`` (their backward Pallas kernels in interpret
mode, through ``jax.grad`` as ``tests/test_torch_train.py`` and
``tests/test_torch_fused.py`` run them), fed the stats plane of JAX's own
``_mega_fwd_call`` against JAX's VJP, and against autograd through the
port's plain ``dilated_attention``; in bf16 against the plain version at
``chip_smoke.py``'s limits. The family rule of ``ops/dilated_fused.py`` and
the compact-tile plan, the gather's rows and the tiles' liveness below are
pure functions and are tested as such. ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold the kernels themselves to the plain versions on the
card.
"""

import functools
import importlib.util
import math
from pathlib import Path
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from modaltune_tpu.ops.dilated_fused import (fused_dilated_attention
                                             as j_fused, fused_eligible)
from modaltune_tpu.ops.dilated_mega import (mega_dilated_attention as j_mega,
                                            mega_eligible)
from modaltune_tpu_torch.ops import dilated_fused as df
from modaltune_tpu_torch.ops.dilated import (dilated_attention,
                                             dilated_attention_stats)
from modaltune_tpu_torch.ops.flash_attention import MASK_THRESHOLD, NEG_INF

from _one_thread import one_thread  # noqa: F401  (one CPU thread a test)

LOG2E = 1.4426950408889634
TILE = 64       # compact rows of a tile

# fp32 against JAX: the Pallas kernels hold whole score rows, the emulation
# streams 64-row tiles and takes exp2 of base-2 scores: summation order.
JAX_TOL = 2e-4
# fp32 against autograd through the plain version, one framework.
PLAIN_TOL = 2e-5


def _load_chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()


# The roundings of the bf16 core (``"parts"``, the card's; ``"once"``) and
# of the fp32 core (``"tf32x3"``, the card's; ``"tf32"``, one TF32 product).
BF16 = ("parts", "once")
TF32 = ("tf32x3", "tf32")


def _round(x, rounding):
    """The bf16 operands: x rounded to bf16 under a bf16 rounding; fp32
    operands as they are (the TF32 roundings split them in the products)."""
    return x.bfloat16().float() if rounding in BF16 else x


def _operand(x, rounding):
    """P or dS as the products take them: two bf16 parts, hi = bf16(x) and
    lo = bf16(x - hi), under ``"parts"`` (the kernels); rounded once under
    ``"once"`` (the alternative the emulation measures); as is under None
    (fp32)."""
    if rounding is None:
        return x
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if rounding == "parts" else hi


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to nearest, ties away from zero, to
    10 mantissa bits (the low 13 bits of its fp32 encoding zero); inf and
    nan as they are."""
    bits = x.contiguous().numpy().view(np.uint32)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.where(torch.isfinite(x),
                       torch.from_numpy(rounded.view(np.float32).copy()), x)


def _tf32_parts(x):
    """x as the 3xTF32 core splits it: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(acc, a, b, rounding):
    """``acc + a @ b`` as the fp32 core's ``mma.sync`` m16n8k8 steps add it
    into its accumulator, step by step of 8 along the inner dimension:
    under ``"tf32x3"`` lo(a) hi(b), then hi(a) lo(b), then hi(a) hi(b)
    (the card's order); under ``"tf32"`` hi(a) hi(b) alone. The 8 products
    of a step are summed in fp32 (inside the tensor core on the card, in
    an order this does not model)."""
    k = a.shape[1]
    ah, al = _tf32_parts(a)
    bh, bl = _tf32_parts(b)

    def steps(x, y):   # (k / 8, M, N): each 8-deep step's product
        return torch.einsum("mkc,kcn->kmn", x.reshape(-1, k // 8, 8),
                            y.reshape(k // 8, 8, -1))
    terms = ([steps(al, bh), steps(ah, bl), steps(ah, bh)]
             if rounding == "tf32x3" else [steps(ah, bh)])
    for s in range(k // 8):
        for term in terms:
            acc = acc + term[s]
    return acc


def _scores(a, b, rounding):
    """A score tile ``a @ b.T`` (q k^T, dmix v^T and their transposes)."""
    if rounding in TF32:
        return _product(torch.zeros(a.shape[0], b.shape[0]), a, b.T,
                        rounding)
    return a @ b.T


def _accumulate(acc, x, b, rounding):
    """``acc + x @ b`` for a register tile x (P, P w dP, P^T w, dS^T); the
    fp32 core multiplies a tile in two halves of 32 keys (queries), each
    summed into a fresh accumulator that is added to ``acc`` in fp32 (its
    tensor cores add by truncation, so a long stream is not left in one of
    their accumulators)."""
    if rounding in TF32:
        for h in (slice(0, TILE // 2), slice(TILE // 2, TILE)):
            acc = acc + _product(torch.zeros_like(acc), x[:, h], b[h],
                                 rounding)
        return acc
    return acc + _operand(x, rounding) @ b


# ---------------------------------------------------------------------------
# The compact-tile plan of the core, as csrc/dilated_fused_common.cuh and
# csrc/dilated_bwd_wgmma.cu compute it
# ---------------------------------------------------------------------------

def tile_count(length: int, segment_lengths: Sequence[int],
               dilated_ratios: Sequence[int]) -> int:
    """Compact tiles of one head over every branch: each (segment, head
    group)'s ``m`` rows cut into ``TILE``-row tiles (the grid's x of the
    K3 kernels and the core, ``FusedBranches::tile0[n]``)."""
    return sum(nseg * -(-m // TILE) for _, nseg, m in
               df.branch_rows(length, segment_lengths, dilated_ratios))


def locate_tile(length: int, segment_lengths: Sequence[int],
                dilated_ratios: Sequence[int], tile: int, h: int,
                heads: int) -> dict:
    """Compact tile ``tile`` of head ``h``, as
    ``csrc/dilated_fused_common.cuh::locate_tile`` finds it: its branch and
    ratio ``r``; ``first``, the position of its (segment, head group)'s row
    0 (row ``l`` is ``first + r * l``); ``n_real`` real rows of the
    (segment, group); ``l0``, the tile's first row; ``n_rows`` rows of the
    tile, real or not; ``n_own`` real rows of the tile; ``seg_row``, the
    compact row of the group's row 0."""
    for bi, (off, nseg, m) in enumerate(df.branch_rows(length, segment_lengths,
                                                    dilated_ratios)):
        per_seg = -(-m // TILE)
        if tile < nseg * per_seg:
            break
        tile -= nseg * per_seg
    else:
        raise IndexError("tile out of range")
    sl, r = min(int(segment_lengths[bi]), length), int(dilated_ratios[bi])
    seg = tile // per_seg
    g = h // -(-heads // r)
    s0, s1 = seg * sl, min(seg * sl + sl, length)
    n_real = max(0, -(-(s1 - s0 - g) // r))
    l0 = (tile - seg * per_seg) * TILE
    return dict(branch=bi, r=r, first=s0 + g, n_real=n_real, l0=l0,
                n_rows=min(TILE, m - l0), n_own=max(0, min(TILE, n_real - l0)),
                seg_row=off + seg * m)


def tile_positions(ft: dict, t: int) -> Tuple[List[int], List[bool]]:
    """Rows ``t * TILE + i`` of the tile's (segment, group), as the gather
    of the tensor-core kernels loads them: each row's position and whether
    it is real; a row that is not is zero-filled and masked (its position
    may lie in the next segment or past L)."""
    rows = range(t * TILE, t * TILE + TILE)
    return ([ft["first"] + ft["r"] * i for i in rows],
            [i < ft["n_real"] for i in rows])


def live_tiles(valid: Sequence[bool], ft: dict) -> List[bool]:
    """Per tile of the tile's (segment, group), whether it holds a valid
    key: a real row at a valid position of ``valid``, the (L,) mask of one
    batch row. The dq kernel never loads a dead key tile; a dk/dv block
    whose own tile is dead writes zeros and leaves."""
    out = []
    for t in range(-(-ft["n_real"] // TILE)):
        pos, real = tile_positions(ft, t)
        out.append(any(re and bool(valid[p]) for p, re in zip(pos, real)))
    return out


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _compact_positions(length, heads, segs, ratios):
    """(real (H, M) bool, position (H, M) long) of every compact row."""
    reals, poss = zip(*(df.compact_rows(length, heads, int(w), int(r))
                        for w, r in zip(segs, ratios)))
    return torch.cat(reals, dim=1), torch.cat(poss, dim=1)


def emulate_prep_mega(stats, heads, segs, ratios):
    """K1b's prep: ``(lse_c, w_c)``, each (B, H, M) fp32, from K1f's
    ``stats (B*H, n + 2, L)``, read at each compact row's position; a row
    that is no real position gets lse NEG_INF and w 0."""
    bh, _, length = stats.shape
    n, h = len(segs), heads
    st = stats.reshape(bh // h, h, n + 2, length)
    m, z = st[:, :, n], st[:, :, n + 1]
    lse_c, w_c = [], []
    for bi, (w, r) in enumerate(zip(segs, ratios)):
        real, pos = df.compact_rows(length, h, int(w), int(r))
        take = functools.partial(torch.gather, dim=2,
                                 index=pos[None].expand(bh // h, h, -1))
        lse = take(st[:, :, bi])
        live = real[None] & (lse > MASK_THRESHOLD)
        lse_c.append(torch.where(real[None], lse, NEG_INF))
        w_c.append(torch.where(live, torch.exp(lse - take(m))
                               / torch.where(take(z) > 0, take(z), 1.0),
                               0.0))
    return tuple(torch.cat(x, dim=2) for x in (lse_c, w_c))


def emulate_prep_fused(lse_c, m, z, segs, ratios):
    """K3b's prep (``fused_bwd_prep_kernel``, the tensor-core family's
    variant): ``w_c (B, H, M)`` from K3f's compact ``lse_c`` and
    ``(m, Z) (B, H, L)``."""
    b, h, length = m.shape
    real, pos = _compact_positions(length, h, segs, ratios)
    idx = pos[None].expand(b, h, -1)
    mc, zc = torch.gather(m, 2, idx), torch.gather(z, 2, idx)
    live = real[None] & (lse_c > MASK_THRESHOLD)
    return torch.where(live, torch.exp(lse_c - mc)
                       / torch.where(zc > 0, zc, 1.0), 0.0)


def _gather_tile(x, b, h, ft, t, length):
    """Rows of other-side tile t of (B, L, H, D) ``x`` at head h, zero past
    the group's n_real (the card's zero-filled gather); and their
    positions and realness."""
    pos, real = tile_positions(ft, t)
    pos_t = torch.tensor([p if re else 0 for p, re in zip(pos, real)])
    real_t = torch.tensor(real)
    rows = x[b, pos_t.clamp_max(length - 1), h].float()
    return rows * real_t[:, None], pos_t, real_t


def _quad_rowsum(x):
    """Per row of a 64 x 64 fp32 tile, as a row's quad sums it: thread c
    takes columns 8 j + 2 c and + 1 for j = 0..7 in order -> (64, 4)."""
    x = x.reshape(TILE, 8, 4, 2)
    rs = torch.zeros(TILE, 4)
    for j in range(8):
        for e in range(2):
            rs = rs + x[:, j, :, e]
    return rs


def emulate_core(q, k, v, mask, dmix, lse_c, w_c, segs, ratios, scale,
                 rounding):
    """The dq and dk/dv kernels: compact fp32 ``(3, B, H, M, D)`` dq, dk,
    dv, zeros in the rows that are no real position, and the dq kernel's
    ``delta_c (B, H, M)``; a row no block writes would stay NaN.
    ``rounding``: None (fp32), ``"parts"`` (the bf16 core: bf16 operands, P
    and dS as hi + lo bf16 parts), ``"once"`` (P and dS rounded once to
    bf16), ``"tf32x3"`` (the fp32 core: every operand of every product, P
    and dS included, split into TF32 hi + lo parts, :func:`_product`) or
    ``"tf32"`` (one TF32 product). Returns the gradients, delta and the
    number of key tiles the dq kernel skipped."""
    b_, length, heads, d = q.shape
    valid = torch.ones(b_, length, dtype=torch.bool) if mask is None \
        else mask.bool()
    scale2 = scale * LOG2E
    grads = torch.full((3,) + tuple(lse_c.shape) + (d,), math.nan)
    delta_c = torch.full(tuple(lse_c.shape), math.nan)
    n_tiles = tile_count(length, segs, ratios)
    skipped = 0

    def lse2_of(lse):
        return torch.where(lse > MASK_THRESHOLD, lse * LOG2E, 1e30)

    def other_stats(b, h, ft, t):
        """lse2, w, delta of tile t of the block's group (past n_real:
        +huge, 0, 0)."""
        out = []
        for x, fill in zip((lse_c, w_c, delta_c), (math.inf, 0.0, 0.0)):
            rows = x[b, h, ft["seg_row"]:ft["seg_row"] + ft["n_real"]]
            y = torch.full((TILE,), fill)
            part = rows[t * TILE:(t + 1) * TILE]
            y[:part.shape[0]] = part
            out.append(y)
        out[0] = torch.where(torch.isinf(out[0]), 1e30, lse2_of(out[0]))
        return out

    def key_term(b, pos, real):
        return torch.where(real & valid[b, pos], 0.0, -math.inf)

    def blocks():
        for b in range(b_):
            for h in range(heads):
                for tile in range(n_tiles):
                    ft = locate_tile(length, segs, ratios, tile, h, heads)
                    rows = slice(ft["seg_row"] + ft["l0"],
                                 ft["seg_row"] + ft["l0"] + ft["n_rows"])
                    yield b, h, ft, rows

    # ---- the dq kernel: own rows are queries; delta, then dq ----
    for b, h, ft, rows in blocks():
        n_own, n_rows = ft["n_own"], ft["n_rows"]
        if n_own == 0:
            grads[0, b, h, rows] = 0.0
            delta_c[b, h, rows] = 0.0
            continue
        own_t = ft["l0"] // TILE
        live = live_tiles(valid[b], ft)
        q_o, _, _ = _gather_tile(q, b, h, ft, own_t, length)
        do_o, _, _ = _gather_tile(dmix, b, h, ft, own_t, length)
        q_o, do_o = _round(q_o, rounding), _round(do_o, rounding)
        lse2, w, _ = other_stats(b, h, ft, own_t)

        rs = torch.zeros(TILE, 4)
        acc, acc_b = torch.zeros(TILE, d), torch.zeros(TILE, d)
        for t in range(-(-ft["n_real"] // TILE)):   # the live key tiles
            if not live[t]:
                skipped += 1
                continue
            k_t, pos, real = _gather_tile(k, b, h, ft, t, length)
            v_t, _, _ = _gather_tile(v, b, h, ft, t, length)
            k_t, v_t = _round(k_t, rounding), _round(v_t, rounding)
            p = torch.exp2(_scores(q_o, k_t, rounding) * scale2 + (
                key_term(b, pos, real)[None, :] - lse2[:, None]))
            dp = _scores(do_o, v_t, rounding)
            rs = rs + _quad_rowsum(p * dp)
            acc = _accumulate(acc, p * (w[:, None] * dp), k_t, rounding)
            acc_b = _accumulate(acc_b, p, k_t, rounding)
        delta = w * ((rs[:, 0] + rs[:, 1]) + (rs[:, 2] + rs[:, 3]))
        acc = acc - delta[:, None] * acc_b
        delta = torch.where(torch.arange(TILE) < n_own, delta, 0.0)
        grads[0, b, h, rows] = (acc * scale)[:n_rows]
        delta_c[b, h, rows] = delta[:n_rows]

    # ---- the dk/dv kernel: own rows are keys, after the dq kernel ----
    for b, h, ft, rows in blocks():
        n_rows = ft["n_rows"]
        own_t = ft["l0"] // TILE
        if ft["n_own"] == 0 or not live_tiles(valid[b], ft)[own_t]:
            grads[1:, b, h, rows] = 0.0
            continue
        k_o, pos_o, real_o = _gather_tile(k, b, h, ft, own_t, length)
        v_o, _, _ = _gather_tile(v, b, h, ft, own_t, length)
        k_o, v_o = _round(k_o, rounding), _round(v_o, rounding)
        kadd = key_term(b, pos_o, real_o)
        acc_k, acc_v = torch.zeros(TILE, d), torch.zeros(TILE, d)
        for t in range(-(-ft["n_real"] // TILE)):
            q_t, _, _ = _gather_tile(q, b, h, ft, t, length)
            do_t, _, _ = _gather_tile(dmix, b, h, ft, t, length)
            q_t, do_t = _round(q_t, rounding), _round(do_t, rounding)
            lse2_t, w_t, delta_t = other_stats(b, h, ft, t)
            pt = torch.exp2(_scores(k_o, q_t, rounding) * scale2 + (
                kadd[:, None] - lse2_t[None, :]))
            dst = pt * (w_t[None, :] * _scores(v_o, do_t, rounding)
                        - delta_t[None, :])
            acc_v = _accumulate(acc_v, pt * w_t[None, :], do_t, rounding)
            acc_k = _accumulate(acc_k, dst, q_t, rounding)
        grads[1, b, h, rows] = (acc_k * scale)[:n_rows]
        grads[2, b, h, rows] = acc_v[:n_rows]
    return grads, delta_c, skipped


def emulate_combine(grads, length, segs, ratios, dtype):
    """``fused_combine_kernel``: per (token, head) the covering compact rows
    of the branches added in branch order in fp32, rounded once."""
    b, h = grads.shape[1:3]
    real, pos = _compact_positions(length, h, segs, ratios)
    out = torch.zeros((3, b, h, length, grads.shape[-1]))
    for (off, nseg, m) in df.branch_rows(length, segs, ratios):
        sl = slice(off, off + nseg * m)
        for hh in range(h):
            keep = real[hh, sl]
            idx = pos[hh, sl][keep]
            out[:, :, hh, idx] = out[:, :, hh, idx] + grads[:, :, hh, sl][
                :, :, keep]
    return tuple(x.permute(0, 2, 1, 3).to(dtype) for x in out)


def emulate_mega_backward(q, k, v, mask, dmix, segs, ratios, scale,
                          rounding, stats=None):
    """K1b on the card, from the forward's saved stats plane (the plain
    version's unless given)."""
    b, length, h, d = q.shape
    if stats is None:
        stats = dilated_attention_stats(q.float(), k.float(), v.float(),
                                        segment_lengths=segs,
                                        dilated_ratios=ratios, mask=mask,
                                        scale=scale)
    lse_c, w_c = emulate_prep_mega(stats, h, segs, ratios)
    grads, delta_c, skipped = emulate_core(q, k, v, mask, dmix, lse_c, w_c,
                                           segs, ratios, scale, rounding)
    return (emulate_combine(grads, length, segs, ratios, q.dtype), grads,
            skipped)


def emulate_fused_backward(q, k, v, mask, dmix, segs, ratios, scale,
                           rounding):
    """K3b on the card, from K3f's saved compact lses and the mix
    statistics (here the plain versions')."""
    _, length, _, _ = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    outs, lses = zip(*(df.fused_branch_reference(qf, kf, vf, mask, int(w),
                                                 int(r), scale)
                       for w, r in zip(segs, ratios)))
    _, m, z = df.fused_mix_reference(outs, lses, length, segs, ratios)
    lse_c = torch.cat(lses, dim=2)
    w_c = emulate_prep_fused(lse_c, m, z, segs, ratios)
    grads, delta_c, skipped = emulate_core(q, k, v, mask, dmix, lse_c, w_c,
                                           segs, ratios, scale, rounding)
    return (emulate_combine(grads, length, segs, ratios, q.dtype), grads,
            skipped)


EMULATIONS = {"mega": emulate_mega_backward, "fused": emulate_fused_backward}


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

# (B, L, H, segments, ratios, valid lengths per batch row or None); D = 48
CASES = {
    # no segment divides L; L % 16 != 0 in the second
    "no_segment_divides": (2, 352, 4, (64, 128, 160), (1, 2, 4), (352, 300)),
    "ragged": (1, 301, 4, (64, 128, 160), (1, 2, 4), (250,)),
    # groups of 100 and 150 rows: own tiles of 36 and 22 rows, key tiles
    # dead after a 70-token prefix, a batch row with no valid key
    "dead_tiles": (2, 300, 4, (100, 300), (1, 2), (70, 0)),
    "unmasked": (1, 256, 4, (64, 128, 256), (1, 2, 4), None),
}


def _case(name, seed=0):
    b, length, h, segs, ratios, lens = CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(b, length, h, 48).astype(np.float32)
                    for _ in range(4))
    mask = None
    if lens is not None:
        mask = np.arange(length)[None, :] < np.array(lens)[:, None]
        cot = cot * mask[:, :, None, None]
    return q, k, v, mask, cot, segs, ratios


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _plain_grads(q, k, v, mask, cot, segs, ratios):
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(dilated_attention(
        *leaves, segment_lengths=segs, dilated_ratios=ratios, mask=mask),
        cot.float())
    return [x.grad for x in leaves]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["mega", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_plain_in_fp32(route, name):
    """In fp32 both routes' emulation computes
    autograd through the plain ``dilated_attention`` on every row (masked
    rows included); the core writes every compact row, zeros where a row
    is no real position."""
    q, k, v, mask, cot, segs, ratios = (_t(x) if i < 5 else x for i, x in
                                        enumerate(_case(name)))
    scale = 48 ** -0.5
    got, grads_c, _ = EMULATIONS[route](q, k, v, mask, cot, segs, ratios,
                                        scale, None)
    real, _ = _compact_positions(q.shape[1], q.shape[2], segs, ratios)
    assert torch.isfinite(grads_c).all()
    assert (grads_c[:, :, ~real] == 0).all()
    want = _plain_grads(q, k, v, mask, cot, segs, ratios)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), n
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=PLAIN_TOL,
                                   rtol=PLAIN_TOL, err_msg=f"{route} {n}")


def _jax_grads(fn, q, k, v, mask, cot, segs, ratios):
    kw = dict(segment_lengths=segs, dilated_ratios=ratios)
    jm = None if mask is None else jnp.asarray(mask)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        return jax.grad(lambda a, b, c: jnp.sum(fn(
            a, b, c, mask=jm, interpret=True, **kw) * cot),
            argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


# (route, B, L, H, segments, ratios, valid lengths): geometries that JAX's
# kernels take (``mega_eligible``, ``fused_eligible``), D = 48
JAX_CASES = {
    "mega": (2, 352, 4, (64, 128, 160), (1, 2, 4), (352, 300)),
    "fused": (2, 288, 4, (96, 160, 224), (1, 2, 4), (288, 200)),
}


@pytest.mark.parametrize("route", sorted(JAX_CASES))
def test_emulation_matches_jax_kernels_in_fp32(route):
    """In fp32 the emulation computes the gradients of JAX's Pallas
    kernels: ``_mega_bwd_call`` through ``mega_dilated_attention``, and
    ``_branch_bwd_call`` + ``_combine_call`` through
    ``fused_dilated_attention``, on the valid rows."""
    b, length, h, segs, ratios, lens = JAX_CASES[route]
    eligible = mega_eligible if route == "mega" else fused_eligible
    assert eligible(length, h, 48, segs, ratios)
    rng = np.random.RandomState(3)
    q, k, v, cot = (rng.randn(b, length, h, 48).astype(np.float32)
                    for _ in range(4))
    mask = np.arange(length)[None, :] < np.array(lens)[:, None]
    cot = cot * mask[:, :, None, None]
    want = _jax_grads(j_mega if route == "mega" else j_fused, q, k, v, mask,
                      cot, segs, ratios)
    got, _, _ = EMULATIONS[route](_t(q), _t(k), _t(v), _t(mask), _t(cot),
                                  segs, ratios, 48 ** -0.5, None)
    m = mask[:, :, None, None]
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy() * m, np.asarray(w) * m,
                                   atol=JAX_TOL, rtol=JAX_TOL,
                                   err_msg=f"{route} {n}")


def test_k1b_contract_on_jax_stats_matches_jax_vjp():
    """K1b's contract, the forward's residuals only (q, k, v, the mask and
    the stats plane): the emulated K1b fed the stats plane of JAX's own
    ``_mega_fwd_call`` (interpret mode, taken back from its comb order)
    computes the gradients of JAX's VJP, its ``_mega_bwd_call`` on the
    same residuals, on the valid rows, in fp32."""
    from modaltune_tpu.ops.dilated_fused import comb, to_head_major, uncomb
    from modaltune_tpu.ops.dilated_mega import (_mega_fwd_call,
                                                make_mega_plans)
    b, length, h, segs, ratios, lens = JAX_CASES["mega"]
    rng = np.random.RandomState(5)
    q, k, v, cot = (rng.randn(b, length, h, 48).astype(np.float32)
                    for _ in range(4))
    mask = np.arange(length)[None, :] < np.array(lens)[:, None]
    cot = cot * mask[:, :, None, None]
    scale = 48 ** -0.5
    R, plans = make_mega_plans(length, segs, ratios)
    qc, kc, vc = (comb(to_head_major(jnp.asarray(x)), R) for x in (q, k, v))
    bias = jnp.where(comb(jnp.asarray(mask, jnp.float32), R) > 0.5, 0.0,
                     float(NEG_INF)).astype(jnp.float32)[:, None, :]
    _, stats = _mega_fwd_call(plans, qc, kc, vc, bias, length, h, scale,
                              interpret=True)
    stats = uncomb(jnp.swapaxes(stats, 1, 2), R)
    stats = torch.from_numpy(np.array(jnp.swapaxes(stats, 1, 2)))
    want_st = dilated_attention_stats(_t(q), _t(k), _t(v),
                                      segment_lengths=segs,
                                      dilated_ratios=ratios, mask=_t(mask))
    np.testing.assert_allclose(stats.numpy(), want_st.numpy(), atol=1e-4,
                               rtol=1e-5)
    got, _, _ = emulate_mega_backward(_t(q), _t(k), _t(v), _t(mask),
                                      _t(cot), segs, ratios, scale, None,
                                      stats=stats)
    want = _jax_grads(j_mega, q, k, v, mask, cot, segs, ratios)
    m = mask[:, :, None, None]
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy() * m, np.asarray(w) * m,
                                   atol=JAX_TOL, rtol=JAX_TOL, err_msg=n)


def _bf16_case(name, seed):
    q, k, v, mask, cot, segs, ratios = _case(name, seed)
    tq, tk, tv, tc = (_t(x).bfloat16() for x in (q, k, v, cot))
    return tq, tk, tv, _t(mask), tc, segs, ratios


def _readings(route, name, rounding):
    """Per gradient, the rel-L2 of the emulated bf16 kernels and of the
    plain fp32 gradients rounded to bf16, both against the plain fp32
    gradients on the same bf16 values; and the emulation's gradients."""
    q, k, v, mask, cot, segs, ratios = _bf16_case(name, seed=1)
    got, _, _ = EMULATIONS[route](q, k, v, mask, cot, segs, ratios,
                                  48 ** -0.5, rounding)
    want = _plain_grads(q, k, v, mask, cot, segs, ratios)
    rel = [chip_smoke.grad_readings(g, w, cot)[0] for g, w in zip(got, want)]
    floor = [chip_smoke.grad_readings(w.bfloat16(), w, cot)[0] for w in want]
    return rel, floor, got, want, cot


@pytest.mark.parametrize("route", ["mega", "fused"])
@pytest.mark.parametrize("name", ["no_segment_divides", "dead_tiles"])
def test_emulation_in_bf16_holds_the_chip_limits(route, name):
    """With bf16 inputs, P, P w dP and dS as hi + lo bf16 parts and the
    results rounded to bf16, both routes' emulated kernels hold
    chip_smoke.py's limits (``check_grads``: rel-L2 <= 1e-2, row-scaled
    <= 2e-2 for each gradient) and stay within
    1.2x the rel-L2 of the plain gradients rounded to bf16, the results'
    own rounding."""
    rel, floor, got, want, cot = _readings(route, name, "parts")
    chip_smoke.check_grads(("dq", "dk", "dv"), got, want, cot, "bfloat16",
                           f"{route} {name}")
    for n, r, f in zip(("dq", "dk", "dv"), rel, floor):
        assert r <= 1.2 * f, (n, r, f)


def test_single_rounding_misses_the_floor():
    """P and dS rounded once to bf16, as the ALiBi kernels take them, read
    1.4x the results' own rounding in every gradient: the reason the
    kernels take them as two parts."""
    rel, floor, _, _, _ = _readings("mega", "no_segment_divides", "once")
    assert all(r > 1.2 * f for r, f in zip(rel, floor)), (rel, floor)


@pytest.mark.parametrize("route", ["mega", "fused"])
def test_emulation_masks_exactly(route):
    """In bf16 as the card runs it: a masked key's dk and dv are exactly 0,
    a batch row without a valid key has zero gradients, and the dq kernel
    skips the key tiles without a valid key."""
    q, k, v, mask, cot, segs, ratios = _bf16_case("dead_tiles", seed=2)
    (dq, dk, dv), _, skipped = EMULATIONS[route](
        q, k, v, mask, cot, segs, ratios, 48 ** -0.5, "parts")
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()
    assert all((g[1] == 0).all() for g in (dq, dk, dv))
    # every block with a real row skips its group's dead key tiles
    length, heads = q.shape[1:3]
    want = 0
    for b in range(2):
        for h in range(heads):
            for t in range(tile_count(length, segs, ratios)):
                ft = locate_tile(length, segs, ratios, t, h, heads)
                if ft["n_own"]:
                    want += live_tiles(mask[b], ft).count(False)
    assert skipped == want > 0


@pytest.mark.parametrize("route", ["mega", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tf32x3_emulation_matches_plain(route, name):
    """The fp32 core as the card runs it (3xTF32): both routes' emulation
    computes autograd through the plain ``dilated_attention`` in fp32 on
    every row within ``PLAIN_TOL``, and writes every compact row, zeros
    where a row is no real position."""
    q, k, v, mask, cot, segs, ratios = (_t(x) if i < 5 else x for i, x in
                                        enumerate(_case(name)))
    got, grads_c, _ = EMULATIONS[route](q, k, v, mask, cot, segs, ratios,
                                        48 ** -0.5, "tf32x3")
    real, _ = _compact_positions(q.shape[1], q.shape[2], segs, ratios)
    assert torch.isfinite(grads_c).all()
    assert (grads_c[:, :, ~real] == 0).all()
    want = _plain_grads(q, k, v, mask, cot, segs, ratios)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=PLAIN_TOL,
                                   rtol=PLAIN_TOL, err_msg=f"{route} {n}")


def _jax_case(route, seed=3):
    """A geometry JAX's kernel for ``route`` takes, fp32, and its
    gradients through that kernel in interpret mode."""
    b, length, h, segs, ratios, lens = JAX_CASES[route]
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(b, length, h, 48).astype(np.float32)
                    for _ in range(4))
    mask = np.arange(length)[None, :] < np.array(lens)[:, None]
    cot = cot * mask[:, :, None, None]
    want = _jax_grads(j_mega if route == "mega" else j_fused, q, k, v, mask,
                      cot, segs, ratios)
    return (q, k, v, mask, cot, segs, ratios), want


@pytest.mark.parametrize("route", sorted(JAX_CASES))
def test_tf32x3_emulation_matches_jax_kernels(route):
    """The fp32 core (3xTF32) computes the gradients of JAX's Pallas
    kernels at fp32 (every dot at ``Precision.HIGHEST``), on the valid
    rows within ``JAX_TOL``: ``_mega_bwd_call`` and ``_branch_bwd_call`` +
    ``_combine_call``."""
    (q, k, v, mask, cot, segs, ratios), want = _jax_case(route)
    got, _, _ = EMULATIONS[route](_t(q), _t(k), _t(v), _t(mask), _t(cot),
                                  segs, ratios, 48 ** -0.5, "tf32x3")
    m = mask[:, :, None, None]
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy() * m, np.asarray(w) * m,
                                   atol=JAX_TOL, rtol=JAX_TOL,
                                   err_msg=f"{route} {n}")


def _excess(got, want, tol):
    """How far the worst element lies past ``assert_allclose``'s bound
    ``tol + tol |want|`` (positive: the bound is missed)."""
    return max(((g - w).abs() - tol - tol * w.abs()).max().item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("reference", ["plain", "jax"])
def test_single_tf32_misses_the_fp32_gates(reference):
    """One TF32 product (hi hi alone, about three decimal digits) misses
    the fp32 limits where three hold them, on the same inputs: against
    the plain version ``PLAIN_TOL`` and chip_smoke.py's fp32 gradient
    limit (rel-L2 ``GRAD_LIMITS["float32"]``, 5e-4 read against 4e-7),
    against JAX's kernels ``JAX_TOL``. The reason the fp32 core takes
    three TF32 products for each fp32 one."""
    if reference == "plain":
        q, k, v, mask, cot, segs, ratios = (
            _t(x) if i < 5 else x for i, x in
            enumerate(_case("no_segment_divides")))
        want, tol, m = _plain_grads(q, k, v, mask, cot, segs, ratios), \
            PLAIN_TOL, 1.0
    else:
        (q, k, v, mask, cot, segs, ratios), want = _jax_case("mega")
        q, k, v, mask, cot = (_t(x) for x in (q, k, v, mask, cot))
        want = [torch.from_numpy(np.array(w)) for w in want]
        tol, m = JAX_TOL, mask[:, :, None, None]
    want = [w * m for w in want]
    rel_limit = chip_smoke.GRAD_LIMITS["float32"][0]
    for rounding, misses in (("tf32x3", False), ("tf32", True)):
        got, _, _ = emulate_mega_backward(q, k, v, mask, cot, segs, ratios,
                                          48 ** -0.5, rounding)
        got = [g * m for g in got]
        rel = max(chip_smoke.grad_readings(g, w, cot)[0]
                  for g, w in zip(got, want))
        excess = _excess(got, want, tol)
        assert (excess > 0) == misses and (rel > rel_limit) == misses, \
            (rounding, excess, rel)


@pytest.mark.parametrize("route", ["mega", "fused"])
def test_tf32x3_emulation_masks_exactly(route):
    """In fp32 as the card runs it: a masked key's dk and dv are exactly 0,
    a batch row without a valid key has zero gradients, and the dq kernel
    skips the key tiles without a valid key, as in bf16."""
    q, k, v, mask, cot, segs, ratios = (_t(x) if i < 5 else x for i, x in
                                        enumerate(_case("dead_tiles", 2)))
    (dq, dk, dv), _, skipped = EMULATIONS[route](
        q, k, v, mask, cot, segs, ratios, 48 ** -0.5, "tf32x3")
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()
    assert all((g[1] == 0).all() for g in (dq, dk, dv))
    assert skipped > 0


# (D, dtype) -> family: GigaPath's head size in bf16 and fp32, the
# adapter's D = 16, the other padded head sizes
FAMILY_CASES = [
    (48, torch.bfloat16, "wgmma"),
    (48, torch.float32, "tf32x3"),
    (32, torch.float32, "cuda_cores"),
    (16, torch.float32, "cuda_cores"),
    (16, torch.bfloat16, "cuda_cores"),
    (32, torch.bfloat16, "cuda_cores"),
    (64, torch.bfloat16, "cuda_cores"),
    (128, torch.bfloat16, "cuda_cores"),
    (40, torch.bfloat16, "cuda_cores"),
]


@pytest.mark.parametrize("d,dtype,want", FAMILY_CASES)
def test_family_choice(d, dtype, want):
    """The family rule, forward and backward alike: each tensor-core family
    (bf16 and fp32 at D = 48) has a forward core and a gradient core of
    its own in ``csrc/``; the CUDA-core family has none."""
    assert df.family(d, dtype) == want
    if want == "cuda_cores":
        assert want not in df.CORE_SOURCES
        return
    csrc = Path(df.__file__).resolve().parent.parent / "csrc"
    fwd, bwd = df.CORE_SOURCES[want]
    assert (csrc / fwd).is_file() and (csrc / bwd).is_file()
    others = [s for f, s in df.CORE_SOURCES.items() if f != want]
    assert all({fwd, bwd}.isdisjoint(s) for s in others)


GIGAPATH = (10240, (1024, 5792, 10240, 10240, 10240), (1, 2, 4, 8, 16))


def test_tile_plan_at_the_train_step():
    """GigaPath at 10,240 tokens: 20,512 compact rows and 322 tiles a head;
    a ratio-2 group of the first segment holds 2,896 rows (45.25 tiles),
    of the second 2,224; a ratio-16 group 640. Every tile lies in one
    (segment, head group) and the tiles of a group cover its m rows once."""
    length, segs, ratios = GIGAPATH
    assert df.total_rows(length, segs, ratios) == 20512
    assert tile_count(length, segs, ratios) == 322
    n_real = {}
    for h in (0, 7, 15):
        covered = {}
        for t in range(322):
            ft = locate_tile(length, segs, ratios, t, h, 16)
            key = (ft["branch"], ft["seg_row"])
            covered.setdefault(key, []).append((ft["l0"], ft["n_rows"]))
            n_real[ft["branch"], ft["first"]] = ft["n_real"]
            assert 0 <= ft["n_own"] <= ft["n_rows"] <= 64
        for (bi, _), spans in covered.items():
            m = df.branch_rows(length, segs, ratios)[bi][2]
            assert sorted(spans) == [(l0, min(64, m - l0))
                                     for l0 in range(0, m, 64)]
    assert n_real[1, 0] == 2896 and n_real[1, 5792] == 2224
    assert n_real[4, 0] == 640 and n_real[0, 0] == 1024


@pytest.mark.parametrize("length,segs,ratios,heads", [
    (352, (64, 128, 160), (1, 2, 4), 4),
    (301, (64, 128, 160), (1, 2, 4), 4),
    (90, (32, 90), (1, 4), 6),
    GIGAPATH[:3] + (16,),
])
def test_gather_rows_stay_in_their_group(length, segs, ratios, heads):
    """The rows a tile gathers: real rows are positions of their segment,
    below L and in their head group's residue class mod r; every other
    row is zero-filled, so no position past L is ever read."""
    for h in range(heads):
        for t in range(tile_count(length, segs, ratios)):
            ft = locate_tile(length, segs, ratios, t, h, heads)
            sl = min(int(segs[ft["branch"]]), length)
            seg = (ft["first"] - ft["first"] % sl) // sl
            for tt in range(-(-ft["n_real"] // TILE)):
                pos, real = tile_positions(ft, tt)
                for p, re in zip(pos, real):
                    if re:
                        assert seg * sl <= p < min(seg * sl + sl, length)
                        assert (p - seg * sl) % ft["r"] == \
                            ft["first"] - seg * sl
                assert sum(real) == min(TILE, ft["n_real"] - tt * TILE)


def test_live_tiles_follow_the_mask():
    """A prefix mask keeps the first tiles of a group live; a mask with
    holes between live stretches keeps exactly the tiles that hold a
    valid key."""
    length, segs, ratios = 1000, (1000,), (2,)
    ft = locate_tile(length, segs, ratios, 0, 0, 4)
    assert ft["n_real"] == 500
    prefix = [p < 300 for p in range(length)]
    assert live_tiles(prefix, ft) == [True, True, True, False, False,
                                         False, False, False]
    holes = [(p // 256) % 2 == 0 for p in range(length)]
    # group rows are even positions: tile t holds positions [128 t, + 128)
    assert live_tiles(holes, ft) == [True, True, False, False, True,
                                        True, False, False]
