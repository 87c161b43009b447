"""The short-side and wgmma families of the key-bias flash attention
kernels (K2f, K2b) emulated step by step on the CPU, against the plain
versions and JAX's Pallas kernels.

``csrc/flash_short_side_{fwd,bwd}.cu`` cannot run here. What they compute
is written out below in the order the card computes it:

* the short side (at most ``SHORT_SIDE`` rows) resident, padded with zero
  rows to a multiple of 16, padded keys with the additive term -inf;
* the long side cut into 64-row tiles and split into C chunks of whole
  tiles (``csrc/flash_short_side.cuh::Chunk``), scores in base 2;
* short keys: the whole softmax of a row in one pass; short queries: the
  online softmax of every resident row over each chunk's keys into a
  partial (acc, m, l), a chunk without a valid key skipped, then the
  partials merged in chunk order;
* the backward: delta made from the dout and out rows read (in the fp32
  family's short-keys kernel against v and out less vbar, the valid keys'
  mean v row), the resident side's gradient complete, the long side's as
  a partial per chunk, the partials added in chunk order, the scale
  applied where the kernels apply it;
* in bf16, P and dS entering every product that takes them as two bf16
  parts, hi = bf16(x) and lo = bf16(x - hi), and the results rounded to
  bf16.

``csrc/flash_wgmma_{fwd,bwd}.cu`` (bf16 at D = 48, the per-branch dilated
attention's calls) likewise:

* 64-row query tiles of each bh, and the bh's 64-key tiles in order with a
  tile that holds no valid key skipped; rows past Lq or Lk (the ragged
  tails) zero-filled, past Lk with the key term -inf;
* the forward's online softmax in base 2 over the live tiles, P rounded
  once to bf16 before P v and its row sum kept in fp32;
* the backward's delta from the dout and out rows, the dq of a query tile
  over the live key tiles, the dk and dv of a key tile over every query
  tile (zeros for a tile without a valid key), P and dS as hi + lo bf16
  parts, the scale applied where the kernels apply it.

``csrc/flash_tf32_{fwd,bwd}.cu`` (the 3xTF32 family: fp32 at D = 48, the
per-branch route under an fp32 backbone) likewise: the same tiles and
skipped key tiles, each stage in two halves of 32 keys (queries in the
dk/dv kernel), every product as three TF32 products from hi + lo splits
(P and dS included), a product over keys or queries summed a half at a
time in a fresh fragment added to nearest, delta made in the dq pass, and
dP - delta taken against v and out less vbar, the valid keys' mean v row.

The same numpy inputs, made from a seed, go through the emulation, the
port's plain versions (``flash_attention_reference`` and
``flash_attention_backward_reference``, the kernels' oracles) and JAX's
Pallas kernels in interpret mode (``_fwd_pallas``, and ``_bwd_pallas``
called directly: with a key bias ``jax.grad`` through them raises, ROADMAP
F6). The family choice and the chunk plan of
``modaltune_tpu_torch/ops/flash_attention.py`` are pure functions and are
tested as such. ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``
hold the kernels themselves against the plain versions on the card.
"""

import functools
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from modaltune_tpu.ops.flash_attention import _bwd_pallas, _fwd_pallas
from modaltune_tpu_torch.ops.flash_attention import (
    MASK_THRESHOLD, MAX_CHUNK_TILES, NEG_INF, SHORT_SIDE, TILE, family,
    flash_attention_backward_reference, flash_attention_reference,
    long_side_chunks, workspace_floats)
from test_torch_dilated_bwd import TF32, _product

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# fp32 against JAX: the same algorithm in another summation order, with
# exp2 of base-2 scores for exp: a few ulp of values of order 1.
TOL = 1e-5
# bf16 against the plain fp32 version on the same bf16 values: the limits
# of chip_smoke.py. out at 1.6e-2 x max(1, max|want|) and, since that
# bound is as large as a typical |out| over hundreds of keys, also by
# check_out, rel-L2 1e-2 and row-scaled 2e-2 (GRAD_LIMITS); lse at 1e-2;
# the gradients by GRAD_LIMITS. The result's rounding to bf16 reads about
# 1e-3 of each; P and dS as hi + lo parts add about 2^-16 of theirs.
OUT_LIMIT, LSE_LIMIT = 1.6e-2, 1e-2


def _load_chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()


def _round(x, on):
    """The results in bf16 (``on`` True); fp32 as they are."""
    return x.bfloat16().float() if on is True else x


def _parts(x, on):
    """x as the kernels' products take P and dS in bf16: hi + lo."""
    if on is not True:
        return x
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _scores(a, b, rounding):
    """``a @ b.T`` over D = 16: under a TF32 rounding its two 8-deep
    ``mma.sync`` steps (:func:`_product`), else one fp32 product."""
    if rounding in TF32:
        return _product(torch.zeros(a.shape[0], b.shape[0]), a, b.T,
                        rounding)
    return a @ b.T


def _sum_groups(acc, x, b, rounding):
    """``acc + x @ b`` for a register tile x (P, dS and their transposes).
    Under a TF32 rounding the fp32 family sums each 32 of the inner index
    (a half of a 64-row tile, or a group of the resident rows, the last of
    which may hold 16) into a fresh fragment, which fp32 adds add to
    ``acc``: its tensor cores add by truncation. In bf16 x enters as hi +
    lo parts."""
    if rounding not in TF32:
        return acc + _parts(x, rounding) @ b
    for g0 in range(0, x.shape[1], 32):
        acc = acc + _product(torch.zeros_like(acc), x[:, g0:g0 + 32],
                             b[g0:g0 + 32], rounding)
    return acc


def _tile64(x, rounding, dim=0):
    """A ragged tile padded with zero rows (along ``dim``) to 64, as the
    fp32 family's stages hold it, so that its halves are 32 rows each;
    the other roundings multiply the rows there are."""
    if rounding not in TF32 or x.shape[dim] == TILE:
        return x
    if dim == 1:
        return _tile64(x.T, rounding).T
    return torch.cat([x, x.new_zeros(TILE - x.shape[0], *x.shape[1:])])


def _pad16(n):
    return -(-n // 16) * 16


def _pad_rows(x, n, value=0.0):
    """(.., L, ...) -> (.., n, ...) along dim 1, filled with ``value``."""
    out = x.new_full((x.shape[0], n, *x.shape[2:]), value)
    out[:, :x.shape[1]] = x
    return out


def _chunk(c, chunks, length):
    """Rows [r0, r1) of chunk c: tiles [c T / C, (c + 1) T / C)."""
    tiles = -(-length // TILE)
    t0, t1 = c * tiles // chunks, (c + 1) * tiles // chunks
    return t0 * TILE, min(t1 * TILE, length)


def _key_terms(bias, bh, lk, n):
    """bias * log2(e) for a valid key, -inf for a masked or padded one."""
    b = torch.zeros(bh, lk) if bias is None else bias
    add = torch.where(b > MASK_THRESHOLD, b * LOG2E, -math.inf)
    return _pad_rows(add, n, -math.inf)


def emulate_forward(q, k, v, bias, scale, chunks, rounding):
    """K2f's short-side kernels: ``rounding`` True (bf16), ``"tf32x3"``
    (the fp32 family), ``"tf32"`` (one TF32 product) or False (fp32
    products). Returns (out, lse, chunks skipped)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale2 = scale * LOG2E
    qf, kf, vf = (t.float() for t in (q, k, v))
    out, lse = torch.zeros(bh, lq, d), torch.zeros(bh, lq)
    skipped = 0
    if lk <= SHORT_SIDE:                       # short keys
        kp = _pad16(lk)
        kr, vr = _pad_rows(kf, kp), _pad_rows(vf, kp)
        kadd = _key_terms(bias, bh, lk, kp)
        for b in range(bh):
            for c in range(chunks):
                r0, r1 = _chunk(c, chunks, lq)
                for t0 in range(r0, r1, TILE):
                    rows = slice(t0, min(t0 + TILE, r1))
                    s = _scores(qf[b, rows], kr[b], rounding) * scale2 \
                        + kadd[b]
                    mx = s.amax(dim=-1).clamp_min(NEG_INF)
                    p = torch.exp2(s - mx[:, None])
                    l = p.sum(dim=-1)
                    o = _sum_groups(torch.zeros(p.shape[0], d), p, vr[b],
                                    rounding)
                    live = l > 0
                    out[b, rows] = o * torch.where(live, 1 / l, 0.0)[:, None]
                    lse[b, rows] = torch.where(
                        live, (mx + torch.log2(l)) * LN2, NEG_INF)
        return _round(out, rounding), lse, skipped
    qp = _pad16(lq)                            # short queries
    qr = _pad_rows(qf, qp)
    kadd = _key_terms(bias, bh, lk, lk)
    for b in range(bh):
        parts = []
        for c in range(chunks):
            r0, r1 = _chunk(c, chunks, lk)
            if not bool((kadd[b, r0:r1] > -math.inf).any()):
                skipped += 1                   # no tile is loaded
                parts.append((torch.zeros(qp, d), torch.full((qp,), NEG_INF),
                              torch.zeros(qp)))
                continue
            m, l = torch.full((qp,), NEG_INF), torch.zeros(qp)
            acc = torch.zeros(qp, d)
            for t0 in range(r0, r1, TILE):
                cols = slice(t0, min(t0 + TILE, r1))
                s = _scores(qr[b], kf[b, cols], rounding) * scale2 \
                    + kadd[b, cols]
                m_new = torch.maximum(m, s.amax(dim=-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * corr + p.sum(dim=-1)
                acc = _sum_groups(acc * corr[:, None], _tile64(p, rounding, 1),
                                  _tile64(vf[b, cols], rounding), rounding)
                m = m_new
            parts.append((acc, m, l))
        # the combine: chunk order, a partial with l = 0 takes no part
        mx = torch.full((qp,), NEG_INF)
        for _, m, l in parts:
            mx = torch.where(l > 0, torch.maximum(mx, m), mx)
        total_l, total_o = torch.zeros(qp), torch.zeros(qp, d)
        for acc, m, l in parts:
            w = torch.where(l > 0, torch.exp2(m - mx), 0.0)
            total_l = total_l + w * l
            total_o = total_o + w[:, None] * acc
        live = total_l > 0
        out[b] = (total_o * torch.where(live, 1 / total_l, 0.0)[:, None])[:lq]
        lse[b] = torch.where(live, (mx + torch.log2(total_l)) * LN2,
                             NEG_INF)[:lq]
    return _round(out, rounding), lse, skipped


def emulate_backward(q, k, v, bias, out, lse, dout, scale, chunks, rounding,
                     center=True):
    """K2b's short-side kernels and their fixed-order sums, ``rounding`` as
    :func:`emulate_forward`'s: (dq, dk, dv). The fp32 family's short-keys
    kernel takes dP - delta as dout.(v - vbar) - dout.(out - vbar), vbar
    the mean of the valid keys' v rows (``center``; without it, as the
    other families, dout.v - dout.out)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale2 = scale * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(dim=-1)
    lse2 = torch.where(lse > MASK_THRESHOLD, lse, -MASK_THRESHOLD) * LOG2E
    dq, dk, dv = (torch.zeros(bh, n, d) for n in (lq, lk, lk))
    if lk <= SHORT_SIDE:                       # short keys
        kp = _pad16(lk)
        kadd = _key_terms(bias, bh, lk, kp)
        if rounding in TF32 and center:   # dout.(v - vbar) - dout.(out - vbar)
            valid = (kadd[:, :lk] > -math.inf).float()[..., None]
            vbar = (vf * valid).sum(dim=1, keepdim=True) / \
                valid.sum(dim=1, keepdim=True).clamp_min(1.0)
            vf = vf - vbar
            delta = (dof * (out.float() - vbar)).sum(dim=-1)
        kr, vr = _pad_rows(kf, kp), _pad_rows(vf, kp)
        for b in range(bh):
            dk_sum, dv_sum = torch.zeros(kp, d), torch.zeros(kp, d)
            for c in range(chunks):
                dk_c, dv_c = torch.zeros(kp, d), torch.zeros(kp, d)
                r0, r1 = _chunk(c, chunks, lq)
                for t0 in range(r0, r1, TILE):
                    rows = slice(t0, min(t0 + TILE, r1))
                    p = torch.exp2(_scores(qf[b, rows], kr[b], rounding)
                                   * scale2 + kadd[b] - lse2[b, rows, None])
                    dp = _scores(dof[b, rows], vr[b], rounding)
                    ds = p * (dp - delta[b, rows, None])
                    dq[b, rows] = _sum_groups(torch.zeros(ds.shape[0], d), ds,
                                              kr[b], rounding) * scale
                    do_t, q_t = (_tile64(x[b, rows], rounding)
                                 for x in (dof, qf))
                    dv_c = _sum_groups(dv_c, _tile64(p.T, rounding, 1), do_t,
                                       rounding)
                    dk_c = _sum_groups(dk_c, _tile64(ds.T, rounding, 1), q_t,
                                       rounding)
                dk_sum, dv_sum = dk_sum + dk_c, dv_sum + dv_c
            dk[b], dv[b] = dk_sum[:lk] * scale, dv_sum[:lk]
        return tuple(_round(t, rounding) for t in (dq, dk, dv))
    qp = _pad16(lq)                            # short queries
    qr, dor = _pad_rows(qf, qp), _pad_rows(dof, qp)
    lq2 = _pad_rows(lse2, qp, -MASK_THRESHOLD * LOG2E)
    deltap = _pad_rows(delta, qp)
    kadd = _key_terms(bias, bh, lk, lk)
    for b in range(bh):
        dq_sum = torch.zeros(qp, d)
        for c in range(chunks):
            r0, r1 = _chunk(c, chunks, lk)
            dq_c = torch.zeros(qp, d)
            if bool((kadd[b, r0:r1] > -math.inf).any()):
                for t0 in range(r0, r1, TILE):
                    cols = slice(t0, min(t0 + TILE, r1))
                    pt = torch.exp2(_scores(kf[b, cols], qr[b], rounding)
                                    * scale2 + kadd[b, cols, None]
                                    - lq2[b][None, :])
                    dpt = _scores(vf[b, cols], dor[b], rounding)
                    dst = pt * (dpt - deltap[b][None, :])
                    zero = torch.zeros(pt.shape[0], d)
                    dv[b, cols] = _sum_groups(zero, pt, dor[b], rounding)
                    dk[b, cols] = _sum_groups(zero, dst, qr[b],
                                              rounding) * scale
                    dq_c = _sum_groups(dq_c, _tile64(dst.T, rounding, 1),
                                       _tile64(kf[b, cols], rounding),
                                       rounding)
            dq_sum = dq_sum + dq_c             # a dead chunk adds zeros
        dq[b] = dq_sum[:lq] * scale
    return tuple(_round(t, rounding) for t in (dq, dk, dv))


def emulate_wgmma_forward(q, k, v, bias, scale, rounding):
    """K2f's wgmma kernel. Returns (out, lse, key tiles skipped)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale2 = scale * LOG2E
    qf, kf, vf = (t.float() for t in (q, k, v))
    kadd = _key_terms(bias, bh, lk, lk)
    out, lse = torch.zeros(bh, lq, d), torch.zeros(bh, lq)
    skipped = 0
    for b in range(bh):
        live = [t0 for t0 in range(0, lk, TILE)
                if bool((kadd[b, t0:t0 + TILE] > -math.inf).any())]
        skipped += -(-lk // TILE) - len(live)
        for q0 in range(0, lq, TILE):
            rows = slice(q0, min(q0 + TILE, lq))
            n = rows.stop - rows.start
            m, l = torch.full((n,), NEG_INF), torch.zeros(n)
            acc = torch.zeros(n, d)
            for t0 in live:
                cols = slice(t0, min(t0 + TILE, lk))
                s = qf[b, rows] @ kf[b, cols].T * scale2 + kadd[b, cols]
                m_new = torch.maximum(m, s.amax(dim=-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[:, None] + _round(p, rounding) @ vf[b, cols]
                m = m_new
            ok = l > 0
            out[b, rows] = acc * torch.where(ok, 1 / l, 0.0)[:, None]
            lse[b, rows] = torch.where(ok, (m + torch.log2(l)) * LN2,
                                       NEG_INF)
    return _round(out, rounding), lse, skipped


def emulate_wgmma_backward(q, k, v, bias, out, lse, dout, scale, rounding):
    """K2b's wgmma kernels, the dq kernel then the dk/dv kernel:
    (dq, dk, dv)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale2 = scale * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(dim=-1)
    # a row without a valid key: lse2 = 1e30, so its P is exactly 0
    lse2 = torch.where(lse > MASK_THRESHOLD, lse * LOG2E, 1e30)
    kadd = _key_terms(bias, bh, lk, lk)
    dq, dk, dv = (torch.zeros(bh, n, d) for n in (lq, lk, lk))
    for b in range(bh):
        tiles = [(t0, min(t0 + TILE, lk)) for t0 in range(0, lk, TILE)]
        live = [(t0, t1) for t0, t1 in tiles
                if bool((kadd[b, t0:t1] > -math.inf).any())]
        for q0 in range(0, lq, TILE):           # the dq kernel
            rows = slice(q0, min(q0 + TILE, lq))
            acc = torch.zeros(rows.stop - rows.start, d)
            for t0, t1 in live:
                p = torch.exp2(qf[b, rows] @ kf[b, t0:t1].T * scale2
                               + kadd[b, t0:t1] - lse2[b, rows, None])
                ds = p * (dof[b, rows] @ vf[b, t0:t1].T
                          - delta[b, rows, None])
                acc = acc + _parts(ds, rounding) @ kf[b, t0:t1]
            dq[b, rows] = acc * scale
        for t0, t1 in live:                     # the dk/dv kernel
            acc_k, acc_v = torch.zeros(t1 - t0, d), torch.zeros(t1 - t0, d)
            for q0 in range(0, lq, TILE):
                rows = slice(q0, min(q0 + TILE, lq))
                pt = torch.exp2(kf[b, t0:t1] @ qf[b, rows].T * scale2
                                + kadd[b, t0:t1, None] - lse2[b, None, rows])
                dst = pt * (vf[b, t0:t1] @ dof[b, rows].T
                            - delta[b, None, rows])
                acc_v = acc_v + _parts(pt, rounding) @ dof[b, rows]
                acc_k = acc_k + _parts(dst, rounding) @ qf[b, rows]
            dk[b, t0:t1], dv[b, t0:t1] = acc_k * scale, acc_v
    return tuple(_round(t, rounding) for t in (dq, dk, dv))


# name -> (BH, Lq, Lk, chunk counts to emulate, key mask):
# "tail12": 12 % of the keys masked at random, key 0 kept; "stretch": keys
# [150, 500) masked, which empties chunk 1 of 3 over 11 tiles; "dead_bh":
# "tail12" and the last bh with every key masked.
CASES = {
    "injector": (4, 300, 65, (1, 2, 5), "tail12"),
    "extractor": (4, 65, 300, (1, 2, 5), "tail12"),
    "dead_chunk": (2, 65, 700, (3,), "stretch"),
    "dead_bh_keys": (3, 200, 65, (2,), "dead_bh"),
    "dead_bh_queries": (3, 65, 200, (2,), "dead_bh"),
    "one_key": (3, 200, 1, (1, 4), None),
    "keys_128": (2, 300, 128, (3,), "tail12"),
    "queries_128": (2, 128, 300, (3,), "tail12"),
    "prompt_sa": (4, 65, 65, (1,), None),
}


def _case(name, seed=0):
    bh, lq, lk, chunk_counts, mask = CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(bh, n, 16).astype(np.float32)
                    for n in (lq, lk, lk, lq))
    bias = None
    if mask is not None:
        valid = rng.rand(bh, lk) >= 0.12
        valid[:, 0] = True
        if mask == "stretch":
            valid[:, 150:500] = False
        if mask == "dead_bh":
            valid[-1] = False
        bias = np.where(valid, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias, cot, chunk_counts


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jax(q, k, v, bias, cot, scale):
    """JAX's Pallas forward and backward in interpret mode, one block per
    axis."""
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        jout, jlse = _fwd_pallas(jq, jk, jv, jb, scale, 1024, 1024)
        grads = _bwd_pallas(scale, 1024, 1024, (jq, jk, jv, jb, jout, jlse),
                            (jnp.asarray(cot), None))[:3]
    return (np.asarray(jout), np.asarray(jlse)), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_jax_kernels_in_fp32(name):
    """In fp32 the emulated kernels compute JAX's Pallas kernels' function
    at every chunk count: out and lse, then dq, dk, dv from JAX's out and
    lse."""
    q, k, v, bias, cot, chunk_counts = _case(name)
    scale = 16 ** -0.5
    (jout, jlse), jgrads = _jax(q, k, v, bias, cot, scale)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    for chunks in chunk_counts:
        out, lse, _ = emulate_forward(tq, tk, tv, tb, scale, chunks, False)
        np.testing.assert_allclose(out.numpy(), jout, atol=TOL, rtol=TOL,
                                   err_msg=f"out, C = {chunks}")
        np.testing.assert_allclose(lse.numpy(), jlse, atol=TOL, rtol=TOL,
                                   err_msg=f"lse, C = {chunks}")
        grads = emulate_backward(tq, tk, tv, tb, _t(jout), _t(jlse), tcot,
                                 scale, chunks, False)
        for g, w, n in zip(grads, jgrads, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                       err_msg=f"{n}, C = {chunks}")


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_in_bf16_holds_the_chip_limits(name):
    """With bf16 inputs, P and dS as hi + lo bf16 parts and the results
    rounded to bf16, the emulated kernels stay within chip_smoke.py's
    limits of the plain fp32 versions on the same values, and their
    gradients as close to them as the results' own rounding: within 1.2x
    the rel-L2 of the plain gradients rounded to bf16 (P and dS rounded
    once to bf16 read about 1.5x)."""
    q, k, v, bias, cot, chunk_counts = _case(name, seed=1)
    tq, tk, tv, tcot = (_t(x).bfloat16() for x in (q, k, v, cot))
    tb = _t(bias)
    scale = 16 ** -0.5
    want_o, want_l = flash_attention_reference(tq.float(), tk.float(),
                                               tv.float(), tb, scale)
    for chunks in chunk_counts:
        out, lse, _ = emulate_forward(tq, tk, tv, tb, scale, chunks, True)
        chip_smoke.compare(out, want_o, OUT_LIMIT, f"out, C = {chunks}")
        chip_smoke.check_out(out, want_o, "bfloat16", f"out, C = {chunks}")
        assert (lse - want_l).abs().max().item() <= LSE_LIMIT
        out16 = out.bfloat16()
        grads = emulate_backward(tq, tk, tv, tb, out16, lse, tcot, scale,
                                 chunks, True)
        want = flash_attention_backward_reference(
            tq.float(), tk.float(), tv.float(), tb, out16.float(), lse,
            tcot.float(), scale)
        chip_smoke.check_grads(("dq", "dk", "dv"), grads, want, tcot,
                               "bfloat16", f"{name}, C = {chunks}")
        for g, w in zip(grads, want):
            floor = chip_smoke.grad_readings(w.bfloat16(), w, tcot)[0]
            assert chip_smoke.grad_readings(g, w, tcot)[0] <= 1.2 * floor


@pytest.mark.parametrize("name", ["dead_chunk", "dead_bh_keys",
                                  "dead_bh_queries", "injector"])
def test_emulation_masks_exactly(name):
    """A masked key gets exactly zero dk and dv, a bh without a valid key
    exactly out 0, lse NEG_INF and zero gradients, and a chunk without a
    valid key is skipped, in bf16 as the card runs it."""
    q, k, v, bias, cot, chunk_counts = _case(name, seed=2)
    tq, tk, tv, tcot = (_t(x).bfloat16() for x in (q, k, v, cot))
    tb = _t(bias)
    chunks = chunk_counts[-1]
    out, lse, skipped = emulate_forward(tq, tk, tv, tb, 0.25, chunks, True)
    grads = emulate_backward(tq, tk, tv, tb, out, lse, tcot, 0.25, chunks,
                             True)
    masked = tb <= MASK_THRESHOLD
    assert (grads[1][masked] == 0).all() and (grads[2][masked] == 0).all()
    dead = masked.all(dim=-1)
    if CASES[name][4] == "dead_bh":
        assert dead[-1]
    assert (out[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert all((g[dead] == 0).all() for g in grads)
    assert (skipped > 0) == (name in ("dead_chunk", "dead_bh_queries"))


def _one_key_bound(k, v, dout, scale):
    """Where a row's one valid key takes P = 1, dS = dP - delta cancels
    exactly and dq, dk are rounding noise: the bound of what 3xTF32's dP
    leaves of it, 2^-20 sum_d |dout_d v_d| (each product kept to about
    2^-21, against fp32's 2^-24) times max|k| (dq) or max|q| (dk) and the
    scale."""
    row = (dout.abs() @ v.abs().amax(dim=1, keepdim=True).transpose(1, 2))
    return 2.0 ** -20 * row.max().item() * scale


@pytest.mark.parametrize("name", list(CASES))
def test_tf32x3_emulation_matches_jax_kernels_and_plain(name):
    """The fp32 family as the card runs it (3xTF32 products, a fresh
    fragment for each 32 of a product's inner index, the chunks' partials
    merged in order, delta made in the kernel) computes JAX's Pallas
    kernels' function at fp32 (``Precision.HIGHEST``) within ``TOL`` at
    every chunk count, and holds the plain versions at chip_smoke.py's
    fp32 limits (rel-L2 1e-5 and row-scaled 5e-5, ``GRAD_LIMITS``; lse
    1e-4): out and lse, then dq, dk, dv from JAX's out and lse. At one key
    (``"one_key"``) dq and dk are exact zeros plus rounding
    (:func:`_one_key_bound`); dv and the forward hold the limits there
    too."""
    q, k, v, bias, cot, chunk_counts = _case(name)
    scale = 16 ** -0.5
    (jout, jlse), jgrads = _jax(q, k, v, bias, cot, scale)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    want_o, want_l = flash_attention_reference(tq, tk, tv, tb, scale)
    want = flash_attention_backward_reference(tq, tk, tv, tb, _t(jout),
                                              _t(jlse), tcot, scale)
    for chunks in chunk_counts:
        out, lse, _ = emulate_forward(tq, tk, tv, tb, scale, chunks,
                                      "tf32x3")
        np.testing.assert_allclose(out.numpy(), jout, atol=TOL, rtol=TOL,
                                   err_msg=f"out, C = {chunks}")
        np.testing.assert_allclose(lse.numpy(), jlse, atol=TOL, rtol=TOL,
                                   err_msg=f"lse, C = {chunks}")
        chip_smoke.check_out(out, want_o, "float32", f"out, C = {chunks}")
        assert (lse - want_l).abs().max().item() <= 1e-4
        grads = emulate_backward(tq, tk, tv, tb, _t(jout), _t(jlse), tcot,
                                 scale, chunks, "tf32x3")
        held = slice(0, 3)
        if name == "one_key":
            for g, w, x in zip(grads[:2], want[:2], (tk, tq)):
                bound = _one_key_bound(tk, tv, tcot, scale) * \
                    x.abs().max().item()
                assert (g - w).abs().max().item() <= bound
            held = slice(2, 3)
        names = ("dq", "dk", "dv")[held]
        for g, w, n in zip(grads[held], jgrads[held], names):
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                       err_msg=f"{n}, C = {chunks}")
        chip_smoke.check_grads(names, grads[held], want[held], tcot,
                               "float32", f"{name}, C = {chunks}")


def test_tf32x3_short_keys_centering_holds_close_values():
    """Where the keys' v rows lie close together, as on an fp32 train
    step's Injector, dP and delta agree to a few digits and dq is what is
    left of their difference: taken as dout.v - dout.out, 3xTF32's error of
    dP (about 2^-21 of |dout| |v|) misses the fp32 row-scaled limit against
    the plain version in fp64; less vbar, the fp32 family's short-keys
    kernel holds it."""
    rng = np.random.RandomState(5)
    bh, lq, lk = 3, 300, 65
    q, k = (rng.randn(bh, n, 16).astype(np.float32) for n in (lq, lk))
    v = (rng.randn(bh, 1, 16) + 1e-3 * rng.randn(bh, lk, 16)).astype(
        np.float32)
    cot = rng.randn(bh, lq, 16).astype(np.float32)
    tq, tk, tv, tcot = (_t(x) for x in (q, k, v, cot))
    scale = 0.25
    out, lse = flash_attention_reference(tq, tk, tv, None, scale)
    want = flash_attention_backward_reference(
        tq.double(), tk.double(), tv.double(), None, out.double(), lse,
        tcot.double(), scale)
    row_limit = chip_smoke.GRAD_LIMITS["float32"][1]
    rows = {}
    for center in (True, False):
        dq = emulate_backward(tq, tk, tv, None, out, lse, tcot, scale, 1,
                              "tf32x3", center=center)[0]
        rows[center] = chip_smoke.grad_readings(dq, want[0], tcot)[1]
    assert rows[True] <= row_limit < rows[False], rows


@pytest.mark.parametrize("name", ["injector", "extractor", "prompt_sa"])
def test_single_tf32_misses_the_fp32_limits(name):
    """One TF32 product (hi hi alone, about three decimal digits) misses
    the fp32 limit (rel-L2 ``GRAD_LIMITS["float32"]``, 1e-5) of out and of
    every gradient where three hold it, on the same inputs: the reason the
    fp32 family takes three TF32 products for each fp32 one."""
    q, k, v, bias, cot, chunk_counts = _case(name, seed=3)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    scale = 16 ** -0.5
    want_o, want_l = flash_attention_reference(tq, tk, tv, tb, scale)
    want = flash_attention_backward_reference(tq, tk, tv, tb, want_o,
                                              want_l, tcot, scale)
    limit = chip_smoke.GRAD_LIMITS["float32"][0]
    for rounding, misses in (("tf32x3", False), ("tf32", True)):
        out, _, _ = emulate_forward(tq, tk, tv, tb, scale, chunk_counts[-1],
                                    rounding)
        grads = emulate_backward(tq, tk, tv, tb, want_o, want_l, tcot, scale,
                                 chunk_counts[-1], rounding)
        rel = [chip_smoke.grad_readings(out, want_o, want_o)[0]] + [
            chip_smoke.grad_readings(g, w, tcot)[0]
            for g, w in zip(grads, want)]
        assert all((r > limit) == misses for r in rel), (rounding, rel)


@pytest.mark.parametrize("name", ["dead_chunk", "dead_bh_keys",
                                  "dead_bh_queries", "injector"])
def test_tf32x3_emulation_masks_exactly(name):
    """In fp32 as the card runs it: a masked key gets exactly zero dk and
    dv, a bh without a valid key exactly out 0, lse NEG_INF and zero
    gradients, and a chunk without a valid key is skipped."""
    q, k, v, bias, cot, chunk_counts = _case(name, seed=2)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    chunks = chunk_counts[-1]
    out, lse, skipped = emulate_forward(tq, tk, tv, tb, 0.25, chunks,
                                        "tf32x3")
    grads = emulate_backward(tq, tk, tv, tb, out, lse, tcot, 0.25, chunks,
                             "tf32x3")
    masked = tb <= MASK_THRESHOLD
    assert (grads[1][masked] == 0).all() and (grads[2][masked] == 0).all()
    dead = masked.all(dim=-1)
    assert bool(dead.any()) == (CASES[name][4] == "dead_bh")
    assert (out[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert all((g[dead] == 0).all() for g in grads)
    assert (skipped > 0) == (name in ("dead_chunk", "dead_bh_queries"))


# (Lq, Lk, D, dtype) -> family: the adapter's five shapes, both sides
# long, D = 48 in bf16 (wgmma at every Lq and Lk) and fp32 (the 3xTF32
# family at every Lq and Lk: the per-branch route under an fp32 backbone),
# D = 32 (the CUDA cores), and the short-side domain's edge at 128 / 129
# rows, in bf16 and in fp32 (the 3xTF32 short-side family at D = 16).
FAMILY_CASES = [
    (10239, 65, 16, torch.bfloat16, "short_keys"),
    (65, 10239, 16, torch.bfloat16, "short_queries"),
    (65, 65, 16, torch.bfloat16, "short_keys"),
    (16383, 65, 16, torch.bfloat16, "short_keys"),
    (65, 16383, 16, torch.bfloat16, "short_queries"),
    (1024, 1024, 48, torch.bfloat16, "wgmma"),
    (10239, 65, 16, torch.float32, "short_keys_tf32"),
    (65, 10239, 16, torch.float32, "short_queries_tf32"),
    (65, 65, 16, torch.float32, "short_keys_tf32"),
    (2047, 65, 16, torch.float32, "short_keys_tf32"),
    (65, 16383, 16, torch.float32, "short_queries_tf32"),
    (300, 128, 16, torch.float32, "short_keys_tf32"),
    (128, 300, 16, torch.float32, "short_queries_tf32"),
    (300, 129, 16, torch.float32, "cuda_cores"),
    (129, 300, 16, torch.float32, "cuda_cores"),
    (10239, 65, 48, torch.float32, "tf32x3"),
    (10239, 65, 32, torch.float32, "cuda_cores"),
    (65, 10239, 48, torch.bfloat16, "wgmma"),
    (300, 128, 16, torch.bfloat16, "short_keys"),
    (128, 300, 16, torch.bfloat16, "short_queries"),
    (300, 129, 16, torch.bfloat16, "cuda_cores"),
    (129, 300, 16, torch.bfloat16, "cuda_cores"),
    (129, 129, 16, torch.bfloat16, "cuda_cores"),
    (300, 1, 16, torch.bfloat16, "short_keys"),
    (2896, 2896, 48, torch.bfloat16, "wgmma"),
    (65, 65, 48, torch.bfloat16, "wgmma"),
    (1, 1, 48, torch.bfloat16, "wgmma"),
    (2896, 2896, 48, torch.float32, "tf32x3"),
    (640, 640, 32, torch.bfloat16, "cuda_cores"),
    (65, 10239, 48, torch.float32, "tf32x3"),
    (640, 640, 32, torch.float32, "cuda_cores"),
]


@pytest.mark.parametrize("lq,lk,d,dtype,want", FAMILY_CASES)
def test_family_choice(lq, lk, d, dtype, want):
    assert family(lq, lk, d, dtype) == want


def test_chunk_plan():
    """C from the SM count: 15 chunks of 10-11 tiles for the adapter's 36
    bh at 10,239 and 16,383 rows on 132 SMs, one for the 65-row prompt
    self-attention; every chunk within MAX_CHUNK_TILES tiles, no chunk
    empty, and the scratch a few MB at the adapter's shapes."""
    assert long_side_chunks(36, 10239, 132) == 15
    assert long_side_chunks(36, 16383, 132) == 15
    assert long_side_chunks(36, 65, 132) == 1
    for bh in (1, 3, 36, 500):
        for length in (1, 64, 65, 1000, 10239, 16383, 300000):
            for sms in (1, 132):
                chunks = long_side_chunks(bh, length, sms)
                tiles = -(-length // TILE)
                assert 1 <= chunks <= tiles
                assert -(-tiles // chunks) <= MAX_CHUNK_TILES
                assert all(_chunk(c, chunks, length)[1]
                           > _chunk(c, chunks, length)[0]
                           for c in range(chunks))
    for lq, lk in ((10239, 65), (65, 10239), (16383, 65), (65, 16383)):
        fam = family(lq, lk, 16, torch.bfloat16)
        chunks = long_side_chunks(36, max(lq, lk), 132)
        for backward in (False, True):
            mb = workspace_floats(fam, backward, 36, lq, lk, chunks) * 4e-6
            assert mb <= 8.0
    assert workspace_floats("short_keys", False, 36, 10239, 65, 15) == 0
    assert workspace_floats("short_queries", False, 36, 65, 10239, 15) == \
        36 * 15 * 80 * 18
    assert workspace_floats("short_keys", True, 36, 10239, 65, 15) == \
        36 * 15 * 80 * 32
    assert workspace_floats("cuda_cores", True, 48, 1024, 1024, 1) == 0
    # the wgmma family: the backward's delta, one float a (bh, query)
    assert workspace_floats("wgmma", False, 96, 2896, 2896, 0) == 0
    assert workspace_floats("wgmma", True, 96, 2896, 2896, 0) == 96 * 2896


def test_tf32_workspace():
    """The fp32 short-side family's scratch is the bf16 family's: the
    short-queries forward's partials (acc 16, m and l of every (bh, chunk,
    query padded to 80)), the backward's partial dk and dv (short keys) or
    dq (short queries); a few MB at the adapter's shapes; the CUDA-core
    family at fp32 takes none, the 3xTF32 family at D = 48 the backward's
    vbar of every bh (48 floats) and delta of every (bh, query)."""
    for fam in ("short_keys", "short_queries"):
        for backward in (False, True):
            for lq, lk in ((10239, 65), (65, 10239), (65, 65), (300, 128),
                           (128, 300)):
                assert workspace_floats(fam + "_tf32", backward, 36, lq, lk,
                                        15) == \
                    workspace_floats(fam, backward, 36, lq, lk, 15)
    assert workspace_floats("short_keys_tf32", False, 36, 10239, 65, 15) == 0
    assert workspace_floats("short_queries_tf32", False, 36, 65, 10239,
                            15) == 36 * 15 * 80 * 18
    assert workspace_floats("short_keys_tf32", True, 36, 10239, 65, 15) == \
        36 * 15 * 80 * 32
    assert workspace_floats("short_queries_tf32", True, 36, 65, 10239,
                            15) == 36 * 15 * 80 * 16
    assert workspace_floats("cuda_cores", True, 96, 2896, 2896, 0) == 0
    # the 3xTF32 family at D = 48: the backward's vbar, then its delta
    assert workspace_floats("tf32x3", False, 96, 2896, 2896, 0) == 0
    assert workspace_floats("tf32x3", True, 96, 2896, 2896, 0) == \
        96 * (48 + 2896)
    assert workspace_floats("tf32x3", True, 36, 65, 10239, 0) == \
        36 * (48 + 65)
    for lq, lk in ((10239, 65), (65, 10239)):
        fam = family(lq, lk, 16, torch.float32)
        chunks = long_side_chunks(36, max(lq, lk), 132)
        for backward in (False, True):
            assert workspace_floats(fam, backward, 36, lq, lk,
                                    chunks) * 4e-6 <= 8.0


# name -> (BH, Lq, Lk, keys): small cuts of the per-branch route's five
# shapes (a multiple of the 64-row tile, and the ragged lengths of a
# 181- and 362-row branch), Lq != Lk, no bias. "tail12" masks the last
# 12 % of the keys, "holes" a stretch of whole 64-key tiles between live
# ones, "finite" adds a random finite bias to "tail12", "dead_bh" masks
# every key of the last bh as well.
WGMMA_CASES = {
    "tiles": (6, 64, 64, "tail12"),
    "ragged": (6, 181, 181, "tail12"),
    "holes": (6, 362, 362, "holes"),
    "finite_bias": (6, 181, 181, "finite"),
    "dead_bh": (6, 362, 362, "dead_bh"),
    "lq_lt_lk": (4, 100, 300, "tail12"),
    "lq_gt_lk": (4, 300, 100, "finite"),
    "no_bias": (3, 130, 70, None),
}


def _wgmma_case(name, seed=0, cases=WGMMA_CASES):
    bh, lq, lk, keys = cases[name]
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(bh, n, 48).astype(np.float32)
                    for n in (lq, lk, lk, lq))
    if keys is None:
        return q, k, v, None, cot
    valid = np.ones((bh, lk), bool)
    valid[:, lk - int(0.12 * lk):] = False
    if keys == "holes":
        valid[:, 64:192] = False
    if keys == "dead_bh":
        valid[-1] = False
    bias = np.where(valid, 0.0, NEG_INF)
    if keys == "finite":
        bias = bias + 2.0 * rng.randn(bh, lk)
    return q, k, v, bias.astype(np.float32), cot


@pytest.mark.parametrize("name", list(WGMMA_CASES))
def test_wgmma_emulation_matches_jax_kernels_in_fp32(name):
    """In fp32 the emulated wgmma kernels compute JAX's Pallas kernels'
    function: out and lse, then dq, dk, dv from JAX's out and lse."""
    q, k, v, bias, cot = _wgmma_case(name)
    scale = 48 ** -0.5
    (jout, jlse), jgrads = _jax(q, k, v, bias, cot, scale)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    out, lse, _ = emulate_wgmma_forward(tq, tk, tv, tb, scale, False)
    np.testing.assert_allclose(out.numpy(), jout, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=TOL, rtol=TOL)
    grads = emulate_wgmma_backward(tq, tk, tv, tb, _t(jout), _t(jlse), tcot,
                                   scale, False)
    for g, w, n in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize("name", list(WGMMA_CASES))
def test_wgmma_emulation_in_bf16_holds_the_chip_limits(name):
    """With bf16 inputs, P rounded once to bf16 in the forward, P and dS
    as hi + lo bf16 parts in the backward and the results rounded to
    bf16, the emulated wgmma kernels stay within chip_smoke.py's limits of
    the plain fp32 versions on the same values, and their gradients
    within 1.2x the rel-L2 of the plain gradients rounded to bf16."""
    q, k, v, bias, cot = _wgmma_case(name, seed=1)
    tq, tk, tv, tcot = (_t(x).bfloat16() for x in (q, k, v, cot))
    tb = _t(bias)
    scale = 48 ** -0.5
    want_o, want_l = flash_attention_reference(tq.float(), tk.float(),
                                               tv.float(), tb, scale)
    out, lse, _ = emulate_wgmma_forward(tq, tk, tv, tb, scale, True)
    chip_smoke.compare(out, want_o, OUT_LIMIT, f"{name} out")
    chip_smoke.check_out(out, want_o, "bfloat16", f"{name} out")
    assert (lse - want_l).abs().max().item() <= LSE_LIMIT
    out16 = out.bfloat16()
    grads = emulate_wgmma_backward(tq, tk, tv, tb, out16, lse, tcot, scale,
                                   True)
    want = flash_attention_backward_reference(
        tq.float(), tk.float(), tv.float(), tb, out16.float(), lse,
        tcot.float(), scale)
    chip_smoke.check_grads(("dq", "dk", "dv"), grads, want, tcot,
                           "bfloat16", name)
    for g, w in zip(grads, want):
        floor = chip_smoke.grad_readings(w.bfloat16(), w, tcot)[0]
        assert chip_smoke.grad_readings(g, w, tcot)[0] <= 1.2 * floor


@pytest.mark.parametrize("name", ["holes", "dead_bh", "finite_bias"])
def test_wgmma_emulation_masks_exactly(name):
    """A masked key gets exactly zero dk and dv, a bh without a valid key
    exactly out 0, lse NEG_INF and zero gradients, and a key tile without
    a valid key is skipped, in bf16 as the card runs it."""
    q, k, v, bias, cot = _wgmma_case(name, seed=2)
    tq, tk, tv, tcot = (_t(x).bfloat16() for x in (q, k, v, cot))
    tb = _t(bias)
    out, lse, skipped = emulate_wgmma_forward(tq, tk, tv, tb, 0.2, True)
    grads = emulate_wgmma_backward(tq, tk, tv, tb, out, lse, tcot, 0.2, True)
    masked = tb <= MASK_THRESHOLD
    assert (grads[1][masked] == 0).all() and (grads[2][masked] == 0).all()
    dead = masked.all(dim=-1)
    assert bool(dead[-1]) == (name == "dead_bh")
    assert (out[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert all((g[dead] == 0).all() for g in grads)
    # of a bh's six tiles at 362 keys, the last (320-361) lies in the
    # masked tail: holes skips tiles 1, 2 and 5 of every bh, dead_bh tile
    # 5 of five bh and all six of the last; at 181 keys the tail leaves
    # valid keys in every tile
    assert skipped == {"holes": 18, "dead_bh": 11, "finite_bias": 0}[name]


def _rows64(x, r0, r1):
    """Rows [r0, r1) of x, padded with zero rows to the 64 of a tile."""
    tile = x[r0:r1]
    return torch.cat([tile, tile.new_zeros(TILE - tile.shape[0],
                                           *tile.shape[1:])])


def _tf32x3_products(rounding):
    """(score tile, fresh product) as the 3xTF32 family takes them: a
    score tile over D = 48 in one accumulator from zero, a product over a
    half (32 keys or queries) into a fresh fragment; fp32 products under
    another ``rounding``."""
    if rounding in TF32:
        def scores(a, b):
            return _product(torch.zeros(a.shape[0], b.shape[0]), a, b.T,
                            rounding)

        def fresh(x, b):
            return _product(torch.zeros(x.shape[0], b.shape[1]), x, b,
                            rounding)
        return scores, fresh
    return (lambda a, b: a @ b.T), (lambda x, b: x @ b)


def emulate_tf32x3_forward(q, k, v, bias, scale, rounding="tf32x3"):
    """K2f's 3xTF32 kernel: each 64-row query tile over the bh's live
    64-key tiles in order, a tile in two halves of 32 keys: S from zero,
    the online softmax in base 2 (the running max from NEG_INF), O
    rescaled and then O += P v summed in a fresh fragment. ``rounding``
    ``"tf32x3"`` (the card), ``"tf32"`` (one TF32 product) or None (fp32
    products). Returns (out, lse, key tiles skipped)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale2 = scale * LOG2E
    scores, fresh = _tf32x3_products(rounding)
    kadd = _key_terms(bias, bh, lk, -(-lk // TILE) * TILE)
    out, lse = torch.zeros(bh, lq, d), torch.zeros(bh, lq)
    skipped = 0
    for b in range(bh):
        live = [t0 for t0 in range(0, lk, TILE)
                if bool((kadd[b, t0:t0 + TILE] > -math.inf).any())]
        skipped += -(-lk // TILE) - len(live)
        for q0 in range(0, lq, TILE):
            qt = _rows64(q[b], q0, min(q0 + TILE, lq))
            m, l = torch.full((TILE,), NEG_INF), torch.zeros(TILE)
            acc = torch.zeros(TILE, d)
            for t0 in live:
                kt, vt = (_rows64(x[b], t0, min(t0 + TILE, lk)) for x in (k, v))
                for h in (0, TILE // 2):
                    half = slice(h, h + TILE // 2)
                    s = scores(qt, kt[half]) * scale2 + kadd[b, t0 + h:
                                                             t0 + h + 32]
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l = l * corr + p.sum(dim=-1)
                    acc = acc * corr[:, None] + fresh(p, vt[half])
                    m = m_new
            n = min(TILE, lq - q0)
            ok = l[:n] > 0
            out[b, q0:q0 + n] = acc[:n] * torch.where(ok, 1 / l[:n],
                                                      0.0)[:, None]
            lse[b, q0:q0 + n] = torch.where(
                ok, (m[:n] + torch.log2(l[:n])) * LN2, NEG_INF)
    return out, lse, skipped


def emulate_tf32x3_backward(q, k, v, bias, out, lse, dout, scale,
                            rounding="tf32x3", center=True):
    """K2b's 3xTF32 kernels: vbar, the mean of each bh's valid keys' v
    rows (0 without one), then the dq kernel (delta = dout.(out - vbar)
    from its rows' dout and out, the live key tiles in halves of 32 keys,
    dP = dout.(v - vbar), dq += dS k in a fresh fragment a half), then the
    dk/dv kernel (zeros for a key tile without a valid key, else every
    query tile in halves of 32 queries, dv += P^T dout and dk += dS^T q in
    fresh fragments); rows past Lq and Lk zero, their P exactly 0. Without
    ``center``, vbar = 0 (delta = dout.out, as the wgmma family takes it).
    Returns (dq, dk, dv)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale2 = scale * LOG2E
    scores, fresh = _tf32x3_products(rounding)
    lq64, lk64 = -(-lq // TILE) * TILE, -(-lk // TILE) * TILE
    kadd = _key_terms(bias, bh, lk, lk64)
    vbar = torch.zeros(bh, 1, d)
    if center:
        valid = (kadd[:, :lk] > -math.inf).float()[..., None]
        vbar = (v * valid).sum(dim=1, keepdim=True) / \
            valid.sum(dim=1, keepdim=True).clamp_min(1.0)
    v = v - vbar
    delta = (dout * (out - vbar)).sum(dim=-1)
    lse2 = _pad_rows(torch.where(lse > MASK_THRESHOLD, lse * LOG2E, 1e30),
                     lq64, 1e30)
    delta = _pad_rows(delta, lq64)
    dq, dk, dv = (torch.zeros(bh, n, d) for n in (lq, lk, lk))
    for b in range(bh):
        live = [t0 for t0 in range(0, lk, TILE)
                if bool((kadd[b, t0:t0 + TILE] > -math.inf).any())]
        for q0 in range(0, lq, TILE):           # the dq kernel
            qt, dt = (_rows64(x[b], q0, min(q0 + TILE, lq))
                      for x in (q, dout))
            rows = slice(q0, q0 + TILE)
            acc = torch.zeros(TILE, d)
            for t0 in live:
                kt, vt = (_rows64(x[b], t0, min(t0 + TILE, lk)) for x in (k, v))
                for h in (0, TILE // 2):
                    half = slice(h, h + TILE // 2)
                    p = torch.exp2(scores(qt, kt[half]) * scale2
                                   + kadd[b, t0 + h:t0 + h + 32]
                                   - lse2[b, rows, None])
                    ds = p * (scores(dt, vt[half]) - delta[b, rows, None])
                    acc = acc + fresh(ds, kt[half])
            n = min(TILE, lq - q0)
            dq[b, q0:q0 + n] = acc[:n] * scale
        for t0 in live:                         # the dk/dv kernel
            kt, vt = (_rows64(x[b], t0, min(t0 + TILE, lk)) for x in (k, v))
            kterm = kadd[b, t0:t0 + TILE, None]
            acc_k, acc_v = torch.zeros(TILE, d), torch.zeros(TILE, d)
            for q0 in range(0, lq, TILE):
                qt, dt = (_rows64(x[b], q0, min(q0 + TILE, lq))
                          for x in (q, dout))
                for h in (0, TILE // 2):
                    cols = slice(q0 + h, q0 + h + 32)
                    half = slice(h, h + TILE // 2)
                    pt = torch.exp2(scores(kt, qt[half]) * scale2 + kterm
                                    - lse2[b, None, cols])
                    dst = pt * (scores(vt, dt[half]) - delta[b, None, cols])
                    acc_v = acc_v + fresh(pt, dt[half])
                    acc_k = acc_k + fresh(dst, qt[half])
            n = min(TILE, lk - t0)
            dk[b, t0:t0 + n], dv[b, t0:t0 + n] = acc_k[:n] * scale, acc_v[:n]
    return dq, dk, dv


# the wgmma family's cases at fp32, and one key
TF32X3_CASES = {**WGMMA_CASES, "one_key": (3, 200, 1, None)}


@pytest.mark.parametrize("name", list(TF32X3_CASES))
def test_tf32x3_d48_emulation_matches_jax_kernels_and_plain(name):
    """The 3xTF32 family at D = 48 as the card runs it computes JAX's
    Pallas kernels' function at fp32 (``Precision.HIGHEST``) within
    ``TOL``, and holds the plain versions at chip_smoke.py's fp32 limits
    (rel-L2 1e-5 and row-scaled 5e-5, ``GRAD_LIMITS``; lse 1e-4): out and
    lse, then dq, dk, dv from JAX's out and lse. At one key dq and dk are
    exact zeros plus rounding (:func:`_one_key_bound`); dv and the forward
    hold the limits there too."""
    q, k, v, bias, cot = _wgmma_case(name, cases=TF32X3_CASES)
    scale = 48 ** -0.5
    (jout, jlse), jgrads = _jax(q, k, v, bias, cot, scale)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    want_o, want_l = flash_attention_reference(tq, tk, tv, tb, scale)
    out, lse, _ = emulate_tf32x3_forward(tq, tk, tv, tb, scale)
    np.testing.assert_allclose(out.numpy(), jout, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=TOL, rtol=TOL)
    chip_smoke.check_out(out, want_o, "float32", f"{name} out")
    assert (lse - want_l).abs().max().item() <= chip_smoke.K2_LSE_LIMIT
    grads = emulate_tf32x3_backward(tq, tk, tv, tb, _t(jout), _t(jlse), tcot,
                                    scale)
    want = flash_attention_backward_reference(tq, tk, tv, tb, _t(jout),
                                              _t(jlse), tcot, scale)
    held = slice(0, 3)
    if name == "one_key":
        for g, w, x in zip(grads[:2], want[:2], (tk, tq)):
            bound = _one_key_bound(tk, tv, tcot, scale) * x.abs().max().item()
            assert (g - w).abs().max().item() <= bound
        held = slice(2, 3)
    names = ("dq", "dk", "dv")[held]
    for g, w, n in zip(grads[held], jgrads[held], names):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=n)
    chip_smoke.check_grads(names, grads[held], want[held], tcot, "float32",
                           name)


@pytest.mark.parametrize("name", ["ragged", "finite_bias", "lq_lt_lk"])
def test_tf32x3_d48_single_tf32_misses_the_fp32_limits(name):
    """One TF32 product (hi hi alone) misses the fp32 limit (rel-L2
    ``GRAD_LIMITS["float32"]``, 1e-5) of out and of every gradient where
    three hold it, on the same inputs at D = 48."""
    q, k, v, bias, cot = _wgmma_case(name, seed=3)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    scale = 48 ** -0.5
    want_o, want_l = flash_attention_reference(tq, tk, tv, tb, scale)
    want = flash_attention_backward_reference(tq, tk, tv, tb, want_o,
                                              want_l, tcot, scale)
    limit = chip_smoke.GRAD_LIMITS["float32"][0]
    for rounding, misses in (("tf32x3", False), ("tf32", True)):
        out, _, _ = emulate_tf32x3_forward(tq, tk, tv, tb, scale, rounding)
        grads = emulate_tf32x3_backward(tq, tk, tv, tb, want_o, want_l, tcot,
                                        scale, rounding)
        rel = [chip_smoke.grad_readings(out, want_o, want_o)[0]] + [
            chip_smoke.grad_readings(g, w, tcot)[0]
            for g, w in zip(grads, want)]
        assert all((r > limit) == misses for r in rel), (rounding, rel)


def test_tf32x3_d48_centering_holds_close_values():
    """Where a plane's v rows lie close together, as on an fp32 train
    step's inputs, dP and delta agree to a few digits and dq and dk are
    what is left of their difference: taken as dout.v - dout.out (vbar =
    0), 3xTF32's error of dP misses the fp32 limits against the plain
    version in fp64; less vbar, the 3xTF32 family at D = 48 holds them."""
    rng = np.random.RandomState(6)
    bh, lq, lk = 2, 100, 150
    q, k = (rng.randn(bh, n, 48).astype(np.float32) for n in (lq, lk))
    v = (rng.randn(bh, 1, 48) + 1e-3 * rng.randn(bh, lk, 48)).astype(
        np.float32)
    cot = rng.randn(bh, lq, 48).astype(np.float32)
    bias = np.where(rng.rand(bh, lk) < 0.1, NEG_INF, 0.0).astype(np.float32)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    scale = 48 ** -0.5
    out, lse = flash_attention_reference(tq, tk, tv, tb, scale)
    want = flash_attention_backward_reference(
        tq.double(), tk.double(), tv.double(), tb, out.double(), lse,
        tcot.double(), scale)
    readings = {}
    for center in (True, False):
        grads = emulate_tf32x3_backward(tq, tk, tv, tb, out, lse, tcot,
                                        scale, center=center)
        readings[center] = [chip_smoke.grad_readings(g, w, tcot)
                            for g, w in zip(grads[:2], want[:2])]
    limits = chip_smoke.GRAD_LIMITS["float32"]
    assert all(r[0] <= limits[0] and r[1] <= limits[1]
               for r in readings[True]), readings
    assert all(r[0] > limits[0] or r[1] > limits[1]
               for r in readings[False]), readings


@pytest.mark.parametrize("name", ["holes", "dead_bh", "finite_bias"])
def test_tf32x3_d48_emulation_masks_exactly(name):
    """In fp32 as the 3xTF32 family runs it: a masked key gets exactly
    zero dk and dv, a bh without a valid key exactly out 0, lse NEG_INF
    and zero gradients, and a key tile without a valid key is skipped."""
    q, k, v, bias, cot = _wgmma_case(name, seed=2)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    out, lse, skipped = emulate_tf32x3_forward(tq, tk, tv, tb, 0.2)
    grads = emulate_tf32x3_backward(tq, tk, tv, tb, out, lse, tcot, 0.2)
    masked = tb <= MASK_THRESHOLD
    assert (grads[1][masked] == 0).all() and (grads[2][masked] == 0).all()
    dead = masked.all(dim=-1)
    assert bool(dead[-1]) == (name == "dead_bh")
    assert (out[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert all((g[dead] == 0).all() for g in grads)
    assert skipped == {"holes": 18, "dead_bh": 11, "finite_bias": 0}[name]


def test_plain_versions_in_fp64_agree_with_fp32():
    """Given fp64 inputs the plain versions compute in fp64 (the oracle
    chip_smoke.py holds an fp32 step's K2 launches to): fp64 results that
    agree with the fp32 evaluation to its rounding, and with JAX's Pallas
    kernels in interpret mode."""
    q, k, v, bias, cot = _wgmma_case("finite_bias", seed=4)
    (jout, jlse), jgrads = _jax(q, k, v, bias, cot, 0.2)
    tq, tk, tv, tb, tcot = (_t(x) for x in (q, k, v, bias, cot))
    out, lse = flash_attention_reference(tq, tk, tv, tb, 0.2)
    out64, lse64 = flash_attention_reference(tq.double(), tk.double(),
                                             tv.double(), tb, 0.2)
    assert out64.dtype == lse64.dtype == torch.float64
    grads = flash_attention_backward_reference(tq, tk, tv, tb, out, lse, tcot,
                                               0.2)
    grads64 = flash_attention_backward_reference(
        tq.double(), tk.double(), tv.double(), tb, out64, lse64,
        tcot.double(), 0.2)
    np.testing.assert_allclose(out64.numpy(), jout, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse64.numpy(), jlse, atol=TOL, rtol=TOL)
    chip_smoke.check_out(out, out64, "float32", "out")
    for g, g64, jg in zip(grads, grads64, jgrads):
        assert g64.dtype == torch.float64
        np.testing.assert_allclose(g64.numpy(), jg, atol=TOL, rtol=TOL)
    chip_smoke.check_grads(("dq", "dk", "dv"), grads, grads64, tcot,
                           "float32", "fp32 against fp64")


def test_plain_versions_stay_fp32_under_autocast():
    """The plain versions compute in fp32 under bf16 autocast too, as JAX's
    reference does at HIGHEST precision: bit-equal to the calls outside
    autocast, where autocast would otherwise round their products to bf16.
    The train step runs its forward under bf16 autocast."""
    q, k, v, bias, cot = _wgmma_case("finite_bias", seed=3)
    tq, tk, tv, tcot = (_t(x).bfloat16() for x in (q, k, v, cot))
    tb = _t(bias)
    out, lse = flash_attention_reference(tq, tk, tv, tb, 0.2)
    grads = flash_attention_backward_reference(tq, tk, tv, tb, out, lse,
                                               tcot, 0.2)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out_a, lse_a = flash_attention_reference(tq, tk, tv, tb, 0.2)
        grads_a = flash_attention_backward_reference(tq, tk, tv, tb, out,
                                                     lse, tcot, 0.2)
    assert torch.equal(out_a, out) and torch.equal(lse_a, lse)
    assert all(torch.equal(a, g) for a, g in zip(grads_a, grads))


def _plain_wrappers(monkeypatch, fa, skew=1.0):
    """The module's card wrappers replaced by its plain versions (dq
    scaled by ``skew``), each counting its launch by the CPU rule's
    family, in counts of the test's own, as the wrappers do on the card."""
    def fwd(q, k, v, bias, scale):
        fa.FAMILY_LAUNCHES[fa.family(q.shape[1], k.shape[1], q.shape[2],
                                     q.dtype)] += 1
        return fa.flash_attention_reference(q, k, v, bias, scale)

    def bwd(q, k, v, bias, out, lse, dout, scale):
        fa.BWD_FAMILY_LAUNCHES[fa.family(q.shape[1], k.shape[1], q.shape[2],
                                         q.dtype)] += 1
        dq, dk, dv = fa.flash_attention_backward_reference(
            q, k, v, bias, out, lse, dout, scale)
        return dq * skew, dk, dv
    for name in ("FAMILY_LAUNCHES", "BWD_FAMILY_LAUNCHES"):
        monkeypatch.setattr(fa, name, dict.fromkeys(fa.FAMILIES, 0))
    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_backward_cuda", bwd)
    monkeypatch.setattr(fa, "card_family", fa.family)


def _k2_step(fa, shapes, seed=0):
    """One forward and backward through the module's wrappers at each
    (Lq, Lk, D) of ``shapes``, fp32."""
    g = torch.Generator().manual_seed(seed)
    for lq, lk, d in shapes:
        q, dout = (torch.randn(2, lq, d, generator=g) for _ in range(2))
        k, v = (torch.randn(2, lk, d, generator=g) for _ in range(2))
        out, lse = fa.flash_attention_cuda(q, k, v, None, d ** -0.5)
        fa.flash_attention_backward_cuda(q, k, v, None, out, lse, dout,
                                         d ** -0.5)


def test_k2_call_readings_hold_fp32_launches_to_fp64(monkeypatch):
    """chip_smoke.py's gate on an fp32 step's K2 launches: each family's
    launches counted, out, lse and the gradients held to the plain
    version in fp64, the plain version's own fp32 readings beside them
    (here the "kernel" is that fp32 plain version, so both readings are
    the same); a dq off by 1e-4 of itself fails the gate."""
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    _plain_wrappers(monkeypatch, fa)
    shapes = [(70, 90, 48), (130, 65, 16)]
    _, seen = chip_smoke.k2_call_readings(lambda: _k2_step(fa, shapes),
                                          "cpu", "float32")
    assert set(seen) == {"tf32x3", "short_keys_tf32"}
    for r in seen.values():
        assert (r["fwd"], r["bwd"]) == (1, 1)
        assert r["plain_out"] == r["out"] and r["plain_grads"] == r["grads"]
        assert r["grads"][0] <= chip_smoke.GRAD_LIMITS["float32"][0]
    _plain_wrappers(monkeypatch, fa, skew=1 + 1e-4)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.k2_call_readings(lambda: _k2_step(fa, shapes[:1]), "cpu",
                                    "float32")


def test_check_one_launch_wants_one_launch_on_the_family(monkeypatch):
    """chip_smoke.py's per-call check in phase_k2 and phase_k2b: a call
    that launches once on the named family passes and returns its result;
    one on another family, or none, fails."""
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    _plain_wrappers(monkeypatch, fa)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 80, 48, generator=g) for _ in range(3))
    out, lse = chip_smoke.check_one_launch(
        "fwd", "tf32x3", lambda: fa.flash_attention_cuda(q, k, v, None, 0.2),
        "tf32x3 forward")
    assert torch.equal(out, fa.flash_attention_reference(q, k, v, None,
                                                         0.2)[0])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_one_launch(
            "bwd", "cuda_cores", lambda: fa.flash_attention_backward_cuda(
                q, k, v, None, out, lse, q, 0.2), "the wrong family")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_one_launch("fwd", "tf32x3", lambda: None, "none")
