"""The tensor-core families of the dilated attention forward (K1f and K3f
at D = 48: bf16 on wgmma, fp32 on 3xTF32) emulated step by step on the CPU,
against the plain versions and JAX's Pallas kernels.

``csrc/dilated_fwd_wgmma.cu`` and ``csrc/dilated_fwd_tf32.cu`` cannot run
here. What they compute is written out below in the order the card
computes it (the fp32 core's differences after the list):

* the forward core: a block owns 64-row compact tiles of one (batch, head,
  branch, segment) (``ops/dilated_fused.py``'s layout) and streams the
  64-row key tiles of the same (segment, head group), rows past ``n_real``
  zero-filled and masked, the tiles without a valid key skipped; per live
  tile the online softmax in base 2 (``exp2`` of ``s * scale * log2(e) +
  key term - running max``), bf16 operands with fp32 sums, the row sum of
  the fp32 probabilities, P entering ``O += P v`` rounded once to bf16; it
  writes compact ``out_c`` in the input dtype and ``lse_c`` in fp32, 0 and
  NEG_INF for a row that is no real position or has no valid key;
* the mix, one kernel for both routes: per (token, head) ``m = max_b
  lse_b``, ``Z = sum_b exp(lse_b - m)`` over the lses above
  ``MASK_THRESHOLD`` and the mixed output; K3 keeps ``(lse_c, m, Z)``
  for its backward, K1 with stats writes its plane ``[lse_0 .. lse_{n-1},
  m, Z]`` (NEG_INF where a branch does not cover the slot). Neither keeps
  a branch's output.

The fp32 core (``"tf32x3"``) runs the same tiles and mix on fp32
operands, each 64-key tile in two halves of 32 keys: the scores ``q k^T``
and ``O += P v`` as ``mma.sync`` m16n8k8 steps of 8 along their inner
dimension, every operand (P included) split into hi = tf32(x) and lo =
tf32(x - hi), each step adding lo hi, hi lo and hi hi to the accumulator
in that order, each add truncated to fp32 (the tensor cores' accumulate:
the exact sum rounded toward zero); a half's ``P v`` summed in a fresh
accumulator that is added to O in fp32 after O's rescale; the row sum a
partial per thread of a row's quad (8 of the half's columns each), the
quad's four added pairwise at the end; out and lse in fp32. It is held to
the plain version and to JAX's kernels at the fp32 limits below, one TF32
product (``"tf32"``) is shown to miss the output's rel-L2 gate, and its
stats feed the fp32 backward's emulation.

In fp32 the emulation is held against JAX's ``mega_dilated_attention`` and
``fused_dilated_attention`` in interpret mode and against the port's plain
``dilated_attention``, ``dilated_attention_stats`` and the plain branches;
in bf16 at ``chip_smoke.py``'s limits. The emulated forward's planes feed the
emulated backward of ``tests/test_torch_dilated_bwd.py`` (each route's prep,
the gradient core, the combine), whose gradients stay within 1.2x the
results' own bf16 rounding. ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold the kernels themselves to the plain versions on the
card.
"""

import functools
import math

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
from modaltune_tpu_torch.ops.flash_attention import NEG_INF
from test_torch_dilated_bwd import (CASES, JAX_CASES, LOG2E, TF32, TILE,
                                    _bf16_case, _case, _gather_tile,
                                    _plain_grads, _round, _t, _tf32_parts,
                                    chip_smoke, emulate_combine,
                                    emulate_core, emulate_prep_fused,
                                    emulate_prep_mega, live_tiles, locate_tile,
                                    tile_count)

from _one_thread import one_thread  # noqa: F401  (one CPU thread a test)

LN2 = math.log(2.0)
SCALE = 48 ** -0.5
# fp32 against JAX: its kernels hold whole score rows, the emulation
# streams 64-row tiles and takes exp2 of base-2 scores: summation order.
JAX_TOL = 2e-4
# fp32 against the plain version, one framework.
PLAIN_TOL = 2e-5
# lse and (m, Z), as chip_smoke.py holds them on the card
STATS_TOL = 1e-3
# the fp32 output's rel-L2 against the plain fp32 forward, as chip_smoke.py
# holds the 3xTF32 family on the card
FP32_OUT_REL = 1e-5


def _p_operand(p, rounding):
    """P as ``O += P v`` takes it: rounded once to bf16 (the kernel, under
    ``"once"``), as two bf16 parts hi + lo (``"parts"``, the alternative
    the emulation measures) or as is (None, fp32)."""
    if rounding is None:
        return p
    hi = p.bfloat16().float()
    return hi + (p - hi).bfloat16().float() if rounding == "parts" else hi


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _trunc32(x):
    """A float64 tensor to fp32 rounded toward zero, as the tensor cores
    write their fp32 accumulator."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mma_product(a, b, rounding):
    """``a @ b`` in a fresh accumulator as the fp32 core's ``mma.sync``
    m16n8k8 steps compute it, step by step of 8 along the inner dimension:
    under ``"tf32x3"`` lo(a) hi(b), then hi(a) lo(b), then hi(a) hi(b)
    (``cvt.rna`` parts, :func:`_tf32_parts`); under ``"tf32"`` hi(a) hi(b)
    alone. Each ``mma`` adds its 8 exact products to the accumulator and
    rounds the sum toward zero to fp32 (:func:`_trunc32`)."""
    k = a.shape[1]
    ah, al = _tf32_parts(a)
    bh, bl = _tf32_parts(b)

    def steps(x, y):   # (k / 8, M, N): each 8-deep step's product, exact
        return torch.einsum("mkc,kcn->kmn",
                            x.double().reshape(-1, k // 8, 8),
                            y.double().reshape(k // 8, 8, -1))
    terms = ([steps(al, bh), steps(ah, bl), steps(ah, bh)]
             if rounding == "tf32x3" else [steps(ah, bh)])
    acc = torch.zeros(a.shape[0], b.shape[1])
    for st in range(k // 8):
        for term in terms:
            acc = _trunc32(acc.double() + term[st])
    return acc


def _thread_sums(p):
    """Per row of a 64 x 32 half, the partial row sums of the row's quad:
    thread c adds ``p[8 j + 2 c] + p[8 j + 2 c + 1]`` for j = 0..3 in order
    -> (64, 4)."""
    x = p.reshape(TILE, 4, 4, 2)
    sums = torch.zeros(TILE, 4)
    for j in range(4):
        sums = sums + (x[:, j, :, 0] + x[:, j, :, 1])
    return sums


def _tf32_tile(state, q_o, k_t, v_t, term, scale2, rounding):
    """One live key tile through the fp32 core, in two halves of 32 keys:
    the scores, the online softmax in base 2 (scale and key term in one
    FMA), O rescaled, the row sums per thread, then the half's ``P v`` in a
    fresh accumulator added to O. ``state`` is ``(O (64, 48), the running
    max (64,), the row sums (64, 4))``."""
    o, m_run, l_run = state
    for h in (slice(0, TILE // 2), slice(TILE // 2, TILE)):
        x = (_mma_product(q_o, k_t[h].T, rounding).double() * scale2
             + term[h].double()[None, :]).float()
        m_new = torch.maximum(m_run, x.amax(dim=1))
        c = torch.exp2(m_run - m_new)
        p = torch.exp2(x - m_new[:, None])
        o = o * c[:, None]
        l_run = l_run * c[:, None] + _thread_sums(p)
        o = o + _mma_product(p, v_t[h], rounding)
        m_run = m_new
    return o, m_run, l_run


def emulate_forward_core(q, k, v, mask, segs, ratios, scale, rounding):
    """The forward core: compact ``(out_c (B, H, M, D) in q's dtype, lse_c
    (B, H, M) fp32)``, a row no block writes left NaN; and the number of
    key tiles the blocks skipped. ``rounding``: None (fp32), ``"once"``
    (the bf16 core: bf16 operands, P rounded once), ``"parts"``,
    ``"tf32x3"`` (the fp32 core, :func:`_tf32_tile`) or ``"tf32"`` (one
    TF32 product)."""
    b_, length, heads, d = q.shape
    valid = torch.ones(b_, length, dtype=torch.bool) if mask is None \
        else mask.bool()
    scale2 = scale * LOG2E
    rows = df.total_rows(length, segs, ratios)
    out_c = torch.full((b_, heads, rows, d), math.nan)
    lse_c = torch.full((b_, heads, rows), math.nan)
    skipped = 0
    for b in range(b_):
        for h in range(heads):
            for tile in range(tile_count(length, segs, ratios)):
                ft = locate_tile(length, segs, ratios, tile, h, heads)
                n_own, n_rows = ft["n_own"], ft["n_rows"]
                rows = slice(ft["seg_row"] + ft["l0"],
                             ft["seg_row"] + ft["l0"] + n_rows)
                if n_own == 0:
                    out_c[b, h, rows], lse_c[b, h, rows] = 0.0, NEG_INF
                    continue
                q_o = _round(_gather_tile(q, b, h, ft, ft["l0"] // TILE,
                                          length)[0], rounding)
                tf32 = rounding in TF32
                m_run = torch.full((TILE,), NEG_INF)
                l_run = torch.zeros((TILE, 4) if tf32 else (TILE,))
                o = torch.zeros(TILE, d)
                for t, live in enumerate(live_tiles(valid[b], ft)):
                    if not live:
                        skipped += 1
                        continue
                    k_t, pos, real = _gather_tile(k, b, h, ft, t, length)
                    v_t, _, _ = _gather_tile(v, b, h, ft, t, length)
                    k_t, v_t = _round(k_t, rounding), _round(v_t, rounding)
                    term = torch.where(real & valid[b, pos], 0.0, -math.inf)
                    if tf32:
                        o, m_run, l_run = _tf32_tile((o, m_run, l_run), q_o,
                                                     k_t, v_t, term, scale2,
                                                     rounding)
                        continue
                    x = (q_o @ k_t.T) * scale2 + term[None, :]
                    m_new = torch.maximum(m_run, x.amax(dim=1))
                    corr = torch.exp2(m_run - m_new)
                    p = torch.exp2(x - m_new[:, None])
                    l_run = l_run * corr + p.sum(dim=1)
                    o = o * corr[:, None] + _p_operand(p, rounding) @ v_t
                    m_run = m_new
                if tf32:   # the quad's partial sums, pairwise
                    l_run = (l_run[:, 0] + l_run[:, 1]) + (l_run[:, 2]
                                                           + l_run[:, 3])
                keep = (torch.arange(TILE) < n_own) & (l_run > 0)
                safe = torch.where(keep, l_run, 1.0)
                out = torch.where(keep[:, None], o * (1.0 / safe)[:, None]
                                  if tf32 else o / safe[:, None], 0.0)
                lse = torch.where(keep, (m_run + torch.log2(safe)) * LN2,
                                  NEG_INF)
                out_c[b, h, rows] = out[:n_rows]
                lse_c[b, h, rows] = lse[:n_rows]
    return out_c.to(q.dtype), lse_c, skipped


def emulate_mix(out_c, lse_c, length, segs, ratios, planes):
    """The mix kernel: ``(mixed (B, L, H, D) in out_c's dtype, m, Z (B, H,
    L))`` and, with ``planes`` (K1 with stats), K1's ``stats (B*H, n + 2,
    L)`` (NEG_INF where a branch does not cover the slot); else None."""
    outs = df.split_branches(out_c, length, segs, ratios)
    lses = df.split_branches(lse_c, length, segs, ratios)
    mixed, m, z = df.fused_mix_reference(outs, lses, length, segs, ratios)
    if not planes:
        return mixed, m, z, None
    b, h = out_c.shape[:2]
    dense_lse = [df.from_compact(x, length, int(w), int(r), fill=NEG_INF)
                 for x, w, r in zip(lses, segs, ratios)]
    stats = torch.stack(dense_lse + [m, z], dim=2).reshape(b * h, -1, length)
    return mixed, m, z, stats


def emulate_forward(q, k, v, mask, segs, ratios, rounding, planes=False):
    """K1f or K3f on the card: the core, then the mix."""
    out_c, lse_c, _ = emulate_forward_core(q, k, v, mask, segs, ratios,
                                           SCALE, rounding)
    mixed, m, z, stats = emulate_mix(out_c, lse_c, q.shape[1], segs, ratios,
                                     planes)
    return dict(out=mixed, out_c=out_c, lse_c=lse_c, m=m, z=z, stats=stats)


def emulate_backward(route, fwd, q, k, v, mask, dmix, segs, ratios,
                     rounding="parts"):
    """The card's backward from what the emulated forward keeps: K1b's
    prep from ``stats``, K3b's from ``lse_c``, ``m`` and ``Z``; the
    gradient core (``rounding``: the bf16 core's ``"parts"``, P and dS as
    hi + lo parts, or the fp32 core's ``"tf32x3"``), delta taken in its dq
    kernel; the combine."""
    if route == "mega":
        lse_c, w_c = emulate_prep_mega(fwd["stats"], q.shape[2], segs,
                                       ratios)
    else:
        lse_c = fwd["lse_c"]
        w_c = emulate_prep_fused(lse_c, fwd["m"], fwd["z"], segs, ratios)
    grads, _, _ = emulate_core(q, k, v, mask, dmix, lse_c, w_c, segs, ratios,
                               SCALE, rounding)
    return emulate_combine(grads, q.shape[1], segs, ratios, q.dtype)


def _plain_branches(q, k, v, mask, segs, ratios):
    return [df.fused_branch_reference(q.float(), k.float(), v.float(), mask,
                                      int(w), int(r), SCALE)
            for w, r in zip(segs, ratios)]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_plain_in_fp32(name):
    """In fp32 the emulated core writes every compact row: each branch's
    out_b and lse_b are the plain branch's (0 and NEG_INF past the real
    rows); the mix gives ``dilated_attention`` on every row (masked rows
    included), and K1's plane is ``dilated_attention_stats`` with NEG_INF
    exactly where it has it."""
    q, k, v, mask, _, segs, ratios = (_t(x) if i < 5 else x for i, x in
                                      enumerate(_case(name)))
    length = q.shape[1]
    fwd = emulate_forward(q, k, v, mask, segs, ratios, None, planes=True)
    assert torch.isfinite(fwd["out_c"]).all()
    outs = df.split_branches(fwd["out_c"], length, segs, ratios)
    lses = df.split_branches(fwd["lse_c"], length, segs, ratios)
    for i, (want_o, want_l) in enumerate(_plain_branches(q, k, v, mask, segs,
                                                          ratios)):
        assert ((lses[i] == NEG_INF) == (want_l == NEG_INF)).all(), i
        np.testing.assert_allclose(lses[i].numpy(), want_l.numpy(),
                                   atol=PLAIN_TOL, rtol=PLAIN_TOL)
        np.testing.assert_allclose(outs[i].numpy(), want_o.numpy(),
                                   atol=PLAIN_TOL, rtol=PLAIN_TOL)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    np.testing.assert_allclose(fwd["out"].numpy(),
                               dilated_attention(q, k, v, **kw).numpy(),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)
    want_st = dilated_attention_stats(q, k, v, **kw)
    assert ((fwd["stats"] == NEG_INF) == (want_st == NEG_INF)).all()
    np.testing.assert_allclose(fwd["stats"].numpy(), want_st.numpy(),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)


def _jax_forward(fn, q, k, v, mask, segs, ratios):
    jm = None if mask is None else jnp.asarray(mask)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        return np.asarray(fn(*(jnp.asarray(x) for x in (q, k, v)), mask=jm,
                             interpret=True, segment_lengths=segs,
                             dilated_ratios=ratios))


@pytest.mark.parametrize("route", sorted(JAX_CASES))
def test_emulation_matches_jax_kernels_in_fp32(route):
    """In fp32 the emulated core and mix compute JAX's Pallas forward
    kernels: ``_mega_fwd_call`` through ``mega_dilated_attention`` and
    ``_branch_fwd_call`` + ``_mix_call`` through ``fused_dilated_attention``,
    on the valid rows."""
    b, length, h, segs, ratios, lens = JAX_CASES[route]
    eligible = mega_eligible if route == "mega" else fused_eligible
    assert eligible(length, h, 48, segs, ratios)
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(b, length, h, 48).astype(np.float32)
               for _ in range(3))
    mask = np.arange(length)[None, :] < np.array(lens)[:, None]
    want = _jax_forward(j_mega if route == "mega" else j_fused, q, k, v,
                        mask, segs, ratios)
    got = emulate_forward(_t(q), _t(k), _t(v), _t(mask), segs, ratios,
                          None, planes=route == "mega")["out"]
    m = mask[:, :, None, None]
    np.testing.assert_allclose(got.numpy() * m, want * m, atol=JAX_TOL,
                               rtol=JAX_TOL)


def _bf16_readings(name, rounding, seed=1):
    """The emulated bf16 forward (K1's planes included) against the plain
    version in fp32 on the same bf16 values, with the inputs."""
    q, k, v, mask, cot, segs, ratios = _bf16_case(name, seed)
    fwd = emulate_forward(q, k, v, mask, segs, ratios, rounding, planes=True)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    want = dilated_attention(q.float(), k.float(), v.float(), **kw)
    return fwd, want, (q, k, v, mask, cot, segs, ratios)


def _valid(mask, like):
    return torch.ones(like.shape[:2], dtype=torch.bool) if mask is None \
        else mask


@pytest.mark.parametrize("name", ["no_segment_divides", "dead_tiles",
                                  "ragged"])
def test_emulation_in_bf16_holds_the_chip_limits(name):
    """With bf16 inputs, P rounded once and the results rounded to bf16,
    the emulated forward holds chip_smoke.py's limits on the card: the
    output by ``check_out`` (rel-L2 <= 1e-2, row-scaled <= 2e-2) and the
    max-scaled bound 1.6e-2 on the valid rows; every compact piece by
    ``check_out``; K1's plane and K3's (m, Z) within 1e-3, NEG_INF exactly
    where the plain version has it."""
    fwd, want, (q, k, v, mask, _, segs, ratios) = _bf16_readings(name,
                                                                 "once")
    valid = _valid(mask, q)[:, :, None, None]
    got = fwd["out"].float() * valid
    chip_smoke.compare(got, want * valid, 1.6e-2, name)
    chip_smoke.check_out(got, want * valid, "bfloat16", name)
    length = q.shape[1]
    outs = df.split_branches(fwd["out_c"], length, segs, ratios)
    for i, (want_o, _) in enumerate(_plain_branches(q, k, v, mask, segs,
                                                    ratios)):
        chip_smoke.check_out(outs[i].float(), want_o, "bfloat16", f"out_c {i}")
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    want_st = dilated_attention_stats(q.float(), k.float(), v.float(), **kw)
    assert ((fwd["stats"] == NEG_INF) == (want_st == NEG_INF)).all()
    assert (fwd["stats"] - want_st).abs().max().item() <= STATS_TOL


def _out_ratio(name, rounding, seed=1):
    """rel-L2 of the emulated bf16 output over that of the plain fp32
    output rounded to bf16 (the results' own rounding), valid rows."""
    fwd, want, (q, _, _, mask, _, _, _) = _bf16_readings(name, rounding,
                                                         seed)
    valid = _valid(mask, q)[:, :, None, None]
    want = want * valid
    rel = chip_smoke.grad_readings(fwd["out"].float() * valid, want, want)[0]
    floor = chip_smoke.grad_readings(want.bfloat16().float(), want, want)[0]
    return rel / floor


@pytest.mark.parametrize("name", ["no_segment_divides", "unmasked"])
def test_single_rounding_of_p_holds_the_gates(name):
    """The record of the precision choice. P rounded once to bf16 for
    ``O += P v``, as the kernel rounds it (and K4f), reads 1.33-1.39x the
    output's own bf16 rounding, where P as two bf16 parts hi + lo reads
    1.14-1.19x; the single rounding still holds every gate of the card, the
    output's ``check_out`` limits and the gradients' 1.2x (the two tests
    around this one), so the kernel takes P once and spends no second
    ``P v`` product."""
    once, parts = _out_ratio(name, "once"), _out_ratio(name, "parts")
    assert 1.2 < once < 1.5 and parts <= 1.2, (once, parts)


@pytest.mark.parametrize("route", ["mega", "fused"])
@pytest.mark.parametrize("name", ["no_segment_divides", "dead_tiles"])
def test_gradients_from_the_emulated_forward(route, name):
    """What the emulated bf16 forward keeps (K1's ``stats``, or K3's
    ``lse_c``, ``m`` and ``Z``) through
    the emulated backward of each route hold chip_smoke.py's gradient
    limits and stay within 1.2x the rel-L2 of the plain gradients rounded
    to bf16, the results' own rounding, as the backward's emulation does
    from the plain planes."""
    q, k, v, mask, cot, segs, ratios = _bf16_case(name, seed=1)
    fwd = emulate_forward(q, k, v, mask, segs, ratios, "once",
                          planes=route == "mega")
    got = emulate_backward(route, fwd, q, k, v, mask, cot, segs, ratios)
    want = _plain_grads(q, k, v, mask, cot, segs, ratios)
    chip_smoke.check_grads(("dq", "dk", "dv"), got, want, cot, "bfloat16",
                           f"{route} {name}")
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        rel = chip_smoke.grad_readings(g, w, cot)[0]
        floor = chip_smoke.grad_readings(w.bfloat16(), w, cot)[0]
        assert rel <= 1.2 * floor, (n, rel, floor)


@pytest.mark.parametrize("route", ["mega", "fused"])
def test_emulation_masks_exactly(route):
    """In bf16 as the card runs it: a batch row without a valid key has
    mixed output 0, every lse NEG_INF, (m, Z) = (NEG_INF, 0) and finite
    values everywhere; the blocks skip exactly the key tiles without a
    valid key."""
    q, k, v, mask, _, segs, ratios = _bf16_case("dead_tiles", seed=2)
    assert not mask[1].any()
    out_c, lse_c, skipped = emulate_forward_core(q, k, v, mask, segs, ratios,
                                                 SCALE, "once")
    length, heads = q.shape[1:3]
    mixed, m, z, stats = emulate_mix(out_c, lse_c, length, segs, ratios,
                                     route == "mega")
    assert torch.isfinite(out_c.float()).all() and torch.isfinite(lse_c).all()
    assert torch.isfinite(mixed.float()).all()
    assert (mixed[1] == 0).all() and (out_c[1] == 0).all()
    assert (lse_c[1] == NEG_INF).all()
    assert (m[1] == NEG_INF).all() and (z[1] == 0).all()
    if route == "mega":
        assert (stats.reshape(2, heads, -1, length)[1, :, :len(segs)]
                == NEG_INF).all()
    want = 0
    for b in range(2):
        for h in range(heads):
            for t in range(tile_count(length, segs, ratios)):
                ft = locate_tile(length, segs, ratios, t, h, heads)
                if ft["n_own"]:
                    want += live_tiles(mask[b], ft).count(False)
    assert skipped == want > 0


def test_span_plan_pairs_the_tiles_of_a_group():
    """A block of the core owns a span of two consecutive tiles of one
    (segment, head group) (``locate_tile<2>`` of
    ``csrc/dilated_fused_common.cuh``): the spans cover every tile once,
    a span's second tile holds no row only at the end of a group with an
    odd tile count, and GigaPath's groups at 10,240 tokens hold 16, 46,
    40, 20 and 10 tiles, so none of them ends on an empty one."""
    for length, segs, ratios, heads in [
            (352, (64, 128, 160), (1, 2, 4), 4),
            (10240, (1024, 5792, 10240, 10240, 10240), (1, 2, 4, 8, 16), 16)]:
        spans, empty = 0, 0
        tiles = []
        for off, nseg, m in df.branch_rows(length, segs, ratios):
            per_seg = -(-m // TILE)
            spans += nseg * -(-per_seg // 2)
            for seg in range(nseg):
                for s in range(-(-per_seg // 2)):
                    for sub in range(2):
                        l0 = (2 * s + sub) * TILE
                        if l0 >= m:
                            empty += 1
                            continue
                        tiles.append((off + seg * m + l0))
        assert sorted(tiles) == sorted(
            ft["seg_row"] + ft["l0"] for ft in
            (locate_tile(length, segs, ratios, t, 0, heads)
             for t in range(tile_count(length, segs, ratios))))
        if length == 10240:
            assert spans == 161 and empty == 0
            assert [-(-m // TILE) for _, _, m in
                    df.branch_rows(length, segs, ratios)] == [16, 46, 40, 20,
                                                             10]


# ---------------------------------------------------------------------------
# The fp32 core (3xTF32)
# ---------------------------------------------------------------------------

def _fp32_case(name, seed=0):
    return tuple(_t(x) if i < 5 else x for i, x in
                 enumerate(_case(name, seed)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_tf32x3_emulation_matches_plain(name):
    """The fp32 core as the card runs it (3xTF32, truncating accumulates,
    each half's ``P v`` in fresh fragments) and the mix write every
    compact row: each branch's out_b and lse_b are the plain branch's
    within ``PLAIN_TOL``, NEG_INF exactly where it has it; the output is
    ``dilated_attention``'s on every row within ``PLAIN_TOL`` and, on the
    valid rows, within chip_smoke.py's fp32 gates (``check_out``: rel-L2
    <= 1e-5, row-scaled <= 5e-5; the max-scaled error within 2e-4); K1's
    plane is ``dilated_attention_stats``' within ``STATS_TOL``, NEG_INF
    exactly where it has it."""
    q, k, v, mask, _, segs, ratios = _fp32_case(name)
    length = q.shape[1]
    fwd = emulate_forward(q, k, v, mask, segs, ratios, "tf32x3", planes=True)
    assert fwd["out_c"].dtype == torch.float32
    assert torch.isfinite(fwd["out_c"]).all()
    assert torch.isfinite(fwd["lse_c"]).all()
    outs = df.split_branches(fwd["out_c"], length, segs, ratios)
    lses = df.split_branches(fwd["lse_c"], length, segs, ratios)
    for i, (want_o, want_l) in enumerate(_plain_branches(q, k, v, mask, segs,
                                                          ratios)):
        assert ((lses[i] == NEG_INF) == (want_l == NEG_INF)).all(), i
        np.testing.assert_allclose(lses[i].numpy(), want_l.numpy(),
                                   atol=PLAIN_TOL, rtol=PLAIN_TOL)
        np.testing.assert_allclose(outs[i].numpy(), want_o.numpy(),
                                   atol=PLAIN_TOL, rtol=PLAIN_TOL)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    want = dilated_attention(q, k, v, **kw)
    np.testing.assert_allclose(fwd["out"].numpy(), want.numpy(),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)
    valid = _valid(mask, q)[:, :, None, None]
    rel, _ = chip_smoke.check_out(fwd["out"] * valid, want * valid,
                                  "float32", name)
    assert rel <= FP32_OUT_REL
    chip_smoke.compare(fwd["out"] * valid, want * valid, 2e-4, name)
    want_st = dilated_attention_stats(q, k, v, **kw)
    assert ((fwd["stats"] == NEG_INF) == (want_st == NEG_INF)).all()
    assert (fwd["stats"] - want_st).abs().max().item() <= STATS_TOL


@pytest.mark.parametrize("route", sorted(JAX_CASES))
def test_tf32x3_emulation_matches_jax_kernels(route):
    """The fp32 core (3xTF32) and the mix compute JAX's Pallas forward
    kernels at fp32 (every dot at ``Precision.HIGHEST``), on the valid rows
    within ``JAX_TOL``: ``_mega_fwd_call`` and ``_branch_fwd_call`` +
    ``_mix_call``."""
    b, length, h, segs, ratios, lens = JAX_CASES[route]
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(b, length, h, 48).astype(np.float32)
               for _ in range(3))
    mask = np.arange(length)[None, :] < np.array(lens)[:, None]
    want = _jax_forward(j_mega if route == "mega" else j_fused, q, k, v,
                        mask, segs, ratios)
    got = emulate_forward(_t(q), _t(k), _t(v), _t(mask), segs, ratios,
                          "tf32x3", planes=route == "mega")["out"]
    m = mask[:, :, None, None]
    np.testing.assert_allclose(got.numpy() * m, want * m, atol=JAX_TOL,
                               rtol=JAX_TOL)


def _fp32_out_rel(name, rounding):
    """rel-L2 of the emulated fp32 output against the plain fp32 forward on
    the valid rows."""
    q, k, v, mask, _, segs, ratios = _fp32_case(name)
    got = emulate_forward(q, k, v, mask, segs, ratios, rounding)["out"]
    want = dilated_attention(q, k, v, segment_lengths=segs,
                             dilated_ratios=ratios, mask=mask)
    valid = _valid(mask, q)[:, :, None, None]
    return chip_smoke.grad_readings(got * valid, want * valid,
                                    want * valid)[0]


@pytest.mark.parametrize("name", ["no_segment_divides", "unmasked"])
def test_single_tf32_misses_the_output_gate(name):
    """One TF32 product (hi hi alone, about three decimal digits) misses
    the fp32 output's rel-L2 gate ``FP32_OUT_REL`` where three hold it, on
    the same inputs: the reason the fp32 forward core takes three TF32
    products for each fp32 one (one reads 3.9e-4 to 4.0e-4, three
    7.2e-7 to 7.4e-7)."""
    three, one = (_fp32_out_rel(name, r) for r in TF32)
    assert three <= FP32_OUT_REL < one, (three, one)


@pytest.mark.parametrize("route", ["mega", "fused"])
def test_tf32x3_emulation_masks_exactly(route):
    """In fp32 as the card runs it: a batch row without a valid key has
    mixed output 0, every lse NEG_INF, (m, Z) = (NEG_INF, 0) and finite
    values everywhere; the blocks skip exactly the key tiles without a
    valid key, as in bf16."""
    q, k, v, mask, _, segs, ratios = _fp32_case("dead_tiles", seed=2)
    assert not mask[1].any()
    out_c, lse_c, skipped = emulate_forward_core(q, k, v, mask, segs, ratios,
                                                 SCALE, "tf32x3")
    length, heads = q.shape[1:3]
    mixed, m, z, stats = emulate_mix(out_c, lse_c, length, segs, ratios,
                                     route == "mega")
    assert torch.isfinite(out_c).all() and torch.isfinite(lse_c).all()
    assert torch.isfinite(mixed).all()
    assert (mixed[1] == 0).all() and (out_c[1] == 0).all()
    assert (lse_c[1] == NEG_INF).all()
    assert (m[1] == NEG_INF).all() and (z[1] == 0).all()
    if route == "mega":
        assert (stats.reshape(2, heads, -1, length)[1, :, :len(segs)]
                == NEG_INF).all()
    want = 0
    for b in range(2):
        for h in range(heads):
            for t in range(tile_count(length, segs, ratios)):
                ft = locate_tile(length, segs, ratios, t, h, heads)
                if ft["n_own"]:
                    want += live_tiles(mask[b], ft).count(False)
    assert skipped == want > 0


@pytest.mark.parametrize("route", ["mega", "fused"])
@pytest.mark.parametrize("name", ["no_segment_divides", "dead_tiles"])
def test_tf32x3_gradients_from_the_emulated_forward(route, name):
    """What the emulated fp32 forward keeps (K1's ``stats``, or K3's
    ``lse_c``, ``m`` and ``Z``) through the emulated 3xTF32 backward of
    each route gives the plain fp32 gradients within chip_smoke.py's fp32
    limits (``check_grads``: rel-L2 <= 1e-5, row-scaled <= 5e-5)."""
    q, k, v, mask, cot, segs, ratios = _fp32_case(name, seed=1)
    fwd = emulate_forward(q, k, v, mask, segs, ratios, "tf32x3",
                          planes=route == "mega")
    got = emulate_backward(route, fwd, q, k, v, mask, cot, segs, ratios,
                           "tf32x3")
    want = _plain_grads(q, k, v, mask, cot, segs, ratios)
    chip_smoke.check_grads(("dq", "dk", "dv"), got, want, cot, "float32",
                           f"{route} {name}")
