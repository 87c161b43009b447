"""The fp32 family of the port's ALiBi kernels (K4f, K4b at D = 64, the
3xTF32 family ``"tf32x3"``, ``csrc/alibi_tf32_{fwd,bwd}.cu``) as the card
runs it, emulated step by step on the CPU in fp32:

* every product as the kernels' ``mma.sync`` m16n8k8 steps take it, each
  operand split into TF32 hi and lo (rounded to nearest at 10 mantissa
  bits) and lo·hi + hi·lo + hi·hi added per 8-deep step
  (``test_torch_dilated_bwd._product``); a score tile from zero over
  D = 64, a product over a half of 32 keys (queries in the dk/dv pass) in
  a fresh fragment added to the running sum;
* a batch row's live 64-key tiles in order, 64-row query tiles, the
  distance term ``sqrt(dy^2 + dx^2) (1 - cls_i)(1 - cls_j)`` and the key
  term folded into the base-2 logit with the kernels' two FMAs, the online
  softmax in base 2 from NEG_INF;
* the backward's vbar (the mean of the valid keys' v rows), delta =
  dout.(out - vbar) and dP = dout.(v - vbar), lse in base 2 with +1e30 for
  a dead row, a dead key tile's dk and dv zero.

The same numpy inputs, made from a seed, go through JAX's Pallas kernels in
interpret mode (both TPU tilings: a head a grid step and all heads a grid
step), through the port's plain versions and through the emulation: out,
dq, dk and dv within rel-L2 1e-5 of JAX's, lse within 1e-4, and the plain
versions held at ``chip_smoke.py``'s fp32 limits; every mask layout of the
card's checks exact; one TF32 product shown to miss those limits; the
family rule as a pure function. The kernels themselves run only on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.ops.alibi_flash import _alibi_bwd, _alibi_fwd
from modaltune_tpu_torch.ops import alibi_flash as af
from modaltune_tpu_torch.ops.alibi_flash import (
    MASK_THRESHOLD, NEG_INF, alibi_attention_backward_reference,
    alibi_attention_reference)

from _one_thread import one_thread  # noqa: F401  (one CPU thread a test)
from test_torch_alibi import _case, _chip_smoke, _mask_layout, _t
from test_torch_dilated_bwd import TF32, _product

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TILE = af.TILE
HALF = TILE // 2
# against JAX's kernels at Precision.HIGHEST: out and the gradients by
# rel-L2, lse by max|err|
REL_TOL = 1e-5
LSE_TOL = 1e-4

chip_smoke = _chip_smoke()


def _fma(a, b, c):
    """fmaf: the product exact, one rounding to fp32 (through fp64)."""
    return (a.double() * b.double() + c.double()).float()


def _products(rounding):
    """(score tile, fresh product): a score tile over D = 64 in one
    accumulator from zero, a product over a half in a fresh fragment; fp32
    products under another ``rounding``."""
    if rounding in TF32:
        def scores(a, b):
            return _product(torch.zeros(a.shape[0], b.shape[0]), a, b.T,
                            rounding)

        def fresh(x, b):
            return _product(torch.zeros(x.shape[0], b.shape[1]), x, b,
                            rounding)
        return scores, fresh
    return (lambda a, b: a @ b.T), (lambda x, b: x @ b)


def _rows64(x, r0):
    """Rows [r0, r0 + 64) of x, zero rows past its end."""
    tile = x[r0:r0 + TILE]
    return torch.cat([tile, tile.new_zeros(TILE - tile.shape[0],
                                           *tile.shape[1:])])


def _logits(s, planes_b, rows, cols, scale2, nslope2, term):
    """The kernels' base-2 logits of a score tile: fmaf(s, scale2,
    fmaf(nslope2, dist * not_cls, term)), dist an IEEE sqrt of the exact
    dy^2 + dx^2; rows and cols index the batch row's (3, NP) planes."""
    y, x, cls = planes_b
    dy = y[rows, None] - y[None, cols]
    dx = x[rows, None] - x[None, cols]
    nc = 1.0 - cls[rows, None]
    d = torch.sqrt(_fma(dy, dy, dx * dx)) * _fma(-nc, cls[None, cols], nc)
    return _fma(s, torch.tensor(scale2), _fma(torch.tensor(nslope2), d, term))


def emulate_forward(q, k, v, coords3, slopes, key_mask, rounding="tf32x3"):
    """K4f's 3xTF32 kernel: each 64-row query tile of a (b, h) over the
    batch row's live 64-key tiles in order, a tile in two halves of 32 keys.
    Returns (out, lse)."""
    b, h, n, d = q.shape
    scale2 = d ** -0.5 * LOG2E
    scores, fresh = _products(rounding)
    planes, key_add, live = af.wgmma_side_inputs(coords3, key_mask, b, n)
    out, lse = torch.zeros(b, h, n, d), torch.zeros(b, h, n)
    for bi in range(b):
        tiles = [t for t in range(live.shape[1]) if live[bi, t]]
        for g in range(h):
            nslope2 = float(np.float32(-slopes[g].item() * np.float32(LOG2E)))
            for q0 in range(0, n, TILE):
                qt = _rows64(q[bi, g], q0)
                rows = slice(q0, q0 + TILE)
                m, l = torch.full((TILE,), NEG_INF), torch.zeros(TILE)
                acc = torch.zeros(TILE, d)
                for t in tiles:
                    kt, vt = (_rows64(x[bi, g], t * TILE) for x in (k, v))
                    for hh in (0, HALF):
                        cols = slice(t * TILE + hh, t * TILE + hh + HALF)
                        half = slice(hh, hh + HALF)
                        s = _logits(scores(qt, kt[half]), planes[bi], rows,
                                    cols, scale2, nslope2,
                                    key_add[bi, None, cols])
                        m_new = torch.maximum(m, s.amax(dim=-1))
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(s - m_new[:, None])
                        l = l * corr + p.sum(dim=-1)
                        acc = acc * corr[:, None] + fresh(p, vt[half])
                        m = m_new
                nq = min(TILE, n - q0)
                ok = l[:nq] > 0
                out[bi, g, q0:q0 + nq] = acc[:nq] * torch.where(
                    ok, 1 / l[:nq], 0.0)[:, None]
                lse[bi, g, q0:q0 + nq] = torch.where(
                    ok, (m[:nq] + torch.log2(l[:nq])) * LN2, NEG_INF)
    return out, lse


def emulate_backward(q, k, v, coords3, slopes, key_mask, out, lse, dout,
                     rounding="tf32x3", center=True):
    """K4b's 3xTF32 kernels: vbar, then the dq kernel (delta =
    dout.(out - vbar) and lse2 of its rows, the live key tiles in halves of
    32 keys, dP = dout.(v - vbar), dq += dS k in a fresh fragment a half),
    then the dk/dv kernel (zeros for a dead key tile, else every query tile
    in halves of 32 queries, dv += P^T dout and dk += dS^T q in fresh
    fragments). Without ``center``, vbar = 0. Returns (dq, dk, dv)."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    scale2 = scale * LOG2E
    scores, fresh = _products(rounding)
    planes, key_add, live = af.wgmma_side_inputs(coords3, key_mask, b, n)
    n_pad = planes.shape[-1]
    valid = (key_add[:, :n] == 0).float()
    vbar = torch.zeros(b, h, 1, d)
    if center:
        vbar = (v * valid[:, None, :, None]).sum(dim=2, keepdim=True) / \
            valid.sum(dim=1).clamp_min(1.0)[:, None, None, None]
    vc = v - vbar
    delta = torch.zeros(b, h, n_pad)
    delta[..., :n] = (dout * (out - vbar)).sum(dim=-1)
    lse2 = torch.full((b, h, n_pad), 1e30)
    lse2[..., :n] = torch.where(lse > MASK_THRESHOLD, lse * LOG2E, 1e30)
    dq, dk, dv = (torch.zeros(b, h, n, d) for _ in range(3))
    for bi in range(b):
        tiles = [t for t in range(live.shape[1]) if live[bi, t]]
        for g in range(h):
            nslope2 = float(np.float32(-slopes[g].item() * np.float32(LOG2E)))
            for q0 in range(0, n, TILE):                 # the dq kernel
                qt, dt = (_rows64(x[bi, g], q0) for x in (q, dout))
                rows = slice(q0, q0 + TILE)
                acc = torch.zeros(TILE, d)
                for t in tiles:
                    kt, vt = (_rows64(x[bi, g], t * TILE) for x in (k, vc))
                    for hh in (0, HALF):
                        cols = slice(t * TILE + hh, t * TILE + hh + HALF)
                        half = slice(hh, hh + HALF)
                        term = key_add[bi, None, cols] - lse2[bi, g, rows,
                                                              None]
                        p = torch.exp2(_logits(scores(qt, kt[half]),
                                               planes[bi], rows, cols, scale2,
                                               nslope2, term))
                        ds = p * (scores(dt, vt[half])
                                  - delta[bi, g, rows, None])
                        acc = acc + fresh(ds, kt[half])
                nq = min(TILE, n - q0)
                dq[bi, g, q0:q0 + nq] = acc[:nq] * scale
            for t in tiles:                              # the dk/dv kernel
                kt, vt = (_rows64(x[bi, g], t * TILE) for x in (k, vc))
                rows = slice(t * TILE, t * TILE + TILE)
                acc_k, acc_v = torch.zeros(TILE, d), torch.zeros(TILE, d)
                for q0 in range(0, n, TILE):
                    qt, dt = (_rows64(x[bi, g], q0) for x in (q, dout))
                    for hh in (0, HALF):
                        cols = slice(q0 + hh, q0 + hh + HALF)
                        half = slice(hh, hh + HALF)
                        term = key_add[bi, rows, None] - lse2[bi, g, None,
                                                              cols]
                        pt = torch.exp2(_logits(scores(kt, qt[half]),
                                                planes[bi], rows, cols,
                                                scale2, nslope2, term))
                        dst = pt * (scores(vt, dt[half])
                                    - delta[bi, g, None, cols])
                        acc_v = acc_v + fresh(pt, dt[half])
                        acc_k = acc_k + fresh(dst, qt[half])
                nk = min(TILE, n - t * TILE)
                dk[bi, g, t * TILE:t * TILE + nk] = acc_k[:nk] * scale
                dv[bi, g, t * TILE:t * TILE + nk] = acc_v[:nk]
    return dq, dk, dv


def _inputs(c):
    args = [_t(c[x]) for x in ("q", "k", "v", "coords3", "slopes",
                               "key_mask")]
    cot = _t(c["cot"]) * args[5][:, None, :, None]
    return args, cot


def _jax(c, all_heads):
    """JAX's Pallas forward (out, lse) and its VJP in interpret mode, in
    the tiling ``all_heads`` names, 64-row blocks."""
    q, k, v, coords, slopes = (jnp.asarray(c[x]) for x in (
        "q", "k", "v", "coords3", "slopes"))
    bias = jnp.where(jnp.asarray(c["key_mask"]), 0.0, NEG_INF).astype(
        jnp.float32)
    scale = c["q"].shape[-1] ** -0.5
    (out, lse), res = _alibi_fwd(q, k, v, coords, slopes, bias, scale, 64, 64,
                                 True, all_heads)
    cot = jnp.asarray(c["cot"] * c["key_mask"][:, None, :, None])
    grads = _alibi_bwd(scale, 64, 64, True, all_heads, res, (cot, None))[:3]
    return (np.asarray(out), np.asarray(lse)), [np.asarray(g) for g in grads]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("all_heads", [False, True])
@pytest.mark.parametrize("n", [70, 200])
def test_tf32x3_alibi_emulation_matches_jax_kernels_and_plain(n, all_heads):
    """The 3xTF32 family at D = 64 as the card runs it computes JAX's
    Pallas kernels' function at fp32 (``Precision.HIGHEST``), in both TPU
    tilings: out, dq, dk, dv within rel-L2 1e-5, lse within 1e-4 (the
    backward from JAX's own out and lse); and holds the plain versions at
    chip_smoke.py's fp32 limits (rel-L2 1e-5, row-scaled 5e-5; lse
    1e-4)."""
    c = _case(n, b=2, h=3, seed=40 + n, masked=min(6, n // 2),
              cls_only_row=True)
    (jout, jlse), jgrads = _jax(c, all_heads)
    args, cot = _inputs(c)
    out, lse = emulate_forward(*args)
    assert _rel(out, jout) <= REL_TOL
    assert np.abs(lse.numpy() - jlse).max() <= LSE_TOL
    want_o, want_l = alibi_attention_reference(*args)
    chip_smoke.check_out(out, want_o, "float32", f"N={n} out")
    assert (lse - want_l).abs().max().item() <= LSE_TOL
    grads = emulate_backward(*args, _t(jout), _t(jlse), cot)
    want = alibi_attention_backward_reference(*args, _t(jout), _t(jlse), cot)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert _rel(g, jg) <= REL_TOL, (name, _rel(g, jg))
    chip_smoke.check_grads(("dq", "dk", "dv"), grads, want, cot, "float32",
                           f"N={n}")


def _holes(c):
    """chip_smoke.k4_inputs' "holes" cut to N = 300: a stretch of 96 keys
    masked, another per batch row, so a whole 64-key tile dies between live
    ones and its neighbours are masked in part."""
    km = c["key_mask"]
    run = np.arange(km.shape[1]) // 96
    for i in range(km.shape[0]):
        km[i, run == 1 + i] = False
    return c


@pytest.mark.parametrize("layout", ["dead_between", "cls_only",
                                    "fully_masked", "single_key_tile",
                                    "holes"])
def test_tf32x3_alibi_emulation_mask_layouts(layout):
    """Dead tiles between live ones, a row that keeps the cls key alone, a
    row without a valid key, one valid key in a far tile, the card's
    "holes": within the fp32 limits of the plain versions; a masked key's
    dk and dv exactly 0; a dead batch row's out 0, lse NEG_INF and
    gradients 0; a cls-only row's out the cls key's v row."""
    n = 300 if layout == "holes" else 200
    c = _case(n, b=2, h=2, seed=50)
    c = _holes(c) if layout == "holes" else _mask_layout(c, layout)
    args, cot = _inputs(c)
    out, lse = emulate_forward(*args)
    want_o, want_l = alibi_attention_reference(*args)
    chip_smoke.check_out(out, want_o, "float32", layout)
    assert (lse - want_l).abs().max().item() <= LSE_TOL
    grads = emulate_backward(*args, out, lse, cot)
    want = alibi_attention_backward_reference(*args, out, lse, cot)
    chip_smoke.check_grads(("dq", "dk", "dv"), grads, want, cot, "float32",
                           layout)
    dead = ~args[5]
    for g in grads[1:]:
        assert torch.all(g.transpose(1, 2)[dead] == 0)
    if layout == "cls_only":
        v = args[2]
        assert torch.allclose(out[0], v[0, :, :1].expand_as(out[0]),
                              atol=1e-6)
    if layout == "fully_masked":
        assert torch.all(out[1] == 0) and torch.all(lse[1] == NEG_INF)
        assert all(torch.all(g[1] == 0) for g in grads)
    if layout == "holes":   # the live tiles skip the dead ones
        live = af.live_key_tiles(af.padded_key_mask(args[5], 2, n, "cpu"))
        assert live.tolist() == [[1, 1, 0, 1, 1], [1, 1, 1, 0, 1]]


def test_tf32x3_alibi_single_tf32_misses_the_fp32_limits():
    """One TF32 product (hi hi alone) misses the fp32 limit (rel-L2
    ``GRAD_LIMITS["float32"]``, 1e-5) of out and of every gradient where
    three hold it, on the same inputs at D = 64."""
    c = _case(150, b=2, h=2, seed=60)
    args, cot = _inputs(c)
    want_o, want_l = alibi_attention_reference(*args)
    want = alibi_attention_backward_reference(*args, want_o, want_l, cot)
    limit = chip_smoke.GRAD_LIMITS["float32"][0]
    for rounding, misses in (("tf32x3", False), ("tf32", True)):
        out, _ = emulate_forward(*args, rounding=rounding)
        grads = emulate_backward(*args, want_o, want_l, cot,
                                 rounding=rounding)
        rel = [chip_smoke.grad_readings(out, want_o, want_o)[0]] + [
            chip_smoke.grad_readings(g, w, cot)[0]
            for g, w in zip(grads, want)]
        assert all((r > limit) == misses for r in rel), (rounding, rel)


def test_tf32x3_alibi_centering_holds_close_values():
    """Where a plane's v rows lie close together, as on an fp32 train
    step's inputs, dP and delta agree to a few digits and dq and dk are
    what is left of their difference: taken as dout.v - dout.out (vbar =
    0), 3xTF32's error of dP misses the fp32 limits against the plain
    version in fp64; less vbar, the family holds them."""
    c = _case(150, b=2, h=2, seed=6)
    rng = np.random.RandomState(6)
    c["v"] = (rng.randn(2, 2, 1, 64) + 1e-3 * rng.randn(2, 2, 150, 64)
              ).astype(np.float32)
    args, cot = _inputs(c)
    out, lse = alibi_attention_reference(*args)
    want = alibi_attention_backward_reference(
        *(a.double() for a in args[:3]), *args[3:], out.double(), lse,
        cot.double())
    readings = {}
    for center in (True, False):
        grads = emulate_backward(*args, out, lse, cot, center=center)
        readings[center] = [chip_smoke.grad_readings(g, w, cot)
                            for g, w in zip(grads[:2], want[:2])]
    limits = chip_smoke.GRAD_LIMITS["float32"]
    assert all(r[0] <= limits[0] and r[1] <= limits[1]
               for r in readings[True]), readings
    assert all(r[0] > limits[0] or r[1] > limits[1]
               for r in readings[False]), readings


def test_alibi_family_rule_and_scratch():
    """``family``, the CPU's copy of the C entry points' rule: the 3xTF32
    family for fp32 at D = 64, the wgmma family for bf16 there, the CUDA
    cores elsewhere; the backward's scratch by ``work_floats``; and the
    plain versions in fp64 (the card's oracle) equal to themselves in fp32
    within fp32 rounding."""
    for dtype, d, want in ((torch.float32, 64, "tf32x3"),
                           (torch.bfloat16, 64, "wgmma"),
                           (torch.float32, 32, "cuda_cores"),
                           (torch.float32, 128, "cuda_cores"),
                           (torch.bfloat16, 16, "cuda_cores"),
                           (torch.float64, 64, "cuda_cores")):
        assert af.family(torch.zeros(1, 1, 3, d, dtype=dtype)) == want
    assert af.FAMILIES == ("cuda_cores", "wgmma", "tf32x3")
    assert set(af.FAMILY_LAUNCHES) == set(af.BWD_FAMILY_LAUNCHES) == \
        set(af.FAMILIES)
    # vbar (64 floats), then delta and lse2 padded to whole tiles, a (b, h)
    assert af.work_floats(3, 12, 16384) == 36 * (64 + 2 * 16384)
    assert af.work_floats(2, 3, 200) == 6 * (64 + 2 * 256)
    c = _case(100, b=2, h=2, seed=70, cls_only_row=True)
    args, cot = _inputs(c)
    o32, l32 = alibi_attention_reference(*args)
    o64, l64 = alibi_attention_reference(*(a.double() for a in args[:3]),
                                         *args[3:])
    assert o64.dtype == l64.dtype == torch.float64
    assert _rel(o32, o64) <= 1e-6 and (l32 - l64).abs().max() <= 1e-5
    assert math.isclose(float(l64[0, 0, 5]), float(l32[0, 0, 5]),
                        rel_tol=1e-6)
