"""The port's ALiBi attention op against the JAX package's, on the CPU, fp32.

The same numpy inputs, made from a seed, go through both packages:

* the port's ``alibi_attention_reference`` (the plain version and the K4f
  kernel's oracle) against JAX's dense oracle and against JAX's Pallas
  kernels in interpret mode, in both TPU tilings (one head per grid step,
  all heads per grid step);
* the gradients of the port's ``alibi_flash_attention`` (an
  ``autograd.Function``; on the CPU its backward is
  ``alibi_attention_backward_reference``, the K4b kernel's oracle) against
  ``jax.grad`` through the interpret-mode kernels and through the oracle,
  and against autograd through the port's own plain forward;
* a batch row whose keys are all masked but the cls token, and one whose
  keys are all masked;
* ``grid_scatter_bag``, ``alibi_slopes`` and ``alibi_bias``.

The CUDA kernels do not run here; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them against these plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.models.titan import alibi_bias as j_alibi_bias
from modaltune_tpu.models.titan import alibi_slopes as j_alibi_slopes
from modaltune_tpu.models.titan import grid_scatter_bag as j_grid_scatter
from modaltune_tpu.ops import alibi_attention_reference as j_reference
from modaltune_tpu.ops import alibi_flash_attention as j_alibi
from modaltune_tpu_torch.models.titan import (alibi_bias, alibi_slopes,
                                              grid_scatter_bag)
from modaltune_tpu_torch.ops.alibi_flash import (
    NEG_INF, alibi_attention_backward_reference, alibi_attention_reference,
    alibi_flash_attention)

from _one_thread import one_thread  # noqa: F401  (one CPU thread a test)


# Both sides run the same fp32 algorithm on two CPU backends; only the
# summation order and libm rounding differ.
OUT_TOL = 1e-5
# Gradients sum over up to 200 keys of products of such values.
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _case(n, d=64, b=2, h=4, seed=0, masked=6, cls_only_row=False):
    """q/k/v (B, H, N, D), coords3 with the cls row first and grid
    coordinates in [0, 8)^2, a key mask with the last ``masked`` cells
    invalid, a cotangent. ``cls_only_row``: batch row 0 keeps the cls key
    alone."""
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(b, h, n, d).astype(np.float32)
                    for _ in range(4))
    gc = rng.randint(0, 8, (b, n - 1, 2)).astype(np.float32)
    coords3 = np.zeros((b, n, 3), np.float32)
    coords3[:, 1:, :2] = gc
    coords3[:, 0, 2] = 1.0
    key_mask = np.ones((b, n), bool)
    key_mask[:, n - masked:] = False
    if cls_only_row:
        key_mask[0, 1:] = False
    return dict(q=q, k=k, v=v, cot=cot, coords3=coords3, key_mask=key_mask,
                slopes=j_alibi_slopes(h), gc=gc)


def _jax_out(c, **kw):
    return np.asarray(j_alibi(*(jnp.asarray(c[x]) for x in (
        "q", "k", "v", "coords3", "slopes")),
        key_mask=jnp.asarray(c["key_mask"]), **kw))


def _jax_grads(c, **kw):
    """jax.grad of sum(out * cot * valid-row weight) in q, k, v."""
    args = [jnp.asarray(c[x]) for x in ("coords3", "slopes")]
    km = jnp.asarray(c["key_mask"])
    w = jnp.asarray(c["cot"]) * km[:, None, :, None]
    return [np.asarray(g) for g in jax.grad(
        lambda q, k, v: jnp.sum(j_alibi(q, k, v, *args, key_mask=km, **kw)
                                * w), argnums=(0, 1, 2))(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]))]


def _port_grads(c, fn):
    """Autograd of the same loss through ``fn(q, k, v, coords3, slopes,
    key_mask) -> out``."""
    leaves = [_t(c[x]).requires_grad_() for x in ("q", "k", "v")]
    km = _t(c["key_mask"])
    out = fn(*leaves, _t(c["coords3"]), _t(c["slopes"]), km)
    (out * _t(c["cot"]) * km[:, None, :, None]).sum().backward()
    return [x.grad.numpy() for x in leaves]


INTERPRET = dict(use_pallas=True, interpret=True, block_q=64, block_k=64)


@pytest.mark.parametrize("all_heads", [False, True])
@pytest.mark.parametrize("n", [128, 200])
def test_alibi_reference_matches_jax(n, all_heads):
    """(a) out at 1e-5 on the valid rows: the port's plain version vs
    JAX's dense oracle and vs its Pallas kernel in interpret mode."""
    c = _case(n)
    got, lse = alibi_attention_reference(
        _t(c["q"]), _t(c["k"]), _t(c["v"]), _t(c["coords3"]),
        _t(c["slopes"]), _t(c["key_mask"]))
    m = c["key_mask"][:, None, :, None]
    assert got.shape == c["q"].shape and lse.shape == c["q"].shape[:3]
    for want in (_jax_out(c, use_pallas=False),
                 _jax_out(c, all_heads=all_heads, **INTERPRET)):
        np.testing.assert_allclose(got.numpy() * m, want * m, atol=OUT_TOL,
                                   rtol=OUT_TOL)
    # an invalid (background) query row still attends to the valid keys
    assert torch.isfinite(got).all()
    # lse is the log-sum-exp of the scores over the valid keys
    s = np.einsum("bhqd,bhkd->bhqk", c["q"], c["k"]) * c["q"].shape[-1] ** -0.5
    s = s + np.asarray(j_alibi_bias(jnp.asarray(c["gc"]), c["q"].shape[1]))
    s = np.where(c["key_mask"][:, None, None, :], s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=OUT_TOL,
                               rtol=OUT_TOL)


@pytest.mark.parametrize("all_heads", [False, True])
@pytest.mark.parametrize("n", [128, 200])
def test_alibi_function_grads_match_jax(n, all_heads):
    """(b) dq/dk/dv of the port's autograd.Function (plain backward from
    the saved out and lse) at 1e-4 vs jax.grad through the interpret-mode
    kernel and through the oracle."""
    c = _case(n, seed=1)
    got = _port_grads(c, lambda *a: alibi_flash_attention(*a[:5],
                                                          key_mask=a[5]))
    for want in (_jax_grads(c, all_heads=all_heads, **INTERPRET),
                 _jax_grads(c, use_pallas=False)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=name)
    # masked keys get exactly zero gradient
    dead = ~c["key_mask"]
    assert np.all(got[1].transpose(0, 2, 1, 3)[dead] == 0)
    assert np.all(got[2].transpose(0, 2, 1, 3)[dead] == 0)


@pytest.mark.parametrize("n,d", [(70, 16), (128, 64)])
def test_alibi_backward_reference_matches_autograd(n, d):
    """The K4b oracle vs autograd through the K4f oracle (the port against
    itself), without a mask too."""
    c = _case(n, d=d, seed=2)
    for masked in (True, False):
        if not masked:
            c["key_mask"][:] = True
        want = _port_grads(c, lambda *a: alibi_attention_reference(*a)[0])
        got = _port_grads(c, lambda *a: alibi_flash_attention(
            *a[:5], key_mask=a[5] if masked else None))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{name} masked={masked}")


def test_alibi_plain_versions_ignore_autocast():
    """F15: under the train step's bf16 autocast (the CPU's here) the plain
    forward and backward still compute in fp32, as the JAX oracle does at
    HIGHEST precision: equal to their results outside autocast to 1e-6."""
    c = _case(96, seed=4)
    args = [_t(c[x]) for x in ("q", "k", "v", "coords3", "slopes",
                               "key_mask")]
    out, lse = alibi_attention_reference(*args)
    grads = alibi_attention_backward_reference(*args, out, lse,
                                               _t(c["cot"]))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        auto = alibi_attention_reference(*args)
        auto_grads = alibi_attention_backward_reference(*args, out, lse,
                                                        _t(c["cot"]))
    for name, got, want in zip(("out", "lse", "dq", "dk", "dv"),
                               (*auto, *auto_grads), (out, lse, *grads)):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("all_heads", [False, True])
def test_alibi_cls_only_row(all_heads):
    """(b) a batch row whose keys are all masked but the cls token: every
    query attends to cls alone, so out is v[cls]; gradients match JAX's
    interpret-mode kernel at 1e-4."""
    c = _case(128, seed=3, cls_only_row=True)
    out = alibi_flash_attention(_t(c["q"]), _t(c["k"]), _t(c["v"]),
                                _t(c["coords3"]), _t(c["slopes"]),
                                key_mask=_t(c["key_mask"])).numpy()
    np.testing.assert_allclose(
        out[0], np.broadcast_to(c["v"][0, :, :1], out[0].shape), atol=1e-6)
    np.testing.assert_allclose(out, _jax_out(c, all_heads=all_heads,
                                             **INTERPRET),
                               atol=OUT_TOL, rtol=OUT_TOL)
    got = _port_grads(c, lambda *a: alibi_flash_attention(*a[:5],
                                                          key_mask=a[5]))
    want = _jax_grads(c, all_heads=all_heads, **INTERPRET)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    # one key: the softmax is constant, dq is zero up to fp32 rounding
    assert np.abs(got[0][0]).max() <= 1e-6


def test_alibi_fully_masked_row():
    """A batch row without a valid key: out 0, lse NEG_INF, zero and
    finite gradients, as JAX's oracle gives out 0."""
    c = _case(40, d=16, seed=4)
    c["key_mask"][1] = False
    args = [_t(c[x]) for x in ("q", "k", "v", "coords3", "slopes",
                               "key_mask")]
    out, lse = alibi_attention_reference(*args)
    assert torch.all(out[1] == 0) and torch.all(lse[1] == NEG_INF)
    want = np.asarray(j_reference(*(jnp.asarray(c[x]) for x in (
        "q", "k", "v", "coords3", "slopes", "key_mask"))))
    np.testing.assert_allclose(out.numpy(), want, atol=OUT_TOL)
    grads = alibi_attention_backward_reference(
        *args, out, lse, _t(c["cot"]))
    for g in grads:
        assert torch.isfinite(g).all() and torch.all(g[1] == 0)


def test_alibi_wrapper_rejects_what_the_kernel_does_not_take():
    from modaltune_tpu_torch.ops.alibi_flash import _check
    c = _case(20, d=16)
    q, k, v, co, sl, km = (_t(c[x]) for x in ("q", "k", "v", "coords3",
                                              "slopes", "key_mask"))
    _check(q, k, v, co, sl, km)
    with pytest.raises(ValueError, match="one .B, H, N, D. shape"):
        _check(q, k[:, :, :10], v, co, sl, km)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check(q.double(), k.double(), v.double(), co, sl, km)
    with pytest.raises(ValueError, match="contiguous"):
        _check(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, co, sl,
               km)
    with pytest.raises(ValueError, match="coords3"):
        _check(q, k, v, co[:, :, :2].contiguous(), sl, km)
    with pytest.raises(ValueError, match="slopes"):
        _check(q, k, v, co, sl[:2], km)
    with pytest.raises(ValueError, match="key_mask"):
        _check(q, k, v, co, sl, km.float())
    with pytest.raises(ValueError, match="unsupported device"):
        alibi_flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), co,
                              sl, km)


# ---------------------------------------------------------------------------
# (c) the numpy and dense helpers of models/titan.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [None, 16, 200])
def test_grid_scatter_bag_equals_jax(bucket):
    rng = np.random.RandomState(5)
    feats = rng.randn(120, 8).astype(np.float32)
    coords = (rng.randint(0, 12, (120, 2)) * 1024 + 37).astype(np.float64)
    got = grid_scatter_bag(feats, coords, 1024, bucket)
    want = j_grid_scatter(feats, coords, 1024, bucket)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("h", [4, 12])
def test_alibi_slopes_and_bias_equal_jax(h):
    assert np.array_equal(alibi_slopes(h), j_alibi_slopes(h))
    rng = np.random.RandomState(6)
    gc = rng.randint(0, 30, (2, 17, 2)).astype(np.float32)
    valid = rng.rand(2, 17) > 0.3
    for vd in (None, valid):
        got = alibi_bias(_t(gc), h, None if vd is None else _t(vd))
        want = np.asarray(j_alibi_bias(
            jnp.asarray(gc), h, None if vd is None else jnp.asarray(vd)))
        assert got.shape == (2, h, 18, 18) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_plain_version_equals_dense_bias_softmax():
    """The plain version == softmax with the dense ``alibi_bias`` tensor
    (same masking and cls conventions), which the library-call timing on
    the card relies on."""
    c = _case(24, d=16, seed=7)
    q, k, v = (_t(c[x]) for x in ("q", "k", "v"))
    got, _ = alibi_attention_reference(q, k, v, _t(c["coords3"]),
                                       _t(c["slopes"]), _t(c["key_mask"]))
    bias = alibi_bias(_t(c["gc"]), 4, _t(c["key_mask"][:, 1:]))
    want = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=OUT_TOL,
                               rtol=OUT_TOL)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch and the port only
    inside its functions)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fault", ["none", "no_alibi_term", "slopes_shifted",
                                   "slopes_10_percent_off"])
def test_gradient_gate_tells_a_fault_from_bf16_rounding(fault):
    """The gate the card holds the bf16 K4b to (``chip_smoke.check_grads``:
    per tensor rel-L2 <= 1e-2 and row-scaled max|err| <= 2e-2) passes the
    exact gradients rounded to bf16, and fails a backward that drops the
    ALiBi term, takes another head's slope, or has every slope 10 % off.
    The gradients' largest element, the cls key's dk/dv, plays no part."""
    cs = _chip_smoke()
    q, k, v, dout, coords3, slopes, key_mask = cs.k4_inputs(
        2, 4, 512, 64, torch.bfloat16, "cpu", seed=500)

    def backward(sl):
        out, lse = alibi_attention_reference(q, k, v, coords3, sl, key_mask)
        return alibi_attention_backward_reference(
            q.float(), k.float(), v.float(), coords3, sl, key_mask,
            out.float(), lse, dout.float())

    want = backward(slopes)
    got = {"none": lambda: [w.bfloat16() for w in want],
           "no_alibi_term": lambda: backward(slopes * 0),
           "slopes_shifted": lambda: backward(slopes.roll(1)),
           "slopes_10_percent_off": lambda: backward(slopes * 1.1)}[fault]()
    # batch row 1: the ordinary row (row 0 keeps the cls key alone)
    args = (("dq", "dk", "dv"), [g[1:] for g in got], [w[1:] for w in want],
            dout[1:], "bfloat16", fault)
    if fault == "none":
        rel, row = cs.check_grads(*args)
        assert rel <= 2e-3 and row <= 2 ** -8 + 1e-6
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.check_grads(*args)


# ---------------------------------------------------------------------------
# (d) the Hopper kernels' algorithm, step by step in plain PyTorch
# ---------------------------------------------------------------------------
# The bf16 kernels at D = 64 (csrc/attention_wgmma.cuh) cannot run here. What
# they do beyond the plain version is emulated below from the wrapper's own
# side inputs: the live 64-key tiles visited in ascending order, one
# distance tile per (query rows, key tile) reused by a group of G heads,
# scores in log2 units with the scale, the slopes and log2(e) folded, an
# online softmax whose P is rounded to bf16 before the second product, and a
# backward in two passes (dq over the live key tiles; dk/dv per own key tile
# over every query tile) whose P and dS are rounded to bf16.

from modaltune_tpu_torch.ops import alibi_flash as af  # noqa: E402

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _round(x, on):
    return x.bfloat16().float() if on else x


def _pad_rows(x, n_pad):
    """(.., N, D) -> (.., NP, D), zero rows past N as the tile copy fills
    them."""
    out = x.new_zeros((*x.shape[:-2], n_pad, x.shape[-1]))
    out[..., :x.shape[-2], :] = x
    return out


def _distance_tile(planes_b, rows, cols, counter):
    """dist * not_cls of the token ranges ``rows`` x ``cols`` of one batch
    row's lane-major planes; counts how often a tile is computed."""
    counter[0] += 1
    y, x, is_cls = planes_b
    d = torch.sqrt((y[rows, None] - y[None, cols]) ** 2
                   + (x[rows, None] - x[None, cols]) ** 2)
    return d * ((1 - is_cls)[rows, None] * (1 - is_cls)[None, cols])


def emulate_forward(q, k, v, coords3, slopes, key_mask, group, rounding):
    """K4f on the Hopper frame, one (batch row, head group) at a time."""
    b, h, n, d = q.shape
    scale2 = d ** -0.5 * LOG2E
    planes = af.lane_major_coords(coords3)
    valid = af.padded_key_mask(key_mask, b, n, q.device)
    tile_live = af.live_key_tiles(valid)
    key_add = af.key_terms(valid)
    n_pad = planes.shape[-1]
    qp, kp, vp = (_pad_rows(_round(t.float(), rounding), n_pad)
                  for t in (q, k, v))
    out = torch.zeros(b, h, n_pad, d)
    lse = torch.zeros(b, h, n_pad)
    tiles = [0]
    every = slice(0, n_pad)
    for bi in range(b):
        for h0 in range(0, h, group):
            heads = range(h0, min(h0 + group, h))
            m = {g: torch.full((n_pad,), NEG_INF) for g in heads}
            l = {g: torch.zeros(n_pad) for g in heads}
            o = {g: torch.zeros(n_pad, d) for g in heads}
            for kt in range(n_pad // af.TILE):
                if not tile_live[bi, kt]:
                    continue                   # never loaded
                cols = slice(kt * af.TILE, kt * af.TILE + af.TILE)
                dnc = _distance_tile(planes[bi], every, cols, tiles)
                for g in heads:
                    s = (qp[bi, g] @ kp[bi, g, cols].T) * scale2 \
                        + (-slopes[g] * LOG2E) * dnc + key_add[bi, cols]
                    m_new = torch.maximum(m[g], s.amax(dim=-1))
                    c_old = torch.exp2(m[g] - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l[g] = l[g] * c_old + p.sum(dim=-1)
                    o[g] = o[g] * c_old[:, None] \
                        + _round(p, rounding) @ vp[bi, g, cols]
                    m[g] = m_new
            for g in heads:
                live = l[g] > 0
                out[bi, g] = o[g] * torch.where(live, 1 / l[g], 0.0)[:, None]
                lse[bi, g] = torch.where(
                    live, (m[g] + torch.log2(l[g])) * LN2, NEG_INF)
    # one distance tile per live key tile and head group
    assert tiles[0] == int(tile_live.sum()) * -(-h // group)
    return _round(out[:, :, :n], rounding), lse[:, :, :n]


def emulate_backward(q, k, v, coords3, slopes, key_mask, out, lse, dout,
                     group, rounding):
    """K4b on the Hopper frame: the dq pass, then the dk/dv pass."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    scale2 = scale * LOG2E
    planes = af.lane_major_coords(coords3)
    valid = af.padded_key_mask(key_mask, b, n, q.device)
    tile_live = af.live_key_tiles(valid)
    key_add = af.key_terms(valid)
    delta = (dout.float() * out.float()).sum(dim=-1)
    lse2, delta_p = af.backward_rows(lse, delta)
    n_pad = planes.shape[-1]
    qp, kp, vp, dop = (_pad_rows(_round(t.float(), rounding), n_pad)
                       for t in (q, k, v, dout))
    dq, dk, dv = (torch.zeros(b, h, n_pad, d) for _ in range(3))
    tiles = [0]
    every = slice(0, n_pad)

    def p_of(bi, g, rows, cols, dnc):
        s = (qp[bi, g, rows] @ kp[bi, g, cols].T) * scale2 \
            + (-slopes[g] * LOG2E) * dnc + key_add[bi, cols]
        return torch.exp2(s - lse2[bi, g, rows, None])

    for bi in range(b):
        for h0 in range(0, h, group):          # dq: live key tiles, G heads
            for kt in range(n_pad // af.TILE):
                if not tile_live[bi, kt]:
                    continue
                cols = slice(kt * af.TILE, kt * af.TILE + af.TILE)
                dnc = _distance_tile(planes[bi], every, cols, tiles)
                for g in range(h0, min(h0 + group, h)):
                    p = p_of(bi, g, every, cols, dnc)
                    dp = dop[bi, g] @ vp[bi, g, cols].T
                    ds = p * (dp - delta_p[bi, g, :, None])
                    dq[bi, g] += _round(ds, rounding) @ kp[bi, g, cols]
        for kt in range(n_pad // af.TILE):     # dk/dv: own key tile, 1 head
            if not tile_live[bi, kt]:
                continue                       # the block writes zeros
            cols = slice(kt * af.TILE, kt * af.TILE + af.TILE)
            for g in range(h):
                for qt in range(n_pad // af.TILE):
                    rows = slice(qt * af.TILE, qt * af.TILE + af.TILE)
                    dnc = _distance_tile(planes[bi], rows, cols, [0])
                    p = p_of(bi, g, rows, cols, dnc)
                    dp = dop[bi, g, rows] @ vp[bi, g, cols].T
                    ds = p * (dp - delta_p[bi, g, rows, None])
                    dv[bi, g, cols] += _round(p, rounding).T @ dop[bi, g, rows]
                    dk[bi, g, cols] += _round(ds, rounding).T @ qp[bi, g, rows]
    return tuple(_round(t[:, :, :n], rounding)
                 for t in (dq * scale, dk * scale, dv))


def _mask_layout(c, layout):
    """Key-mask layouts on top of ``_case``'s tail mask."""
    km = c["key_mask"]
    n = km.shape[1]
    if layout == "dead_between":      # a dead tile and a ragged one inside
        km[:, 64:128] = False
        km[:, 130:150] = False
    elif layout == "cls_only":
        km[0, 1:] = False
    elif layout == "fully_masked":
        km[1] = False
    elif layout == "single_key_tile":
        km[:, 64:] = False
        km[:, min(n - 1, 100)] = True
    return c


def _hold_emulation(c, group, rounding, jax_too=False):
    """Forward and backward emulation against the plain versions (and
    JAX's Pallas kernels in interpret mode): fp32 at 1e-5 / 1e-4 with the
    rounding off, at the card's bf16 limits with it on."""
    cs = _chip_smoke()
    args = [_t(c[x]) for x in ("q", "k", "v", "coords3", "slopes",
                               "key_mask")]
    if rounding:
        args[:3] = [a.bfloat16().float() for a in args[:3]]
    cot = _t(c["cot"]) * args[5][:, None, :, None]
    cot = cot.bfloat16().float() if rounding else cot
    want_o, want_l = alibi_attention_reference(*args)
    got_o, got_l = emulate_forward(*args, group, rounding)
    out_tol, lse_tol = (1.6e-2, 1e-2) if rounding else (OUT_TOL, OUT_TOL)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=out_tol,
                               rtol=out_tol)
    np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), atol=lse_tol,
                               rtol=lse_tol)
    # the backward starts from the forward's own out and lse, as on the card
    want = alibi_attention_backward_reference(*args, got_o, got_l, cot)
    got = emulate_backward(*args, got_o, got_l, cot, group, rounding)
    dead = ~args[5]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if rounding:
            rel, row = cs.grad_readings(g, w, cot)
            lim = cs.GRAD_LIMITS["bfloat16"]
            assert rel <= lim[0] and row <= lim[1], (name, rel, row)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=name)
        if name != "dq":    # masked keys: exactly zero
            assert torch.all(g.transpose(1, 2)[dead] == 0)
    if jax_too:
        m = c["key_mask"][:, None, :, None]
        np.testing.assert_allclose(got_o.numpy() * m,
                                   _jax_out(c, **INTERPRET) * m,
                                   atol=OUT_TOL, rtol=OUT_TOL)
        for name, g, w in zip(("dq", "dk", "dv"), got,
                              _jax_grads(c, **INTERPRET)):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=name)
    return got_o, got_l, got


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("h,group", [(3, 2), (12, 5)])
@pytest.mark.parametrize("n", [6, 70, 200, 257])
def test_hopper_emulation_matches_plain(n, h, group, rounding):
    """Every N off a tile edge, head groups that do not divide H, a tail
    mask."""
    c = _case(n, b=2, h=h, seed=10 + n, masked=min(6, n // 2))
    _hold_emulation(c, group, rounding)


@pytest.mark.parametrize("n", [70, 200])
def test_hopper_emulation_matches_jax_interpret(n):
    """The fp32 emulation against JAX's Pallas kernels in interpret mode,
    out and gradients."""
    c = _case(n, b=2, h=3, seed=20 + n)
    _hold_emulation(c, 2, False, jax_too=True)


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("layout", ["dead_between", "cls_only",
                                    "fully_masked", "single_key_tile"])
def test_hopper_emulation_mask_layouts(layout, rounding):
    """Dead tiles between live ones, a row that keeps the cls key alone, a
    row without a valid key, one valid key in a far tile."""
    c = _mask_layout(_case(200, b=2, h=3, seed=30), layout)
    out, lse, grads = _hold_emulation(c, 2, rounding)
    v = _t(c["v"])
    v = v.bfloat16().float() if rounding else v
    if layout == "cls_only":
        assert torch.equal(out[0], v[0, :, :1].expand_as(out[0]))
    if layout == "fully_masked":
        assert torch.all(out[1] == 0) and torch.all(lse[1] == NEG_INF)
        assert all(torch.all(g[1] == 0) for g in grads)


def test_live_key_tiles_and_side_inputs():
    """The wrapper's helpers: shapes, dtypes, one valid key keeps a tile
    live, a row without one has none."""
    km = torch.zeros(3, 200, dtype=torch.bool)
    km[0, :70] = True               # tiles 0, 1
    km[0, 199] = True               # the ragged last tile, one key
    km[1, 129] = True               # tile 2 alone
    valid = af.padded_key_mask(km, 3, 200, "cpu")
    assert valid.shape == (3, 256) and valid.dtype == torch.bool
    assert not valid[:, 200:].any() and torch.equal(valid[:, :200], km)
    tile_live = af.live_key_tiles(valid)
    assert tile_live.shape == (3, 4) and tile_live.dtype == torch.int32
    assert tile_live.is_contiguous()
    assert tile_live.tolist() == [[1, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 0]]
    add = af.key_terms(valid)
    assert add.dtype == torch.float32 and add.shape == (3, 256)
    assert add.is_contiguous()
    assert torch.all(add[valid] == 0) and torch.all(add[~valid] == -torch.inf)
    # no mask: every key up to N is valid, the padding is not
    every = af.padded_key_mask(None, 2, 70, "cpu")
    assert every[:, :70].all() and not every[:, 70:].any()
    assert af.live_key_tiles(every).tolist() == [[1, 1], [1, 1]]
    assert af.key_terms(every).is_contiguous()
    # N on a tile edge: nothing is padded
    assert af.padded_key_mask(km[:, :128], 3, 128, "cpu").shape == (3, 128)
    side = af.wgmma_side_inputs(torch.zeros(3, 200, 3), km, 3, 200)
    assert [tuple(t.shape) for t in side] == [(3, 3, 256), (3, 256), (3, 4)]
    assert [t.dtype for t in side] == [torch.float32, torch.float32,
                                       torch.int32]
    assert all(t.is_contiguous() for t in side)


def test_side_inputs_take_a_strided_key_mask():
    """A key mask that is a view (here N on a tile edge, so nothing is
    copied for padding) gives the side inputs of its contiguous copy."""
    km = torch.rand(128, 3, generator=torch.Generator().manual_seed(3)) < 0.5
    km[:64, 1] = False              # a dead tile in batch row 1
    strided = km.t()
    assert not strided.is_contiguous()
    got = af.wgmma_side_inputs(torch.zeros(3, 128, 3), strided, 3, 128)
    want = af.wgmma_side_inputs(torch.zeros(3, 128, 3), strided.contiguous(),
                                3, 128)
    assert all(torch.equal(g, w) and g.is_contiguous()
               for g, w in zip(got, want))
    assert got[2][1].tolist() == [0, 1]


def test_lane_major_coords_and_backward_rows():
    c = _case(70, b=2, h=3)
    planes = af.lane_major_coords(_t(c["coords3"]))
    assert planes.shape == (2, 3, 128) and planes.dtype == torch.float32
    assert planes.is_contiguous() and torch.all(planes[:, :, 70:] == 0)
    np.testing.assert_array_equal(planes[:, 0, :70], c["coords3"][..., 0])
    np.testing.assert_array_equal(planes[:, 1, :70], c["coords3"][..., 1])
    np.testing.assert_array_equal(planes[:, 2, :70], c["coords3"][..., 2])
    assert af.lane_major_coords(torch.zeros(1, 128, 3)).shape == (1, 3, 128)
    lse = torch.randn(2, 3, 70)
    lse[1, :, 5] = NEG_INF
    lse2, delta = af.backward_rows(lse, torch.ones(2, 3, 70))
    assert lse2.shape == delta.shape == (2, 3, 128)
    assert torch.all(lse2[..., 70:] >= 1e29)
    assert torch.all(lse2[1, :, 5] >= 1e29)
    assert torch.all(delta[..., 70:] == 0) and torch.all(delta[..., :70] == 1)
    assert lse2.is_contiguous() and delta.is_contiguous()
    np.testing.assert_allclose(lse2[0, :, :70], lse[0] * LOG2E, rtol=1e-6)


def test_uses_wgmma_only_for_bf16_at_64():
    """The family rule's CPU copy: the wgmma family for bf16 at D = 64
    alone (fp32 there takes the 3xTF32 family, every other D the CUDA
    cores)."""
    for dtype, d, want in ((torch.bfloat16, 64, "wgmma"),
                           (torch.float32, 64, "tf32x3"),
                           (torch.bfloat16, 48, "cuda_cores"),
                           (torch.bfloat16, 128, "cuda_cores"),
                           (torch.float32, 48, "cuda_cores")):
        assert af.family(torch.zeros(1, 1, 2, d, dtype=dtype)) == want
