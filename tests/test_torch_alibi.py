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

# One thread: with two, the first vectorised sqrt after a process's first
# GEMM was seen to come back at reduced accuracy (relative 2e-4) in one
# thread's share of the elements on some CPU builds of torch (MKL 2024.2),
# which the 1e-5 gate below then reads as a fault of the plain version.
torch.set_num_threads(1)

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
