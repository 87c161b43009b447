"""The port's fused GELU -> LayerNorm (``modaltune_tpu_torch/ops/gelu_ln.py``)
against the JAX package's (``modaltune_tpu/ops/gelu_ln.py``), on the CPU.

The same numpy inputs, made from a seed, go through both. The JAX side runs
its plain composition ``gelu_ln_ref`` and its Pallas kernel in interpret
mode; the port, on CPU tensors, runs its plain versions
(``gelu_ln_reference``, ``gelu_ln_backward_reference``), which are the
oracles of the CUDA kernels K5f and K5b. Tolerances are stated per test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the functions of the same name their packages export
jgl = importlib.import_module("modaltune_tpu.ops.gelu_ln")
tgl = importlib.import_module("modaltune_tpu_torch.ops.gelu_ln")

EPS = 1e-5
# fp32: two frameworks' erf and row sums differ in the last bits; bf16: one
# ulp (2^-8 relative) of a result of a few units where the fp32 values
# straddle a rounding boundary. The limits of tests/test_gelu_ln.py.
FWD_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
# (atol, rtol) of dx, dgamma, dbeta as tests/test_gelu_ln.py:65-67 holds the
# Pallas kernel to the unfused chain: dx is elementwise, dgamma and dbeta
# are sums over the rows in another order.
BWD_TOL = {"float32": ((1e-5, 1e-5), (2e-3, 1e-3), (2e-3, 1e-3)),
           "bfloat16": ((3e-2, 2e-2), (2e-1, 2e-2), (2e-1, 2e-2))}

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed=0):
    """x (*shape), cotangent, scale and bias (F,) as fp32 numpy arrays."""
    rng = np.random.RandomState(seed)
    f = shape[-1]
    return ((rng.randn(*shape) * 2.0).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            (rng.rand(f) + 0.5).astype(np.float32),
            (rng.randn(f) * 0.1).astype(np.float32))


def _to_torch(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(TORCH[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("via", ["ref", "pallas"])
def test_forward_matches_jax(dtype, via):
    """``gelu_ln_reference`` vs ``gelu_ln_ref`` and vs the Pallas kernel in
    interpret mode, (2, 48, 512): fp32 <= 1e-6, bf16 <= 2e-2."""
    x, _, s, b = _inputs((2, 48, 512))
    xj = jnp.asarray(x, JNP[dtype])
    if via == "ref":
        want = jgl.gelu_ln_ref(xj, jnp.asarray(s), jnp.asarray(b), eps=EPS)
    else:
        assert jgl.gelu_ln_eligible(96, 512)
        want = jgl.gelu_ln(xj, jnp.asarray(s), jnp.asarray(b), eps=EPS,
                           interpret=True)
    got = tgl.gelu_ln_reference(_to_torch(x, dtype), _to_torch(s),
                                _to_torch(b), EPS)
    assert got.dtype == TORCH[dtype] and got.shape == x.shape
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _jax_grads(x, cot, s, b, dtype):
    """jax.grad through the Pallas kernel's VJP (interpret mode)."""
    cj = jnp.asarray(cot, JNP[dtype]).astype(jnp.float32)

    def loss(x, s, b):
        y = jgl.gelu_ln(x, s, b, eps=EPS, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * cj)

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, JNP[dtype]), jnp.asarray(s), jnp.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("via", ["reference", "autograd"])
def test_backward_matches_jax(dtype, via):
    """``gelu_ln_backward_reference``, and autograd through ``gelu_ln``, vs
    ``jax.grad`` through the Pallas VJP, at BWD_TOL."""
    x, cot, s, b = _inputs((2, 48, 512), seed=1)
    want = _jax_grads(x, cot, s, b, dtype)
    xt, ct = _to_torch(x, dtype), _to_torch(cot, dtype)
    if via == "reference":
        got = tgl.gelu_ln_backward_reference(xt, _to_torch(s), ct, EPS)
    else:
        leaves = [xt.requires_grad_(), _to_torch(s).requires_grad_(),
                  _to_torch(b).requires_grad_()]
        got = torch.autograd.grad(tgl.gelu_ln(*leaves, eps=EPS), leaves, ct)
    assert got[0].dtype == TORCH[dtype] and got[1].dtype == torch.float32
    for name, g, w, (atol, rtol) in zip(("dx", "dgamma", "dbeta"), got, want,
                                        BWD_TOL[dtype]):
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 5, 384), (13, 384), (1, 3072), (7, 3)])
def test_shapes_the_tpu_kernel_refuses(shape):
    """Rows not a multiple of 8, F not a multiple of 128, one row: the JAX
    entry falls to ``gelu_ln_ref`` there, the port takes them. fp32, forward
    <= 1e-6; dx <= 1e-5, dgamma and dbeta <= 1e-4 against ``jax.grad``
    through ``gelu_ln_ref``."""
    rows = int(np.prod(shape[:-1]))
    if shape[-1] != 3072:
        assert not jgl.gelu_ln_eligible(rows, shape[-1])
    x, cot, s, b = _inputs(shape, seed=2)
    got = tgl.gelu_ln_reference(_to_torch(x), _to_torch(s), _to_torch(b), EPS)
    want = jgl.gelu_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                       eps=EPS, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)

    def loss(x, s, b):
        return jnp.sum(jgl.gelu_ln_ref(x, s, b, eps=EPS) * jnp.asarray(cot))

    gw = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s),
                                           jnp.asarray(b))
    gg = tgl.gelu_ln_backward_reference(_to_torch(x), _to_torch(s),
                                        _to_torch(cot), EPS)
    for name, g, w, tol in zip(("dx", "dgamma", "dbeta"), gg, gw,
                               (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol,
                                   err_msg=name)


def test_backward_reference_is_the_autograd_of_the_forward():
    """In fp32 (no rounding at the dtype boundary) autograd through
    ``gelu_ln_reference`` gives ``gelu_ln_backward_reference``: dx <= 1e-5,
    dgamma and dbeta <= 1e-4 of their scale."""
    x, cot, s, b = _inputs((40, 256), seed=3)
    leaves = [_to_torch(a).requires_grad_() for a in (x, s, b)]
    want = torch.autograd.grad(tgl.gelu_ln_reference(*leaves, EPS), leaves,
                               _to_torch(cot))
    got = tgl.gelu_ln_backward_reference(leaves[0].detach(),
                                         leaves[1].detach(), _to_torch(cot),
                                         EPS)
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert (g - w).abs().max().item() <= tol * max(
            1.0, w.abs().max().item())


def test_bf16_parameters_and_saved_tensors():
    """gamma and beta in bf16 (the frozen backbone's dtype) give what their
    fp32 copies give, with dgamma and dbeta returned in bf16; the Function
    saves ``x`` and ``scale`` only."""
    x, cot, s, b = _inputs((6, 128), seed=4)
    xt, ct = _to_torch(x, "bfloat16"), _to_torch(cot, "bfloat16")
    sb, bb = _to_torch(s, "bfloat16"), _to_torch(b, "bfloat16")
    got = tgl.gelu_ln_reference(xt, sb, bb, EPS)
    want = tgl.gelu_ln_reference(xt, sb.float(), bb.float(), EPS)
    assert torch.equal(got, want)
    dx, dg, db = tgl.gelu_ln_backward_reference(xt, sb, ct, EPS)
    dx32, dg32, db32 = tgl.gelu_ln_backward_reference(xt, sb.float(), ct, EPS)
    assert dg.dtype == db.dtype == torch.bfloat16
    assert torch.equal(dx, dx32) and torch.equal(dg, dg32.bfloat16()) \
        and torch.equal(db, db32.bfloat16())
    leaves = [xt.requires_grad_(), sb.requires_grad_(), bb.requires_grad_()]
    y = tgl.gelu_ln(*leaves, eps=EPS)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0] is leaves[0] and saved[1] is leaves[1]


def _jax_ffn(monkeypatch, x, fused, deterministic=True):
    """The JAX FeedForwardNetwork on ``x`` and its parameters as numpy;
    ``fused`` sets the JAX package's switch, the Pallas kernel in interpret
    mode."""
    from modaltune_tpu.configs import LongNetConfig
    from modaltune_tpu.models.longnet import FeedForwardNetwork
    monkeypatch.setenv("MODALTUNE_FUSED_GELU_LN", "1" if fused else "0")
    monkeypatch.setenv("MODALTUNE_PALLAS_INTERPRET", "1" if fused else "0")
    cfg = LongNetConfig(embed_dim=256, ffn_dim=512, num_heads=4,
                        num_layers=1, subln=True)
    m = FeedForwardNetwork(cfg, dtype=jnp.float32)
    xj = jnp.asarray(x)
    params = m.init(jax.random.PRNGKey(0), xj)
    rng = np.random.RandomState(5)
    # every parameter random (the init's scale 1 and bias 0 would hide a
    # swapped affine)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1 + (p.ndim == 1),
                              jnp.float32), params)
    return np.asarray(m.apply(params, xj, deterministic=deterministic)), \
        jax.tree_util.tree_map(np.asarray, params["params"])


def _torch_ffn(params, fused_gelu_ln, **cfg_kw):
    from modaltune_tpu_torch.configs import LongNetConfig
    from modaltune_tpu_torch.models.longnet import FeedForwardNetwork
    cfg = LongNetConfig(embed_dim=256, ffn_dim=512, num_heads=4,
                        num_layers=1, subln=True, **cfg_kw)
    with torch.device("cpu"):
        m = FeedForwardNetwork(cfg, fused_gelu_ln=fused_gelu_ln)
    state = {"fc1.weight": params["fc1"]["kernel"].T,
             "fc1.bias": params["fc1"]["bias"],
             "fc2.weight": params["fc2"]["kernel"].T,
             "fc2.bias": params["fc2"]["bias"],
             "ffn_layernorm.weight": params["ffn_layernorm"]["scale"],
             "ffn_layernorm.bias": params["ffn_layernorm"]["bias"]}
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in state.items()}, strict=True)
    return m


def test_ffn_module_fused_route_matches_jax_and_unfused(monkeypatch):
    """The port's FeedForwardNetwork with ``fused_gelu_ln=True`` vs the JAX
    module with ``MODALTUNE_FUSED_GELU_LN=1`` (Pallas in interpret mode),
    and vs the port's own unfused route, from the same parameters and the
    same ``state_dict`` keys: <= 1e-5 (two fp32 matrix products)."""
    x = np.random.RandomState(2).randn(2, 16, 256).astype(np.float32)
    want, params = _jax_ffn(monkeypatch, x, fused=True)
    fused = _torch_ffn(params, True).eval()
    unfused = _torch_ffn(params, False).eval()
    assert fused.fused_gelu_ln and not unfused.fused_gelu_ln
    assert list(fused.state_dict()) == list(unfused.state_dict())
    calls = []
    monkeypatch.setattr("modaltune_tpu_torch.models.longnet.gelu_ln",
                        lambda *a: calls.append(1) or tgl.gelu_ln(*a))
    xt = torch.from_numpy(x)
    got, plain = fused(xt), unfused(xt)
    assert len(calls) == 1              # the fused op ran, once, in `fused`
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(plain), atol=1e-5, rtol=1e-5)


def test_ffn_route_follows_the_environment_at_construction(monkeypatch):
    """``fused_gelu_ln=None`` reads ``MODALTUNE_FUSED_GELU_LN`` once, when
    the module is built, as the JAX module reads it."""
    from modaltune_tpu_torch.configs import LongNetConfig
    from modaltune_tpu_torch.models.longnet import (FeedForwardNetwork,
                                                    LongNetEncoder)
    cfg = LongNetConfig(embed_dim=64, ffn_dim=128, num_heads=4, num_layers=2,
                        subln=True)
    with torch.device("cpu"):
        monkeypatch.setenv("MODALTUNE_FUSED_GELU_LN", "1")
        on = FeedForwardNetwork(cfg)
        enc = LongNetEncoder(cfg)
        monkeypatch.setenv("MODALTUNE_FUSED_GELU_LN", "0")
        off = FeedForwardNetwork(cfg)
        forced = LongNetEncoder(cfg, fused_gelu_ln=True)
    assert on.fused_gelu_ln and not off.fused_gelu_ln
    assert all(layer.ffn.fused_gelu_ln for layer in enc.layers)
    assert all(layer.ffn.fused_gelu_ln for layer in forced.layers)


def test_ffn_training_with_activation_dropout_takes_the_unfused_chain(
        monkeypatch):
    """With ``activation_dropout > 0`` in training mode the dropout sits
    between the GELU and the LayerNorm, so the fused op does not apply (the
    JAX condition ``activation_dropout == 0 or deterministic``); in eval
    mode, and in training without activation dropout, it does."""
    from modaltune_tpu_torch.models import dropout_generator
    x = np.random.RandomState(6).randn(2, 8, 256).astype(np.float32)
    _, params = _jax_ffn(monkeypatch, x, fused=False)
    calls = []
    monkeypatch.setattr("modaltune_tpu_torch.models.longnet.gelu_ln",
                        lambda *a: calls.append(1) or tgl.gelu_ln(*a))
    xt = torch.from_numpy(x)
    m = _torch_ffn(params, True, activation_dropout=0.5)
    with dropout_generator(torch.Generator().manual_seed(0)):
        m.train()(xt)
    assert calls == []
    m.eval()(xt)
    assert calls == [1]
    with dropout_generator(torch.Generator().manual_seed(0)):
        _torch_ffn(params, True).train()(xt)
    assert calls == [1, 1]
