"""The port's ops (modaltune_tpu_torch.ops) against the JAX package's, on
the CPU: the plain versions of the K2 (flash attention with key bias) and
K1 (multi-branch dilated attention) kernels, and the exact GELU. The same
inputs, made with numpy from a seed, go through both packages in fp32.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds each
against these plain versions on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.ops.dilated import dilated_attention as j_dilated
from modaltune_tpu.ops.flash_attention import \
    flash_attention_reference as j_flash_ref
from modaltune_tpu.ops.activations import gelu_exact as j_gelu
from modaltune_tpu.ops.dilated_mega import \
    mega_dilated_attention as j_mega
from modaltune_tpu_torch.ops import (NEG_INF, dilated_attention,
                                     flash_attention,
                                     flash_attention_reference, gelu_exact,
                                     mega_dilated_attention)

torch.set_num_threads(2)

# Both sides run the same fp32 algorithm on two CPU backends; the only
# differences are summation order and libm rounding.
TOL = 1e-5
DIL_TOL = 2e-5

SEGS = (64, 128, 512, 96)
RATIOS = (1, 2, 4, 2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flash_inputs(seed, bh, lq, lk, d, masked_frac=0.0, dead_row=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, lq, d).astype(np.float32)
    k = rng.randn(bh, lk, d).astype(np.float32)
    v = rng.randn(bh, lk, d).astype(np.float32)
    bias = None
    if masked_frac or dead_row:
        valid = rng.rand(bh, lk) >= masked_frac
        valid[:, 0] = True
        if dead_row:
            valid[0] = False
        bias = np.where(valid, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("bh,lq,lk,d,masked,dead", [
    (3, 33, 57, 16, 0.0, False),
    (2, 300, 65, 16, 0.0, False),       # Injector-style: tall q, short k
    (2, 65, 300, 16, 0.12, False),      # Extractor-style: short q, tall k
    (3, 33, 57, 8, 0.3, True),          # a row with every key masked
    (2, 40, 70, 48, 0.25, False),
])
def test_flash_reference_matches_jax(bh, lq, lk, d, masked, dead):
    q, k, v, bias = _flash_inputs(bh * 7 + lq, bh, lq, lk, d, masked, dead)
    jb = None if bias is None else jnp.asarray(bias)
    want_o, want_l = j_flash_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    tb = None if bias is None else _t(bias)
    got_o, got_l = flash_attention_reference(_t(q), _t(k), _t(v), tb)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=TOL, rtol=TOL)
    if dead:
        assert np.all(got_o.numpy()[0] == 0.0)
        assert np.all(got_l.numpy()[0] == NEG_INF)
    # the dispatching entry point takes the plain version for CPU tensors
    o2, l2 = flash_attention(_t(q), _t(k), _t(v), tb)
    np.testing.assert_array_equal(o2.numpy(), got_o.numpy())
    np.testing.assert_array_equal(l2.numpy(), got_l.numpy())


def _dil_inputs(seed, b, length, h, d, masked):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, length, h, d).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        lens = rng.randint(length // 2, length + 1, size=b)
        mask = np.arange(length)[None, :] < lens[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("length,h,segs,ratios,masked", [
    (256, 4, SEGS, RATIOS, True),
    (256, 4, SEGS, RATIOS, False),
    (300, 4, SEGS, RATIOS, True),       # every branch pads its last segment
    (300, 16, (64, 160, 300), (1, 4, 16), True),   # H = r = 16
])
def test_dilated_matches_jax(length, h, segs, ratios, masked):
    q, k, v, mask = _dil_inputs(length + h, 2, length, h, 8, masked)
    want = jax.jit(functools.partial(
        j_dilated, segment_lengths=segs, dilated_ratios=ratios,
        use_pallas=False))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask=None if mask is None else jnp.asarray(mask))
    tm = None if mask is None else _t(mask)
    got = dilated_attention(_t(q), _t(k), _t(v), segment_lengths=segs,
                            dilated_ratios=ratios, mask=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=DIL_TOL, rtol=DIL_TOL)
    # the dispatching entry point takes the plain version for CPU tensors
    got2 = mega_dilated_attention(_t(q), _t(k), _t(v), segment_lengths=segs,
                                  dilated_ratios=ratios, mask=tm)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_dilated_unmasked_padding_is_masked():
    """With mask=None, dilation slots past a segment's end are excluded:
    the port equals the JAX oracle given an all-valid mask."""
    length, h = 300, 16
    q, k, v, _ = _dil_inputs(5, 1, length, h, 8, False)
    segs, ratios = (300,), (16,)    # 300 % 16 != 0
    want = j_dilated(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_lengths=segs,
        dilated_ratios=ratios, mask=jnp.ones((1, length), bool),
        use_pallas=False)
    got = dilated_attention(_t(q), _t(k), _t(v), segment_lengths=segs,
                            dilated_ratios=ratios)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=DIL_TOL, rtol=DIL_TOL)


def test_dilated_matches_jax_mega_interpret():
    """Against the JAX package's own K1 run as its tests run it on the CPU
    (Pallas interpret mode), shape of tests/test_dilated_mega.py, on the
    valid rows."""
    q, k, v, mask = _dil_inputs(0, 2, 256, 4, 32, True)
    want = j_mega(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  segment_lengths=SEGS, dilated_ratios=RATIOS,
                  mask=jnp.asarray(mask), interpret=True)
    got = mega_dilated_attention(_t(q), _t(k), _t(v), segment_lengths=SEGS,
                                 dilated_ratios=RATIOS, mask=_t(mask))
    m = mask[:, :, None, None]
    np.testing.assert_allclose(got.numpy() * m, np.asarray(want) * m,
                               atol=DIL_TOL, rtol=DIL_TOL)


def test_gelu_exact_matches_jax():
    x = np.random.RandomState(3).randn(64, 96).astype(np.float32) * 3
    want = j_gelu(jnp.asarray(x))
    got = gelu_exact(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)
    xb = _t(x).to(torch.bfloat16)
    assert gelu_exact(xb).dtype == torch.bfloat16


def test_gelu_exact_grad_matches_jax():
    """The lean backward (erf derivative from the saved input, in fp32)
    against JAX's custom VJP, in fp32 and on a bf16 input."""
    rng = np.random.RandomState(4)
    x = rng.randn(64, 96).astype(np.float32) * 3
    cot = rng.randn(64, 96).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(j_gelu(a) * cot))(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    (gelu_exact(tx) * _t(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)
    xb = _t(x).to(torch.bfloat16).requires_grad_()
    (gelu_exact(xb).float() * _t(cot)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    want_b = jax.grad(lambda a: jnp.sum(j_gelu(a).astype(jnp.float32) * cot))(
        jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_allclose(xb.grad.float().numpy(),
                               np.asarray(want_b, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The CUDA-side argument checks run before any launch; exercised here
    on CPU tensors through the checking helpers."""
    import importlib
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    dilated_mega = importlib.import_module(
        "modaltune_tpu_torch.ops.dilated_mega")
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        fa._check(q, torch.zeros(2, 8, 8), torch.zeros(2, 8, 8), None)
    with pytest.raises(TypeError):
        fa._check(q.double(), q.double(), q.double(), None)
    with pytest.raises(ValueError):
        fa._check(q, q, q, torch.zeros(2, 7))
    with pytest.raises(ValueError):
        fa._check(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1),
                  None)
    x = torch.zeros(1, 32, 4, 12)       # D not a multiple of 8
    with pytest.raises(ValueError):
        dilated_mega._check(x, x, x, None, (16,), (1,))
    x = torch.zeros(1, 32, 4, 16)
    with pytest.raises(ValueError):
        dilated_mega._check(x, x, x, torch.ones(1, 32), (16,), (1,))
    with pytest.raises(ValueError):
        dilated_mega._check(x, x, x, None, (16,) * 9, (1,) * 9)
