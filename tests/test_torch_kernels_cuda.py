"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips (inside the ``cuda_device`` fixture)
where there is no CUDA device, as on a CPU-only machine. Run them on the
GPU with (the JAX package's ``tests/conftest.py`` imports jax, which a
GPU machine for the port need not have)

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

These cover the edge cases that the full-size shapes of ``chip_smoke.py``
do not: ragged tile edges, head dimensions that pad, segments shorter
than a query tile, head groups without heads, a missing mask, a row whose
keys are all masked, and the wrappers raising on what the kernels do not
take; for the forward kernels (K1f, K2f) and the backward ones (K1b, K2b),
and for K1f's statistics.
"""

import importlib

import pytest
import torch

from modaltune_tpu_torch.ops import NEG_INF
from modaltune_tpu_torch.ops.dilated import (_branches, dilated_attention,
                                             dilated_attention_stats)

fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")

pytestmark = pytest.mark.cuda

# fp32 kernel against the fp32 plain version: the sums run in another
# order (online softmax, fp32 FMA) — a few ulp of the output scale.
TOL = 2e-5
# Gradients sum P*dS over up to a thousand keys per row in another order:
# relative to the largest gradient of the tensor.
GRAD_TOL = 5e-5


def _assert_grad_close(got, want, what):
    assert torch.isfinite(got).all(), what
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    assert err <= GRAD_TOL * scale, f"{what}: max|err| {err:.3e}, scale {scale:.3g}"


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _randn(shape, seed, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


@pytest.mark.parametrize("bh,lq,lk,d,masked", [
    (1, 1, 1, 16, False),
    (2, 63, 64, 7, False),
    (2, 65, 129, 33, True),
    (3, 130, 65, 100, True),
    (1, 200, 300, 128, True),
    (4, 17, 1000, 48, True),
])
def test_flash_kernel_matches_plain(cuda_device, bh, lq, lk, d, masked):
    q = _randn((bh, lq, d), 1, cuda_device)
    k = _randn((bh, lk, d), 2, cuda_device)
    v = _randn((bh, lk, d), 3, cuda_device)
    bias = None
    if masked:
        g = torch.Generator().manual_seed(4)
        valid = torch.rand(bh, lk, generator=g) > 0.3
        valid[-1] = False                  # one bh with every key masked
        bias = torch.where(valid, 0.0, NEG_INF).to(cuda_device)
    got_o, got_l = fa.flash_attention(q, k, v, bias, scale=0.3)
    want_o, want_l = fa.flash_attention_reference(q, k, v, bias, scale=0.3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_o, want_o, atol=TOL, rtol=TOL)
    torch.testing.assert_close(got_l, want_l, atol=TOL, rtol=TOL)
    if masked:
        assert (got_o[-1] == 0).all() and (got_l[-1] == NEG_INF).all()


@pytest.mark.parametrize("b,length,h,d,segs,ratios,masked", [
    (2, 300, 4, 8, (16, 40, 100), (1, 2, 4), True),    # segments < a tile
    (1, 256, 4, 24, (64, 128), (1, 8), False),         # groups without heads
    (2, 333, 6, 72, (90, 333), (1, 3), True),          # H % r == 0, odd L
    (1, 5, 2, 128, (4,), (1,), True),
    (2, 1000, 16, 48, (96, 579, 1000), (1, 2, 16), True),
])
def test_dilated_kernel_matches_plain(cuda_device, b, length, h, d, segs,
                                      ratios, masked):
    q, k, v = (_randn((b, length, h, d), s, cuda_device) for s in (5, 6, 7))
    mask = None
    if masked:
        lens = torch.tensor([length, max(1, length * 2 // 3)])[:b]
        mask = (torch.arange(length)[None, :] < lens[:, None]).to(cuda_device)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    got = dm.mega_dilated_attention(q, k, v, **kw)
    want = dilated_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    valid = (torch.ones(b, length, dtype=torch.bool, device=cuda_device)
             if mask is None else mask)[:, :, None, None]
    torch.testing.assert_close(got * valid, want * valid, atol=TOL, rtol=TOL)


FLASH_BWD_CASES = [
    (1, 1, 1, 16, False),
    (2, 63, 64, 7, False),
    (2, 65, 129, 33, True),
    (3, 130, 65, 100, True),
    (1, 200, 300, 128, True),
    (4, 17, 1000, 48, True),
    (3, 300, 65, 16, True),       # Injector-style
    (3, 65, 700, 16, True),       # Extractor-style
]


@pytest.mark.parametrize("bh,lq,lk,d,masked", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda_device, bh, lq, lk, d,
                                             masked):
    q = _randn((bh, lq, d), 11, cuda_device)
    k = _randn((bh, lk, d), 12, cuda_device)
    v = _randn((bh, lk, d), 13, cuda_device)
    dout = _randn((bh, lq, d), 14, cuda_device)
    bias = None
    if masked:
        g = torch.Generator().manual_seed(15)
        valid = torch.rand(bh, lk, generator=g) > 0.3
        valid[-1] = False                  # one bh with every key masked
        bias = torch.where(valid, 0.0, NEG_INF).to(cuda_device)
    out, lse = fa.flash_attention_reference(q, k, v, bias, scale=0.3)
    got = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout, 0.3)
    want = fa.flash_attention_backward_reference(q, k, v, bias, out, lse,
                                                 dout, scale=0.3)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        _assert_grad_close(g_, w_, name)
        if masked:
            assert (g_[-1] == 0).all(), f"{name} of the dead bh"
    if masked:
        dead = ~valid.to(cuda_device)
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()


def test_flash_function_runs_both_kernels(cuda_device):
    q, k, v = (_randn((2, 40, 16), s, cuda_device).requires_grad_()
               for s in (16, 17, 18))
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    out, lse = fa.flash_attention(q, k, v)
    assert not lse.requires_grad
    out.sum().backward()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (1, 1)
    want = fa.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), None, out.detach(), lse,
        torch.ones_like(out))
    for x, w_ in zip((q, k, v), want):
        _assert_grad_close(x.grad, w_, "grad")


DILATED_CASES = [
    (2, 300, 4, 8, (16, 40, 100), (1, 2, 4), True),    # segments < a tile
    (1, 256, 4, 24, (64, 128), (1, 8), False),         # groups without heads
    (2, 333, 6, 72, (90, 333), (1, 3), True),          # H % r == 0, odd L
    (1, 5, 2, 128, (4,), (1,), True),
    (2, 1000, 16, 48, (96, 579, 1000), (1, 2, 16), True),
]


def _dilated_inputs(b, length, h, d, masked, device):
    q, k, v, dmix = (_randn((b, length, h, d), s, device) for s in (5, 6, 7, 8))
    mask = None
    if masked:
        lens = torch.tensor([length, max(1, length * 2 // 3)])[:b]
        mask = (torch.arange(length)[None, :] < lens[:, None]).to(device)
    valid = (torch.ones(b, length, dtype=torch.bool, device=device)
             if mask is None else mask)[:, :, None, None]
    return q, k, v, dmix * valid, mask, valid


@pytest.mark.parametrize("b,length,h,d,segs,ratios,masked", DILATED_CASES)
def test_dilated_stats_match_plain(cuda_device, b, length, h, d, segs, ratios,
                                   masked):
    q, k, v, _, mask, valid = _dilated_inputs(b, length, h, d, masked,
                                              cuda_device)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    out, stats, branch_out = dm.mega_dilated_attention_cuda(
        q, k, v, mask, segs, ratios, d ** -0.5, with_stats=True)
    want = dilated_attention_stats(q, k, v, **kw)
    outs, _ = _branches(q, k, v, mask, segs, ratios, None)
    torch.cuda.synchronize()
    torch.testing.assert_close(stats, want, atol=TOL, rtol=TOL)
    assert ((stats == NEG_INF) == (want == NEG_INF)).all()
    for i, o in enumerate(outs):
        torch.testing.assert_close(branch_out[i] * valid, o * valid,
                                   atol=TOL, rtol=TOL)
    # the training variant mixes to the same output
    torch.testing.assert_close(
        out * valid, dilated_attention(q, k, v, **kw) * valid,
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,length,h,d,segs,ratios,masked", DILATED_CASES)
def test_dilated_backward_kernel_matches_autograd(cuda_device, b, length, h,
                                                  d, segs, ratios, masked):
    q, k, v, dmix, mask, valid = _dilated_inputs(b, length, h, d, masked,
                                                 cuda_device)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (dilated_attention(*leaves, **kw) * dmix).sum().backward()
    _, stats, branch_out = dm.mega_dilated_attention_cuda(
        q, k, v, mask, segs, ratios, d ** -0.5, with_stats=True)
    got = dm.mega_dilated_attention_backward_cuda(
        q, k, v, mask, dmix, stats, branch_out, segs, ratios, d ** -0.5)
    torch.cuda.synchronize()
    for name, g_, x in zip(("dq", "dk", "dv"), got, leaves):
        _assert_grad_close(g_ * valid, x.grad * valid, name)
        if masked and name != "dq":
            assert (g_ * ~valid == 0).all(), f"{name} of masked keys"


def test_dilated_function_runs_both_kernels(cuda_device):
    q, k, v = (_randn((2, 128, 4, 16), s, cuda_device).requires_grad_()
               for s in (19, 20, 21))
    kw = dict(segment_lengths=(32, 128), dilated_ratios=(1, 2))
    dm.LAUNCHES = dm.BWD_LAUNCHES = 0
    dm.mega_dilated_attention(q, k, v, **kw).sum().backward()
    assert (dm.LAUNCHES, dm.BWD_LAUNCHES) == (1, 1)
    with torch.no_grad():               # no gradient wanted: no stats
        dm.mega_dilated_attention(q, k, v, **kw)
    assert (dm.LAUNCHES, dm.BWD_LAUNCHES) == (2, 1)


def test_kernels_count_their_launches(cuda_device):
    q = _randn((2, 64, 4, 16), 8, cuda_device)
    fa.LAUNCHES = 0
    dm.LAUNCHES = 0
    dm.mega_dilated_attention(q, q, q, segment_lengths=(32,),
                              dilated_ratios=(1,))
    fa.flash_attention(q[0], q[0], q[0])
    assert (dm.LAUNCHES, fa.LAUNCHES) == (1, 1)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    x = _randn((2, 16, 16), 9, cuda_device, torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(x, x, x)
    y = _randn((2, 16, 4, 16), 9, cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        dm.mega_dilated_attention(y, y, y, segment_lengths=(8,),
                                  dilated_ratios=(1,))
    z = _randn((1, 16, 4, 136), 9, cuda_device)        # D > 128
    with pytest.raises(ValueError):
        dm.mega_dilated_attention(z, z, z, segment_lengths=(8,),
                                  dilated_ratios=(1,))
    w = _randn((1, 16, 4, 16), 9, cuda_device)
    _, stats, bo = dm.mega_dilated_attention_cuda(w, w, w, None, (8,), (1,),
                                                  0.25, with_stats=True)
    with pytest.raises(ValueError):                    # dmix in another dtype
        dm.mega_dilated_attention_backward_cuda(
            w, w, w, None, w.bfloat16(), stats, bo, (8,), (1,), 0.25)
    with pytest.raises(ValueError):                    # stats of other branches
        dm.mega_dilated_attention_backward_cuda(
            w, w, w, None, w, stats, bo, (8, 16), (1, 2), 0.25)
