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
take; for the forward kernels (K1f, K2f, K4f) and the backward ones (K1b,
K2b, K4b), and for K1f's statistics; for the per-branch dilated kernels
(K3f, K3b) the same geometries, a length no segment divides, sixteen heads
at ratio 16, one valid key and a dead batch row, compact pieces included;
for the fused GELU -> LayerNorm (K5f, K5b) widths that do and do not take
4-wide loads, one row, and parameters in either dtype; its row-resident
route (bf16, F = 3072) at row counts that do not fill the last group or
make groups walk several rows, both backward variants (the one
without dgamma/dbeta chosen by autograd when they are frozen), reruns
bit-identical, and unaligned rows taking the generic route. For the key-bias
kernels' short-side family (bf16, D = 16): the adapter's five shapes, a
short side of every remainder mod 16 on either side, chunks without a
valid key, a dead bh, bit-equal reruns, the C entry points' family choice
against the CPU's copy of the rule, and the CUDA-core kernels still serving
the other bf16 shapes; for its fp32 family (3xTF32): the adapter's shapes
at 10,239 and 2,047, short sides on either side, dead chunks and a dead
bh at the fp32 limits, one key, the gradients from the kernel's own out
and lse, bit-equal reruns, the launches by family through the autograd
Function, a misaligned view raising, and the CUDA-core kernels still
serving the other fp32 shapes (other D, both sides long). For its wgmma
family (bf16, D = 48, the per-branch dilated attention's): the five branch
geometries at 2,048 tokens, lengths off the 64-row tile, Lq != Lk both
ways, dead key tiles between live ones, a dead bh, a finite bias,
bit-equal reruns, the launch counts by family, the family rule on both
sides and a misaligned view raising; the same for its fp32 sibling, the
3xTF32 family at D = 48 (``-k tf32x3_flash``), with the whole r = 2
branch at 10,240 tokens besides, the gradients also from the kernel's
own out and lse, at the fp32 limits, and close v rows held against the
plain version in fp64. For the
tensor-core families of K1b and K3b (bf16 on wgmma, fp32 on 3xTF32;
D = 48): every ratio at a length no segment divides with L % 16 != 0, one
and three batch rows, a prefix mask and masked stretches that leave dead
key tiles between live ones, a batch row without a valid key, reruns
bit-equal, masked keys' dk and dv exactly 0, both routes against each
other, the family rule of the C entry points against the CPU's copy
(K3b's compact gradients at D = 48 are the K3 cases' above), and at fp32
the launches by family, a misaligned operand raising and K1b's token
ranges against the whole call; for the tensor-core
families of K1f (with and without stats) and K3f (bf16 on wgmma, fp32 on
3xTF32) the same geometries, the outputs by ``chip_smoke.check_out``, K1's
stats plane, K3's compact pieces and (m, Z), reruns bit-equal, both
routes' outputs bit-equal, a misaligned operand raising in either forward,
and at fp32 the launches by family and K1f's token ranges against the
whole call. For the ALiBi
kernels (K4) besides:
a sequence of the cls token and a handful of cells, masks and coordinates
that differ between batch rows (the kernels index them by ``bh / H``), and
a batch row whose keys are all masked but the cls token; for K4's 3xTF32
family (fp32 at D = 64, ``-k tf32x3_alibi``) the same masks against the
plain version in fp64 at the fp32 limits, bit-equal reruns, the launches
by family through the autograd Function and a misaligned view raising. And the LongNet
layers' rematerialization: one full-width default-route grad step at the
2,047 bucket under each policy bit-equal to remat off, with K1f's
launches (once a layer, twice under ``"full"``).
"""

import importlib

import pytest
import torch

from modaltune_tpu_torch.ops import NEG_INF
from modaltune_tpu_torch.ops.dilated import (dilated_attention,
                                             dilated_attention_stats)

def _load_chip_smoke():
    """``chip_smoke.py`` of the repository root as a module: the gradient
    readings are its ``grad_readings``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()
fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
af = importlib.import_module("modaltune_tpu_torch.ops.alibi_flash")
df = importlib.import_module("modaltune_tpu_torch.ops.dilated_fused")
gl = importlib.import_module("modaltune_tpu_torch.ops.gelu_ln")

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
    out, stats = dm.mega_dilated_attention_cuda(
        q, k, v, mask, segs, ratios, d ** -0.5, with_stats=True)
    want = dilated_attention_stats(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(stats, want, atol=TOL, rtol=TOL)
    assert ((stats == NEG_INF) == (want == NEG_INF)).all()
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
    _, stats = dm.mega_dilated_attention_cuda(
        q, k, v, mask, segs, ratios, d ** -0.5, with_stats=True)
    got = dm.mega_dilated_attention_backward_cuda(
        q, k, v, mask, dmix, stats, segs, ratios, d ** -0.5)
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
    _, stats = dm.mega_dilated_attention_cuda(w, w, w, None, (8,), (1,),
                                              0.25, with_stats=True)
    with pytest.raises(ValueError):                    # dmix in another dtype
        dm.mega_dilated_attention_backward_cuda(
            w, w, w, None, w.bfloat16(), stats, (8,), (1,), 0.25)
    with pytest.raises(ValueError):                    # stats of other branches
        dm.mega_dilated_attention_backward_cuda(
            w, w, w, None, w, stats, (8, 16), (1, 2), 0.25)


# ---------------------------------------------------------------------------
# K2: the short-side family (bf16, D = 16, one side of at most 128 rows)
# ---------------------------------------------------------------------------

# (BH, Lq, Lk, masked keys, a bh with every key masked). The five adapter
# shapes of the models, then a short side of every remainder mod 16 (1, 8,
# 17, 31, 65, 80, 99, 113, 128) on either side against a long side that ends
# one row into a tile, masked keys as (start, stop) fractions of Lk: the
# tail, or a stretch wide enough that whole chunks hold no valid key.
SHORT_SIDE_CASES = [
    (36, 10239, 65, None, False),
    (36, 65, 10239, (9000 / 10239, 1.0), True),
    (36, 65, 65, None, False),
    (36, 16383, 65, None, False),
    (36, 65, 16383, (14583 / 16383, 1.0), True),
    *((3, 333, n, (0.75, 1.0), True) for n in (1, 8, 17, 31, 65, 80, 99, 113,
                                              128)),
    *((3, n, 333, (0.75, 1.0), True) for n in (1, 8, 17, 31, 65, 80, 99, 113,
                                              128)),
    (2, 65, 5000, (0.2, 0.6), False),        # dead chunks between live ones
    (64, 8191, 65, (0.5, 1.0), True),        # chunks of many tiles
    (64, 65, 8191, (0.3, 0.9), True),
]
SHORT_SIDE_IDS = [f"{bh}x{lq}x{lk}" + ("-dead" if dead else "")
                  for bh, lq, lk, _, dead in SHORT_SIDE_CASES]


def _short_side_inputs(bh, lq, lk, masked, dead, device, seed=30,
                       dtype=torch.bfloat16):
    q, k, v = (_randn((bh, n, 16), seed + i, device, dtype)
               for i, n in enumerate((lq, lk, lk)))
    dout = _randn((bh, lq, 16), seed + 3, device, dtype)
    valid = torch.ones(bh, lk, dtype=torch.bool)
    if masked is not None:
        valid[:, int(masked[0] * lk):int(masked[1] * lk)] = False
        valid[:, 0] = True
    if dead:
        valid[0] = False
    bias = torch.where(valid, 0.0, NEG_INF).to(device)
    return q, k, v, dout, bias, valid.to(device)


@pytest.mark.parametrize("bh,lq,lk,masked,dead", SHORT_SIDE_CASES,
                         ids=SHORT_SIDE_IDS)
def test_short_side_kernels_match_plain(cuda_device, bh, lq, lk, masked,
                                        dead):
    """Forward and backward of the short-side family against the plain
    versions in fp32 on the same bf16 values, at ``chip_smoke.py``'s
    limits, out also relative to itself (``check_out``) and the gradients
    from the kernel's out and lse against the plain ones from the plain
    forward's (its out in bf16, as the plain path keeps it), so that a
    fault of the forward reaches them; a dead bh
    gives exactly 0 and NEG_INF and zero gradients, a masked key exactly
    zero dk and dv, and a rerun the same bits."""
    assert fa.card_family(lq, lk, 16, torch.bfloat16) != "cuda_cores"
    q, k, v, dout, bias, valid = _short_side_inputs(bh, lq, lk, masked, dead,
                                                    cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, bias, 0.25)
    want_o, want_l = fa.flash_attention_reference(q.float(), k.float(),
                                                  v.float(), bias, 0.25)
    grads = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                             0.25)
    want = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), bias, want_o.to(q.dtype).float(),
        want_l, dout.float(), 0.25)
    again = (*fa.flash_attention_cuda(q, k, v, bias, 0.25),
             *fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                               0.25))
    torch.cuda.synchronize()
    chip_smoke.compare(out, want_o, 1.6e-2, "out")
    chip_smoke.check_out(out, want_o, "bfloat16", "out")
    assert (lse - want_l).abs().max().item() <= 1e-2
    for name, g_, w_ in zip(("dq", "dk", "dv"), grads, want):
        _assert_grad_readings(g_, w_, dout, name)
    assert ((grads[1] == 0) | valid[..., None]).all()      # masked keys
    assert ((grads[2] == 0) | valid[..., None]).all()
    if dead:
        assert (out[0] == 0).all() and (lse[0] == NEG_INF).all()
        assert all((g_[0] == 0).all() for g_ in grads)
    for a, b in zip((out, lse, *grads), again):
        assert torch.equal(a, b)


def test_short_side_family_matches_the_entry_points(cuda_device):
    """The C entry points, which choose the family on the card
    (:func:`fa.card_family`), and the CPU's copy of their rule
    (:func:`fa.family`) agree."""
    for lq, lk, d, dtype in [(10239, 65, 16, torch.bfloat16),
                             (65, 10239, 16, torch.bfloat16),
                             (65, 65, 16, torch.bfloat16),
                             (129, 129, 16, torch.bfloat16),
                             (128, 4000, 16, torch.bfloat16),
                             (4000, 128, 16, torch.bfloat16),
                             (1024, 1024, 48, torch.bfloat16),
                             (10239, 65, 16, torch.float32),
                             (65, 10239, 16, torch.float32),
                             (65, 65, 16, torch.float32),
                             (129, 129, 16, torch.float32),
                             (128, 4000, 16, torch.float32),
                             (4000, 128, 16, torch.float32),
                             (10239, 65, 48, torch.float32),
                             (300, 65, 64, torch.float32),
                             (65, 10239, 48, torch.bfloat16)]:
        assert fa.card_family(lq, lk, d, dtype) == fa.family(lq, lk, d, dtype)


@pytest.mark.parametrize("bh,lq,lk,d", [(4, 300, 200, 16), (6, 130, 129, 16),
                                        (4, 200, 65, 64)])
def test_cuda_core_family_serves_other_bf16_shapes(cuda_device, bh, lq, lk,
                                                   d):
    """bf16 outside the short-side and wgmma domains (both sides long at
    D = 16, D = 64) runs the CUDA-core kernels, at the bf16 limits."""
    assert fa.card_family(lq, lk, d, torch.bfloat16) == "cuda_cores"
    q, k, v = (_randn((bh, n, d), 40 + i, cuda_device, torch.bfloat16)
               for i, n in enumerate((lq, lk, lk)))
    dout = _randn((bh, lq, d), 43, cuda_device, torch.bfloat16)
    g = torch.Generator().manual_seed(44)
    valid = torch.rand(bh, lk, generator=g) > 0.12
    valid[-1] = False
    bias = torch.where(valid, 0.0, NEG_INF).to(cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, bias, d ** -0.5)
    want_o, want_l = fa.flash_attention_reference(q.float(), k.float(),
                                                  v.float(), bias)
    grads = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                             d ** -0.5)
    want = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), bias, out.float(), lse, dout.float())
    torch.cuda.synchronize()
    chip_smoke.compare(out, want_o, 1.6e-2, "out")
    chip_smoke.check_out(out, want_o, "bfloat16", "out")
    assert (lse - want_l).abs().max().item() <= 1e-2
    for name, g_, w_ in zip(("dq", "dk", "dv"), grads, want):
        _assert_grad_readings(g_, w_, dout, name)


def test_short_side_wrapper_raises_on_a_misaligned_tensor(cuda_device):
    base = _randn((2 * 300 * 16 + 4,), 45, cuda_device, torch.bfloat16)
    q = base[4:].view(2, 300, 16)                   # 8 bytes off
    k = _randn((2, 65, 16), 46, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)


# ---------------------------------------------------------------------------
# K2: the fp32 short-side family (3xTF32, D = 16, one side of at most 128)
# ---------------------------------------------------------------------------

# (BH, Lq, Lk, masked keys, a bh with every key masked), as
# SHORT_SIDE_CASES: the adapter's shapes at fp32 (the --bf16 0 step's at
# 10,239, the schedule's at 2,047), a short side of several remainders mod
# 16 on either side, dead chunks between live ones, chunks of many tiles.
TF32_SHORT_SIDE_CASES = [
    (36, 10239, 65, None, False),
    (36, 65, 10239, (9000 / 10239, 1.0), True),
    (36, 65, 65, None, False),
    (36, 2047, 65, None, False),
    (36, 65, 2047, (1900 / 2047, 1.0), True),
    *((3, 333, n, (0.75, 1.0), True) for n in (1, 17, 65, 80, 113, 128)),
    *((3, n, 333, (0.75, 1.0), True) for n in (1, 17, 65, 80, 113, 128)),
    (2, 65, 5000, (0.2, 0.6), False),        # dead chunks between live ones
    (64, 8191, 65, (0.5, 1.0), True),        # chunks of many tiles
]
TF32_SHORT_SIDE_IDS = [f"{bh}x{lq}x{lk}" + ("-dead" if dead else "")
                       for bh, lq, lk, _, dead in TF32_SHORT_SIDE_CASES]


@pytest.mark.parametrize("bh,lq,lk,masked,dead", TF32_SHORT_SIDE_CASES,
                         ids=TF32_SHORT_SIDE_IDS)
def test_tf32_short_side_kernels_match_plain(cuda_device, bh, lq, lk, masked,
                                             dead):
    """Forward and backward of the fp32 short-side family (3xTF32) against
    the plain versions in fp32, at ``chip_smoke.py``'s fp32 limits: out by
    ``check_out`` and lse within 1e-4; dq, dk, dv from the plain out and
    lse and from the kernel's own by ``check_grads`` (rel-L2 1e-5,
    row-scaled 5e-5), and by the max-scaled ``GRAD_TOL`` of the CUDA-core
    tests; a dead bh exactly 0, NEG_INF and zero gradients, a masked key
    exactly zero dk and dv, a rerun the same bits. At one key (Lk = 1)
    P = 1 and dS = dP - delta cancels exactly: dq and dk are rounding noise
    there, held by ``GRAD_TOL`` alone (3xTF32 keeps dP to about 2^-21 of
    |dout||v|, fp32 to 2^-24; tests/test_torch_flash.py bounds it)."""
    fam = fa.card_family(lq, lk, 16, torch.float32)
    assert fam == fa.family(lq, lk, 16, torch.float32)
    assert fam in ("short_keys_tf32", "short_queries_tf32")
    q, k, v, dout, bias, valid = _short_side_inputs(
        bh, lq, lk, masked, dead, cuda_device, seed=70, dtype=torch.float32)
    out, lse = fa.flash_attention_cuda(q, k, v, bias, 0.25)
    want_o, want_l = fa.flash_attention_reference(q, k, v, bias, 0.25)
    grads = fa.flash_attention_backward_cuda(q, k, v, bias, want_o, want_l,
                                             dout, 0.25)
    own = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                           0.25)
    want = fa.flash_attention_backward_reference(q, k, v, bias, want_o,
                                                 want_l, dout, 0.25)
    again = (*fa.flash_attention_cuda(q, k, v, bias, 0.25),
             *fa.flash_attention_backward_cuda(q, k, v, bias, want_o, want_l,
                                               dout, 0.25))
    torch.cuda.synchronize()
    chip_smoke.check_out(out, want_o, "float32", "out")
    assert (lse - want_l).abs().max().item() <= 1e-4
    assert ((lse == NEG_INF) == (want_l == NEG_INF)).all()
    names = ("dq", "dk", "dv")
    held = slice(2, 3) if lk == 1 else slice(0, 3)
    for gs in (grads, own):
        for name, g_, w_ in zip(names, gs, want):
            _assert_grad_close(g_, w_, name)
        chip_smoke.check_grads(names[held], gs[held], want[held], dout,
                               "float32", f"{bh}x{lq}x{lk}")
    assert ((grads[1] == 0) | valid[..., None]).all()      # masked keys
    assert ((grads[2] == 0) | valid[..., None]).all()
    if dead:
        assert (out[0] == 0).all() and (lse[0] == NEG_INF).all()
        assert all((g_[0] == 0).all() for g_ in grads)
    for a, b in zip((out, lse, *grads), again):
        assert torch.equal(a, b)


def test_tf32_short_side_function_counts_by_family(cuda_device):
    """``flash_attention`` at fp32 / D = 16 runs the fp32 short-side family
    forward and backward, short keys and short queries, counted in
    LAUNCHES and by family and none on the CUDA cores; its gradients equal
    the wrapper's called directly."""
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    for counts in (fa.FAMILY_LAUNCHES, fa.BWD_FAMILY_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    runs = []
    for i, (lq, lk) in enumerate(((700, 65), (65, 700))):
        q, k, v = (_randn((3, n, 16), 80 + 3 * i + j, cuda_device)
                   .requires_grad_() for j, n in enumerate((lq, lk, lk)))
        out, lse = fa.flash_attention(q, k, v)
        out.pow(2).sum().backward()
        runs.append((q, k, v, out.detach(), lse))
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (2, 2)
    for counts in (fa.FAMILY_LAUNCHES, fa.BWD_FAMILY_LAUNCHES):
        assert counts["short_keys_tf32"] == counts["short_queries_tf32"] == 1
        assert counts["cuda_cores"] == 0
    for q, k, v, out, lse in runs:
        want = fa.flash_attention_backward_cuda(
            q.detach(), k.detach(), v.detach(), None, out, lse, 2 * out,
            16 ** -0.5)
        for x, w_ in zip((q, k, v), want):
            assert torch.equal(x.grad, w_)


def test_tf32_short_side_wrapper_raises_on_a_misaligned_tensor(cuda_device):
    """16-byte cp.async: an fp32 view 8 bytes off raises, forward and
    backward, where the CUDA-core kernels would take it; no fallback."""
    base = _randn((2 * 300 * 16 + 2,), 90, cuda_device)
    q = base[2:].view(2, 300, 16)                   # 8 bytes off
    k = _randn((2, 65, 16), 91, cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)
    qa = _randn((2, 300, 16), 92, cuda_device)
    out, lse = fa.flash_attention_cuda(qa, k, k, None, 0.25)
    with pytest.raises(ValueError):
        fa.flash_attention_backward_cuda(qa, k, k, None, out, lse, q, 0.25)


@pytest.mark.parametrize("bh,lq,lk,d", [(4, 300, 200, 32), (6, 130, 129, 16),
                                        (4, 200, 65, 64)])
def test_cuda_core_family_serves_other_fp32_shapes(cuda_device, bh, lq, lk,
                                                   d):
    """fp32 outside the short-side and 3xTF32 domains (D = 32; both sides
    long at D = 16; D = 64) stays on the CUDA-core kernels, at the fp32
    limits."""
    assert fa.card_family(lq, lk, d, torch.float32) == "cuda_cores"
    q, k, v = (_randn((bh, n, d), 93 + i, cuda_device)
               for i, n in enumerate((lq, lk, lk)))
    dout = _randn((bh, lq, d), 96, cuda_device)
    g = torch.Generator().manual_seed(97)
    valid = torch.rand(bh, lk, generator=g) > 0.12
    valid[-1] = False
    bias = torch.where(valid, 0.0, NEG_INF).to(cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, bias, d ** -0.5)
    want_o, want_l = fa.flash_attention_reference(q, k, v, bias)
    grads = fa.flash_attention_backward_cuda(q, k, v, bias, want_o, want_l,
                                             dout, d ** -0.5)
    want = fa.flash_attention_backward_reference(q, k, v, bias, want_o,
                                                 want_l, dout)
    torch.cuda.synchronize()
    chip_smoke.check_out(out, want_o, "float32", "out")
    assert (lse - want_l).abs().max().item() <= 1e-4
    chip_smoke.check_grads(("dq", "dk", "dv"), grads, want, dout, "float32",
                           f"{bh}x{lq}x{lk}x{d}")


# ---------------------------------------------------------------------------
# K2: the wgmma family (bf16, D = 48, any Lq and Lk)
# ---------------------------------------------------------------------------

# (BH, Lq, Lk, keys: "tail" masks the last 12 %, "holes" a stretch of whole
# 64-key tiles between live ones, "finite" adds a random finite bias to the
# tail's, None passes no bias; a bh with every key masked). First the five
# branch geometries of the per-branch dilated attention at 2,048 tokens
# (H = 16, B = 1; segments 1,024 / 5,792 / ... at ratios 1 / 2 / 4 / 8 / 16),
# then lengths off the 64-row tile (the 10,240-token (5,792, 2) branch's
# 2,896 rows end 16 into a tile), Lq != Lk both ways, one key, one query.
WGMMA_FLASH_CASES = [
    (32, 1024, 1024, "tail", False),
    (16, 1024, 1024, "tail", False),
    (16, 512, 512, "tail", False),
    (16, 256, 256, "tail", False),
    (16, 128, 128, "tail", False),
    (6, 2896, 2896, "tail", True),
    (6, 181, 181, "finite", False),
    (5, 362, 362, "holes", True),
    (4, 100, 300, "finite", True),
    (4, 300, 100, "tail", False),
    (3, 65, 1, None, False),
    (3, 1, 700, "holes", False),
]
WGMMA_FLASH_IDS = [f"{bh}x{lq}x{lk}-{keys}" + ("-dead" if dead else "")
                   for bh, lq, lk, keys, dead in WGMMA_FLASH_CASES]


def _wgmma_flash_inputs(bh, lq, lk, keys, dead, device, seed=50):
    q, k, v = (_randn((bh, n, 48), seed + i, device, torch.bfloat16)
               for i, n in enumerate((lq, lk, lk)))
    dout = _randn((bh, lq, 48), seed + 3, device, torch.bfloat16)
    valid = torch.ones(bh, lk, dtype=torch.bool)
    if keys in ("tail", "finite"):
        valid[:, lk - int(0.12 * lk):] = False
    if keys == "holes":
        valid[:, lk // 5:lk // 5 + 192] = False
    if dead:
        valid[0] = False
    if keys is None:
        return q, k, v, dout, None, valid.to(device)
    bias = torch.where(valid, 0.0, NEG_INF)
    if keys == "finite":
        g = torch.Generator().manual_seed(seed + 4)
        bias = bias + 2.0 * torch.randn(bh, lk, generator=g)
    return q, k, v, dout, bias.to(device), valid.to(device)


@pytest.mark.parametrize("bh,lq,lk,keys,dead", WGMMA_FLASH_CASES,
                         ids=WGMMA_FLASH_IDS)
def test_wgmma_flash_kernels_match_plain(cuda_device, bh, lq, lk, keys,
                                         dead):
    """K2f and K2b of the wgmma family against the plain versions in fp32
    on the same bf16 values, at ``chip_smoke.py``'s limits (out also by
    ``check_out``, the gradients by ``grad_readings`` from the kernel's
    own out and lse); a dead bh gives exactly 0, NEG_INF and zero
    gradients, a masked key exactly zero dk and dv, a rerun the same
    bits."""
    assert fa.card_family(lq, lk, 48, torch.bfloat16) == "wgmma"
    q, k, v, dout, bias, valid = _wgmma_flash_inputs(bh, lq, lk, keys, dead,
                                                     cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, bias, 48 ** -0.5)
    want_o, want_l = fa.flash_attention_reference(q.float(), k.float(),
                                                  v.float(), bias)
    grads = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                             48 ** -0.5)
    want = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), bias, want_o.to(q.dtype).float(),
        want_l, dout.float())
    again = (*fa.flash_attention_cuda(q, k, v, bias, 48 ** -0.5),
             *fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                               48 ** -0.5))
    torch.cuda.synchronize()
    chip_smoke.compare(out, want_o, 1.6e-2, "out")
    chip_smoke.check_out(out, want_o, "bfloat16", "out")
    assert (lse - want_l).abs().max().item() <= 1e-2
    for name, g_, w_ in zip(("dq", "dk", "dv"), grads, want):
        _assert_grad_readings(g_, w_, dout, name)
    assert ((grads[1] == 0) | valid[..., None]).all()      # masked keys
    assert ((grads[2] == 0) | valid[..., None]).all()
    if dead:
        assert (out[0] == 0).all() and (lse[0] == NEG_INF).all()
        assert all((g_[0] == 0).all() for g_ in grads)
    for a, b in zip((out, lse, *grads), again):
        assert torch.equal(a, b)


def test_wgmma_flash_family_matches_the_entry_points(cuda_device):
    """bf16 at D = 48 takes the wgmma family at every Lq and Lk, on the
    card (``mt_flash_attention_family``) and in the CPU's copy of the
    rule; fp32 at D = 48 the 3xTF32 family."""
    for lq, lk, d, dtype in [(1024, 1024, 48, torch.bfloat16),
                             (65, 10239, 48, torch.bfloat16),
                             (10239, 65, 48, torch.bfloat16),
                             (1, 1, 48, torch.bfloat16),
                             (2896, 2896, 48, torch.bfloat16),
                             (1024, 1024, 48, torch.float32),
                             (1024, 1024, 32, torch.bfloat16)]:
        assert fa.card_family(lq, lk, d, dtype) == fa.family(lq, lk, d, dtype)
    assert fa.card_family(640, 640, 48, torch.bfloat16) == "wgmma"
    assert fa.card_family(640, 640, 48, torch.float32) == "tf32x3"


def test_wgmma_flash_function_counts_by_family(cuda_device):
    """``flash_attention`` at bf16 / D = 48 runs the wgmma family forward
    and backward, counted in LAUNCHES and by family; its gradients equal
    the wrapper's called directly."""
    q, k, v = (_randn((3, 200, 48), s, cuda_device, torch.bfloat16)
               .requires_grad_() for s in (60, 61, 62))
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    for counts in (fa.FAMILY_LAUNCHES, fa.BWD_FAMILY_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    out, lse = fa.flash_attention(q, k, v)
    out.float().pow(2).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (1, 1)
    assert fa.FAMILY_LAUNCHES["wgmma"] == fa.BWD_FAMILY_LAUNCHES["wgmma"] == 1
    want = fa.flash_attention_backward_cuda(
        q.detach(), k.detach(), v.detach(), None, out.detach(), lse,
        2 * out.detach(), 48 ** -0.5)
    for x, w_ in zip((q, k, v), want):
        assert torch.equal(x.grad, w_)


def test_wgmma_flash_wrapper_raises_on_a_misaligned_tensor(cuda_device):
    """16-byte chunks: a view 8 bytes off raises, forward and backward,
    where the CUDA-core kernels would take it; no fallback."""
    base = _randn((2 * 300 * 48 + 4,), 63, cuda_device, torch.bfloat16)
    q = base[4:].view(2, 300, 48)                   # 8 bytes off
    k = _randn((2, 300, 48), 64, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)
    out, lse = fa.flash_attention_cuda(k, k, k, None, 0.25)
    with pytest.raises(ValueError):
        fa.flash_attention_backward_cuda(k, k, k, None, q, lse, out, 0.25)


# ---------------------------------------------------------------------------
# K2: the 3xTF32 family (fp32, D = 48, any Lq and Lk)
# ---------------------------------------------------------------------------

# The wgmma family's cases at fp32, then the per-branch route's whole r = 2
# branch at 10,240 tokens (96 x 2,896 x 2,896, 12 % of the keys masked)
TF32X3_FLASH_CASES = WGMMA_FLASH_CASES + [(96, 2896, 2896, "tail", False)]
TF32X3_FLASH_IDS = WGMMA_FLASH_IDS + ["96x2896x2896-tail-r2"]


@pytest.mark.parametrize("bh,lq,lk,keys,dead", TF32X3_FLASH_CASES,
                         ids=TF32X3_FLASH_IDS)
def test_tf32x3_flash_kernels_match_plain(cuda_device, bh, lq, lk, keys,
                                          dead):
    """K2f and K2b of the 3xTF32 family against the plain versions at
    ``chip_smoke.py``'s fp32 limits (out by ``check_out``, lse within
    ``K2_LSE_LIMIT``, the gradients by ``check_grads``, from the plain
    and from the kernel's own out and lse); a dead bh gives exactly 0,
    NEG_INF and zero gradients, a masked key exactly zero dk and dv, a
    rerun the same bits. At one key dq and dk are exact zeros plus
    rounding (P = 1, so dS = dP - delta cancels) and are held by the
    max-scaled bound alone."""
    assert fa.card_family(lq, lk, 48, torch.float32) == "tf32x3"
    q, k, v, dout, bias, valid = _wgmma_flash_inputs(bh, lq, lk, keys, dead,
                                                     cuda_device)
    q, k, v, dout = (x.float() for x in (q, k, v, dout))
    out, lse = fa.flash_attention_cuda(q, k, v, bias, 48 ** -0.5)
    want_o, want_l = fa.flash_attention_reference(q, k, v, bias)
    grads = fa.flash_attention_backward_cuda(q, k, v, bias, want_o, want_l,
                                             dout, 48 ** -0.5)
    want = fa.flash_attention_backward_reference(q, k, v, bias, want_o,
                                                 want_l, dout)
    own = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                           48 ** -0.5)
    again = (*fa.flash_attention_cuda(q, k, v, bias, 48 ** -0.5),
             *fa.flash_attention_backward_cuda(q, k, v, bias, want_o, want_l,
                                               dout, 48 ** -0.5))
    torch.cuda.synchronize()
    chip_smoke.check_out(out, want_o, "float32", "out")
    assert (lse - want_l).abs().max().item() <= chip_smoke.K2_LSE_LIMIT
    held = ("dq", "dk", "dv") if lk > 1 else ("dv",)
    for got in (grads, own):
        chip_smoke.check_grads(held, got[3 - len(held):],
                               want[3 - len(held):], dout, "float32",
                               f"{bh}x{lq}x{lk}")
        for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            _assert_grad_close(g_, w_, name)
    assert ((grads[1] == 0) | valid[..., None]).all()      # masked keys
    assert ((grads[2] == 0) | valid[..., None]).all()
    if dead:
        assert (out[0] == 0).all() and (lse[0] == NEG_INF).all()
        assert all((g_[0] == 0).all() for g_ in grads)
    for a, b in zip((out, lse, *grads), again):
        assert torch.equal(a, b)


def test_tf32x3_flash_centering_holds_close_values(cuda_device):
    """Where a plane's v rows lie close together, as on an fp32 train
    step's inputs, dq and dk are what is left of dP - delta; the kernels
    take it against v and out less vbar, the valid keys' mean v row, and
    hold the fp32 limits against the plain version in fp64 there, with a
    dead bh and masked keys exact."""
    bh, lq, lk = 4, 300, 1000
    q, k, dout = (_randn((bh, n, 48), 70 + i, cuda_device)
                  for i, n in enumerate((lq, lk, lq)))
    g = torch.Generator(device="cpu").manual_seed(73)
    v = (torch.randn(bh, 1, 48, generator=g)
         + 1e-3 * torch.randn(bh, lk, 48, generator=g)).to(cuda_device)
    valid = torch.rand(bh, lk, generator=g).to(cuda_device) > 0.1
    valid[0] = False
    bias = torch.where(valid, 0.0, NEG_INF)
    out, lse = fa.flash_attention_reference(q, k, v, bias)
    got = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse, dout,
                                           48 ** -0.5)
    want = fa.flash_attention_backward_reference(
        q.double(), k.double(), v.double(), bias, out.double(), lse,
        dout.double())
    torch.cuda.synchronize()
    chip_smoke.check_grads(("dq", "dk", "dv"), got, want, dout, "float32",
                           "close v rows")
    assert ((got[1] == 0) | valid[..., None]).all()
    assert ((got[2] == 0) | valid[..., None]).all()
    assert all((g_[0] == 0).all() for g_ in got)


def test_tf32x3_flash_family_matches_the_entry_points(cuda_device):
    """fp32 at D = 48 takes the 3xTF32 family at every Lq and Lk (the five
    branch shapes, the LoRA attention's, short sides), on the card
    (``mt_flash_attention_family``) and in the CPU's copy of the rule;
    other D stay where they were."""
    for lq, lk, d in [(1024, 1024, 48), (2896, 2896, 48), (2560, 2560, 48),
                      (1280, 1280, 48), (640, 640, 48), (65, 10239, 48),
                      (10239, 65, 48), (1, 1, 48), (640, 640, 32),
                      (10239, 65, 16), (65, 10239, 16)]:
        assert (fa.card_family(lq, lk, d, torch.float32)
                == fa.family(lq, lk, d, torch.float32))
    assert fa.card_family(65, 10239, 48, torch.float32) == "tf32x3"
    assert fa.card_family(640, 640, 32, torch.float32) == "cuda_cores"


def test_tf32x3_flash_function_counts_by_family(cuda_device):
    """``flash_attention`` at fp32 / D = 48 runs the 3xTF32 family forward
    and backward, counted in LAUNCHES and by family under ``"tf32x3"``;
    its gradients equal the wrapper's called directly."""
    q, k, v = (_randn((3, 200, 48), s, cuda_device).requires_grad_()
               for s in (65, 66, 67))
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    for counts in (fa.FAMILY_LAUNCHES, fa.BWD_FAMILY_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    out, lse = fa.flash_attention(q, k, v)
    out.pow(2).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (1, 1)
    assert fa.FAMILY_LAUNCHES["tf32x3"] == fa.BWD_FAMILY_LAUNCHES["tf32x3"] == 1
    assert sum(fa.FAMILY_LAUNCHES.values()) == 1
    want = fa.flash_attention_backward_cuda(
        q.detach(), k.detach(), v.detach(), None, out.detach(), lse,
        2 * out.detach(), 48 ** -0.5)
    for x, w_ in zip((q, k, v), want):
        assert torch.equal(x.grad, w_)


def test_tf32x3_flash_wrapper_raises_on_a_misaligned_tensor(cuda_device):
    """16-byte cp.async chunks: a view 8 bytes off raises, forward and
    backward, where the CUDA-core kernels would take it; no fallback."""
    base = _randn((2 * 300 * 48 + 2,), 68, cuda_device)
    q = base[2:].view(2, 300, 48)                   # 8 bytes off
    k = _randn((2, 300, 48), 69, cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)
    out, lse = fa.flash_attention_cuda(k, k, k, None, 0.25)
    with pytest.raises(ValueError):
        fa.flash_attention_backward_cuda(k, k, k, None, q, lse, out, 0.25)


# ---------------------------------------------------------------------------
# K4: ALiBi flash attention
# ---------------------------------------------------------------------------

# (B, H, N, D, mask): N off the 64-row tile, N = 1 + a handful, D that pads
# (16 of 16, 40 of 48) and 64; "rows" masks a different tail per batch row,
# "cls_only" leaves batch row 0 the cls key alone, "dead" masks every key
# of batch row 1, None passes no mask. bf16 at D = 64 runs the Hopper frame
# (a ring of 4 stages, heads in groups of 2 or 3): N = 64 * 5 + 1 wraps the
# ring and ends one row into a tile, N = 40 is less than a tile, H = 5 and 7
# leave a ragged head group, "holes" masks stretches of keys in the middle
# so that whole 64-key tiles die between live ones; every other D in bf16
# runs the CUDA-core kernels, as fp32 does.
ALIBI_CASES = [
    (2, 3, 200, 64, "rows"),
    (3, 4, 6, 16, "rows"),
    (2, 2, 129, 16, None),
    (2, 3, 70, 40, "cls_only"),
    (1, 12, 257, 64, "rows"),
    (2, 2, 64, 16, "dead"),
    (2, 5, 321, 64, "rows"),
    (1, 7, 40, 64, "rows"),
    (2, 3, 321, 64, None),
    (2, 4, 700, 64, "holes"),
    (2, 5, 1000, 64, "cls_only"),
    (2, 2, 300, 64, "dead"),
    (2, 2, 130, 32, "holes"),
    (1, 2, 100, 128, "rows"),
]


def _alibi_inputs(b, h, n, d, mask, device, dtype=torch.float32, seed=20):
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, n, d, generator=g).to(device, dtype)
                     for _ in range(4))
    coords3 = torch.zeros(b, n, 3)
    # a different grid per batch row
    coords3[:, 1:, :2] = torch.randint(0, 12, (b, n - 1, 2),
                                       generator=g).float()
    coords3[:, 0, 2] = 1.0
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)])
    key_mask = None
    if mask is not None:
        key_mask = torch.ones(b, n, dtype=torch.bool)
        for i in range(b):                      # a different tail per row
            key_mask[i, n - 1 - (i + 1) * (n // 5):] = False
        if mask == "holes":     # dead 64-key tiles between live ones
            run = torch.arange(n) // 96
            for i in range(b):
                key_mask[i, (run % 3 == (1 + i) % 3) & (run > 0)] = False
        if mask == "cls_only":
            key_mask[0, 1:] = False
        if mask == "dead":
            key_mask[1] = False
        key_mask = key_mask.to(device)
    return q, k, v, dout, coords3.to(device), slopes.to(device), key_mask


# fp32 runs the CUDA-core kernels, bf16 at D = 64 the tensor-core kernels:
# there the plain version computes in fp32 on the same bf16 values, and the
# kernel rounds its probabilities (dS in the backward) and its results to
# bf16.
ALIBI_DTYPES = [(torch.float32, TOL, 1e-4, GRAD_TOL),
                (torch.bfloat16, 1.6e-2, 1e-2, 2e-2)]
ALIBI_IDS = ["fp32", "bf16"]
# A gradient's largest element (the cls key's dk and dv, which every query
# reaches without a distance term) is many times a typical one, so the
# max-scaled tolerance above says little about the rest. Two readings that
# do not hang on it, as (rel-L2, row) limits by dtype; bf16 rounds P, dS
# and the result to 2^-9 each.
ALIBI_GRAD_LIMITS = {torch.float32: (1e-4, 2e-4),
                     torch.bfloat16: (1e-2, 2e-2)}


def _assert_grad_readings(got, want, dout, what):
    """``chip_smoke.grad_readings`` (rel-L2, and max|err| of a row over
    max|want| of that row) within ALIBI_GRAD_LIMITS."""
    rel_lim, row_lim = ALIBI_GRAD_LIMITS[got.dtype]
    rel, row = chip_smoke.grad_readings(got, want, dout)
    assert rel <= rel_lim and row <= row_lim, \
        f"{what}: rel-L2 {rel:.3e}, row-scaled max|err| {row:.3e}"


@pytest.mark.parametrize("dtype,tol,lse_tol,_", ALIBI_DTYPES, ids=ALIBI_IDS)
@pytest.mark.parametrize("b,h,n,d,mask", ALIBI_CASES)
def test_alibi_kernel_matches_plain(cuda_device, b, h, n, d, mask, dtype, tol,
                                    lse_tol, _):
    q, k, v, _, coords3, slopes, key_mask = _alibi_inputs(
        b, h, n, d, mask, cuda_device, dtype)
    got_o, got_l = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                                 key_mask, d ** -0.5)
    want_o, want_l = af.alibi_attention_reference(
        q.float(), k.float(), v.float(), coords3, slopes, key_mask)
    torch.cuda.synchronize()
    assert got_o.dtype == dtype and torch.isfinite(got_o).all()
    assert (got_o.float() - want_o).abs().max().item() <= tol * max(
        1.0, want_o.abs().max().item())
    assert (got_l - want_l).abs().max().item() <= lse_tol
    if mask == "cls_only":
        assert torch.allclose(got_o[0], v[0, :, :1].expand_as(got_o[0]),
                              atol=1e-6)
    if mask == "dead":
        assert (got_o[1] == 0).all() and (got_l[1] == NEG_INF).all()


@pytest.mark.parametrize("dtype,_,__,tol", ALIBI_DTYPES, ids=ALIBI_IDS)
@pytest.mark.parametrize("b,h,n,d,mask", ALIBI_CASES)
def test_alibi_backward_kernel_matches_plain(cuda_device, b, h, n, d, mask,
                                             dtype, _, __, tol):
    q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
        b, h, n, d, mask, cuda_device, dtype)
    if key_mask is not None:    # the loss weighs valid query rows only
        dout = dout * key_mask[:, None, :, None]
    out, lse = af.alibi_attention_reference(q, k, v, coords3, slopes,
                                            key_mask)
    got = af.alibi_flash_attention_backward_cuda(
        q, k, v, coords3, slopes, key_mask, out, lse, dout, d ** -0.5)
    want = af.alibi_attention_backward_reference(
        q.float(), k.float(), v.float(), coords3, slopes, key_mask,
        out.float(), lse, dout.float())
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        err = (g.float() - w).abs().max().item()
        assert err <= tol * max(1.0, w.abs().max().item()), \
            f"alibi {name} {(b, h, n, d, mask)}: max|err| {err:.3e}"
        _assert_grad_readings(g, w, dout,
                              f"alibi {name} {(b, h, n, d, mask)}")
    if key_mask is not None:    # masked keys: exactly zero dk and dv
        dead = ~key_mask[:, None, :, None].expand_as(got[1])
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()
    if mask == "dead":
        assert all((g[1] == 0).all() for g in got)


@pytest.mark.parametrize("b,h,n,d,mask", [(2, 5, 321, 64, "rows"),
                                          (2, 4, 700, 64, "holes"),
                                          (2, 3, 70, 40, "cls_only")])
def test_alibi_bf16_reruns_are_bit_equal(cuda_device, b, h, n, d, mask):
    """No atomics anywhere: two runs of K4f and of K4b give the same bits,
    on the Hopper frame (D = 64) and on the CUDA-core kernels."""
    q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
        b, h, n, d, mask, cuda_device, torch.bfloat16)
    runs = []
    for _ in range(2):
        out, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                                 key_mask, d ** -0.5)
        runs.append((out, lse, *af.alibi_flash_attention_backward_cuda(
            q, k, v, coords3, slopes, key_mask, out, lse, dout, d ** -0.5)))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize("h", [1, 2, 4, 5, 7])
def test_alibi_hopper_configurations_agree(cuda_device, h):
    """The Hopper frame's head groups (3 heads a block in the forward, 2 in
    the dq kernel) against the plain version for head counts that fill,
    underfill and leave ragged groups, dead tiles in the middle; the
    backward with the forward's side inputs handed on gives the same bits
    as the backward that makes its own."""
    b, n, d = 2, 450, 64
    q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
        b, h, n, d, "holes", cuda_device, torch.bfloat16)
    dout = dout * key_mask[:, None, :, None]
    side = af.wgmma_side_inputs(coords3, key_mask, b, n)
    out, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                             key_mask, d ** -0.5, side=side)
    want_o, want_l = af.alibi_attention_reference(
        q.float(), k.float(), v.float(), coords3, slopes, key_mask)
    assert (out.float() - want_o).abs().max().item() <= 1.6e-2
    assert (lse - want_l).abs().max().item() <= 1e-2
    got = af.alibi_flash_attention_backward_cuda(
        q, k, v, coords3, slopes, key_mask, out, lse, dout, d ** -0.5,
        side=side)
    own = af.alibi_flash_attention_backward_cuda(
        q, k, v, coords3, slopes, key_mask, out, lse, dout, d ** -0.5)
    want = af.alibi_attention_backward_reference(
        q.float(), k.float(), v.float(), coords3, slopes, key_mask,
        out.float(), lse, dout.float())
    torch.cuda.synchronize()
    for name, g, o, w in zip(("dq", "dk", "dv"), got, own, want):
        _assert_grad_readings(g, w, dout, f"{name} H = {h}")
        assert torch.equal(g, o), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alibi_function_runs_both_kernels(cuda_device, dtype):
    """The autograd Function launches K4f and K4b once each and agrees
    with autograd through the plain version (in bf16: within bf16
    rounding of the gradients)."""
    q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
        2, 3, 150, 64, "rows", cuda_device, dtype)
    dout = dout * key_mask[:, None, :, None]
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    af.LAUNCHES = af.BWD_LAUNCHES = 0
    out = af.alibi_flash_attention(*leaves, coords3, slopes,
                                   key_mask=key_mask)
    got = torch.autograd.grad(out, leaves, dout)
    assert (af.LAUNCHES, af.BWD_LAUNCHES) == (1, 1)
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        af.alibi_attention_reference(*ref, coords3, slopes, key_mask)[0],
        ref, dout.float())
    torch.cuda.synchronize()
    tol = GRAD_TOL if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        err = (g.float() - w).abs().max().item()
        assert err <= tol * max(1.0, w.abs().max().item()), (name, err)
        _assert_grad_readings(g, w, dout, name)


def test_alibi_wrapper_raises_instead_of_falling_back(cuda_device):
    q, k, v, _, coords3, slopes, key_mask = _alibi_inputs(
        1, 2, 20, 16, "rows", cuda_device)
    with pytest.raises(TypeError):
        af.alibi_flash_attention(q.half(), k.half(), v.half(), coords3,
                                 slopes, key_mask=key_mask)
    with pytest.raises(ValueError):             # q not contiguous
        af.alibi_flash_attention(q.transpose(1, 2).contiguous()
                                 .transpose(1, 2), k, v, coords3, slopes)
    with pytest.raises(ValueError):             # coords on another device
        af.alibi_flash_attention_cuda(q, k, v, coords3.cpu(), slopes,
                                      key_mask, 0.25)
    z = torch.zeros(1, 2, 20, 136, device=cuda_device)     # D > 128
    with pytest.raises(ValueError):
        af.alibi_flash_attention(z, z, z, coords3, slopes)


# K4's 3xTF32 family (fp32 at D = 64, csrc/alibi_tf32_{fwd,bwd}.cu): N off
# the tile and on it, less than a tile, one head, masks per batch row, dead
# key tiles between live ones, a cls-only row, a dead batch row, no mask.
TF32X3_ALIBI_CASES = [
    (2, 3, 200, "rows"), (1, 12, 257, "rows"), (2, 5, 321, "rows"),
    (1, 7, 40, "rows"), (2, 3, 321, None), (2, 4, 700, "holes"),
    (2, 5, 1000, "cls_only"), (2, 2, 300, "dead"), (3, 1, 128, "rows"),
]


def _tf32x3_alibi_readings(q, k, v, dout, coords3, slopes, key_mask, out,
                           lse, grads):
    """out, lse and the gradients against the plain version in fp64, at
    chip_smoke.py's fp32 limits (the family's centered delta is more exact
    than the plain version in fp32, whose gradients read up to 1e-4 against
    fp64 where dP nearly cancels delta)."""
    want_o, want_l = af.alibi_attention_reference(
        q.double(), k.double(), v.double(), coords3, slopes, key_mask)
    chip_smoke.check_out(out, want_o, "float32", "out")
    assert (lse.double() - want_l).abs().max().item() <= 1e-4
    want = af.alibi_attention_backward_reference(
        q.double(), k.double(), v.double(), coords3, slopes, key_mask,
        out.double(), lse, dout.double())
    chip_smoke.check_grads(("dq", "dk", "dv"), grads, want, dout, "float32",
                           "grads")


@pytest.mark.parametrize("b,h,n,mask", TF32X3_ALIBI_CASES)
def test_tf32x3_alibi_kernels_match_plain(cuda_device, b, h, n, mask):
    """fp32 at D = 64 runs the 3xTF32 family: K4f, then K4b from the
    kernel's own out and lse, against the plain version in fp64 at the fp32
    limits; masked keys get exactly zero dk and dv, a cls-only row the cls
    key's v row, a dead batch row out 0, lse NEG_INF and zero gradients."""
    q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
        b, h, n, 64, mask, cuda_device)
    assert af.card_family(q) == "tf32x3"
    if key_mask is not None:
        dout = dout * key_mask[:, None, :, None]
    out, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                             key_mask, 0.125)
    grads = af.alibi_flash_attention_backward_cuda(
        q, k, v, coords3, slopes, key_mask, out, lse, dout, 0.125)
    torch.cuda.synchronize()
    _tf32x3_alibi_readings(q, k, v, dout, coords3, slopes, key_mask, out,
                           lse, grads)
    if key_mask is not None:
        dead = ~key_mask[:, None, :, None].expand_as(grads[1])
        assert (grads[1][dead] == 0).all() and (grads[2][dead] == 0).all()
    if mask == "cls_only":
        assert torch.allclose(out[0], v[0, :, :1].expand_as(out[0]),
                              atol=1e-6)
    if mask == "dead":
        assert (out[1] == 0).all() and (lse[1] == NEG_INF).all()
        assert all((g[1] == 0).all() for g in grads)


def test_tf32x3_alibi_reruns_are_bit_equal(cuda_device):
    """No atomics: two runs of K4f and of K4b give the same bits."""
    q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
        2, 4, 700, 64, "holes", cuda_device)
    runs = []
    for _ in range(2):
        out, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                                 key_mask, 0.125)
        runs.append((out, lse, *af.alibi_flash_attention_backward_cuda(
            q, k, v, coords3, slopes, key_mask, out, lse, dout, 0.125)))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_tf32x3_alibi_launches_by_family(cuda_device):
    """The C entry points' rule equals the CPU's copy; the autograd
    Function launches K4f and K4b once each on the dtype's family (fp32
    3xTF32, bf16 wgmma at D = 64; the CUDA cores at D = 32), counted by
    family, and at fp32 agrees with autograd through the plain version in
    fp64."""
    for d in (16, 32, 48, 64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.zeros(1, 1, 2, d, dtype=dtype, device=cuda_device)
            assert af.card_family(x) == af.family(x), (d, dtype)
    for d, dtype, fam in ((64, torch.float32, "tf32x3"),
                          (64, torch.bfloat16, "wgmma"),
                          (32, torch.float32, "cuda_cores")):
        q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
            2, 3, 150, d, "rows", cuda_device, dtype)
        dout = dout * key_mask[:, None, :, None]
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        for counts in (af.FAMILY_LAUNCHES, af.BWD_FAMILY_LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))
        out = af.alibi_flash_attention(*leaves, coords3, slopes,
                                       key_mask=key_mask)
        got = torch.autograd.grad(out, leaves, dout)
        want = {f: int(f == fam) for f in af.FAMILIES}
        assert af.FAMILY_LAUNCHES == want and af.BWD_FAMILY_LAUNCHES == want
        if fam == "tf32x3":
            ref = [x.detach().double().requires_grad_() for x in (q, k, v)]
            want_g = torch.autograd.grad(af.alibi_attention_reference(
                *ref, coords3, slopes, key_mask)[0], ref, dout.double())
            chip_smoke.check_grads(("dq", "dk", "dv"), got, want_g, dout,
                                   "float32", "autograd")


def test_tf32x3_alibi_wrapper_raises_on_a_misaligned_tensor(cuda_device):
    """16-byte cp.async: an fp32 view 8 bytes off raises, forward and
    backward; no fallback to the CUDA cores or the plain version."""
    q, k, v, dout, coords3, slopes, key_mask = _alibi_inputs(
        1, 2, 100, 64, "rows", cuda_device)
    base = _randn((2 * 100 * 64 + 2,), 98, cuda_device)
    off = base[2:].view(1, 2, 100, 64)              # 8 bytes off
    with pytest.raises(ValueError):
        af.alibi_flash_attention(off, k, v, coords3, slopes, key_mask)
    out, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                             key_mask, 0.125)
    with pytest.raises(ValueError):
        af.alibi_flash_attention_backward_cuda(q, k, v, coords3, slopes,
                                               key_mask, out, lse, off, 0.125)


# ---------------------------------------------------------------------------
# K3: per-branch dilated attention and the mix
# ---------------------------------------------------------------------------

# (B, L, H, D, segments, ratios, mask): DILATED_CASES' geometries, then a
# length no segment divides with sixteen heads at ratio 16 ("tail": a
# different valid length per batch row), one valid key ("one"), and a
# batch row without a valid key ("dead").
FUSED_CASES = [c[:6] + ("tail" if c[6] else None,) for c in DILATED_CASES] + [
    (2, 777, 16, 48, (100, 300, 777), (1, 4, 16), "tail"),
    (1, 130, 4, 16, (64, 130), (1, 2), "one"),
    (2, 200, 4, 32, (64, 128, 512), (1, 2, 4), "dead"),
]
FUSED_DTYPES = [(torch.float32, TOL, GRAD_TOL), (torch.bfloat16, 1.6e-2, 3e-2)]


def _fused_inputs(b, length, h, d, mask, device, dtype):
    q, k, v, dmix = (_randn((b, length, h, d), s, device, dtype)
                     for s in (5, 6, 7, 8))
    m = None
    if mask is not None:
        lens = torch.tensor([length, max(1, length * 2 // 3)])[:b]
        m = torch.arange(length)[None, :] < lens[:, None]
        if mask == "one":
            m[:] = False
            m[:, 70] = True
        if mask == "dead":
            m[1] = False
        m = m.to(device)
    valid = (torch.ones(b, length, dtype=torch.bool, device=device)
             if m is None else m)[:, :, None, None]
    return q, k, v, dmix * valid, m, valid


@pytest.mark.parametrize("dtype,tol,_", FUSED_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,length,h,d,segs,ratios,mask", FUSED_CASES)
def test_fused_kernel_matches_plain(cuda_device, b, length, h, d, segs, ratios,
                                    mask, dtype, tol, _):
    """K3f: the mixed output against ``dilated_attention``, the compact
    pieces and ``(m, Z)`` against the plain pieces (in fp32 on the same
    values) and against ``dilated_attention_stats``."""
    q, k, v, _, m, valid = _fused_inputs(b, length, h, d, mask, cuda_device,
                                         dtype)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=m)
    scale = d ** -0.5
    mixed, out_c, lse_c, stats = df.fused_dilated_attention_cuda(
        q, k, v, m, segs, ratios, scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    want = dilated_attention(qf, kf, vf, **kw)
    want_st = dilated_attention_stats(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    assert mixed.dtype == dtype and torch.isfinite(mixed).all()
    err = ((mixed.float() - want) * valid).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err
    n = len(segs)
    torch.testing.assert_close(stats.reshape(2, b * h, length),
                               want_st[:, n:].transpose(0, 1), atol=1e-4,
                               rtol=1e-5)
    outs = df.split_branches(out_c, length, segs, ratios)
    lses = df.split_branches(lse_c, length, segs, ratios)
    for i, (w, r) in enumerate(zip(segs, ratios)):
        want_o, want_l = df.fused_branch_reference(qf, kf, vf, m, w, r, scale)
        assert ((lses[i] == NEG_INF) == (want_l == NEG_INF)).all()
        torch.testing.assert_close(lses[i], want_l, atol=1e-4, rtol=1e-5)
        err = (outs[i].float() - want_o).abs().max().item()
        assert err <= tol * max(1.0, want_o.abs().max().item()), (i, err)
        assert (outs[i][want_l == NEG_INF] == 0).all()
    if mask == "dead":
        assert (mixed[1] == 0).all() and (stats[1, 1] == 0).all()


@pytest.mark.parametrize("dtype,_,tol", FUSED_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,length,h,d,segs,ratios,mask", FUSED_CASES)
def test_fused_backward_kernel_matches_autograd(cuda_device, b, length, h, d,
                                                segs, ratios, mask, dtype, _,
                                                tol):
    """K3b: dq/dk/dv against autograd through the plain version (in fp32
    on the same values), and its compact gradients against the plain
    branch backward."""
    q, k, v, dmix, m, valid = _fused_inputs(b, length, h, d, mask,
                                            cuda_device, dtype)
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=m)
    scale = d ** -0.5
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(dilated_attention(*leaves, **kw), dmix.float())
    _, out_c, lse_c, stats = df.fused_dilated_attention_cuda(
        q, k, v, m, segs, ratios, scale)
    dq, dk, dv, grads_c = df.fused_dilated_attention_backward_cuda(
        q, k, v, m, dmix, lse_c, stats, segs, ratios, scale,
        return_compact=True)
    torch.cuda.synchronize()
    for name, g_, x in zip(("dq", "dk", "dv"), (dq, dk, dv), leaves):
        assert g_.dtype == dtype and torch.isfinite(g_).all(), name
        err = ((g_.float() - x.grad) * valid).abs().max().item()
        assert err <= tol * max(1.0, x.grad.abs().max().item()), (name, err)
        _assert_grad_readings(g_ * valid, x.grad * valid, dmix, name)
        if mask is not None and name != "dq":
            assert (g_ * ~valid == 0).all(), f"{name} of masked keys"
    lses = df.split_branches(lse_c, length, segs, ratios)
    for i, (w, r) in enumerate(zip(segs, ratios)):
        want = df.fused_branch_backward_reference(
            q.float(), k.float(), v.float(), m, lses[i], stats[0], stats[1],
            dmix.float(), w, r, scale)
        for g_, w_ in zip(df.split_branches(grads_c.movedim(0, -1), length,
                                            segs, ratios)[i].unbind(-1), want):
            # bf16: q, k, v, dmix rounded; delta from P and dP in fp32
            err = (g_ - w_).abs().max().item()
            assert err <= (GRAD_TOL if dtype == torch.float32 else 2e-2) * \
                max(1.0, w_.abs().max().item()), (i, err)
    if mask == "dead":
        assert all((g_[1] == 0).all() for g_ in (dq, dk, dv))


def test_fused_function_runs_both_kernels(cuda_device):
    q, k, v = (_randn((2, 128, 4, 16), s, cuda_device).requires_grad_()
               for s in (19, 20, 21))
    kw = dict(segment_lengths=(32, 128), dilated_ratios=(1, 2))
    df.LAUNCHES = df.BWD_LAUNCHES = dm.LAUNCHES = 0
    df.fused_dilated_attention(q, k, v, **kw).sum().backward()
    assert (df.LAUNCHES, df.BWD_LAUNCHES, dm.LAUNCHES) == (1, 1, 0)
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    dilated_attention(q, k, v, **kw).sum().backward()
    for g_, x in zip(got, (q, k, v)):
        _assert_grad_close(g_, x.grad, "grad")
    with torch.no_grad():
        out = df.fused_dilated_attention(q, k, v, **kw)
    assert (df.LAUNCHES, df.BWD_LAUNCHES) == (2, 1)
    torch.testing.assert_close(out, dm.mega_dilated_attention(
        q.detach(), k.detach(), v.detach(), **kw), atol=TOL, rtol=TOL)


def test_fused_wrapper_raises_instead_of_falling_back(cuda_device):
    y = _randn((2, 16, 4, 16), 9, cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        df.fused_dilated_attention(y, y, y, segment_lengths=(8,),
                                   dilated_ratios=(1,))
    x = _randn((1, 16, 4, 16), 9, cuda_device)
    with pytest.raises(TypeError):
        df.fused_dilated_attention(x.half(), x.half(), x.half(),
                                   segment_lengths=(8,), dilated_ratios=(1,))
    _, _, lse_c, stats = df.fused_dilated_attention_cuda(
        x, x, x, None, (8,), (1,), 0.25)
    with pytest.raises(ValueError):                    # other branches' rows
        df.fused_dilated_attention_backward_cuda(
            x, x, x, None, x, lse_c, stats, (8, 16), (1, 2), 0.25)


# ---------------------------------------------------------------------------
# K1b and K3b: the tensor-core family (bf16, D = 48)
# ---------------------------------------------------------------------------

# (B, L, H, segments, ratios, mask): every ratio of GigaPath at a length no
# segment divides and L % 16 != 0, three batch rows (all valid, dead tiles
# between live ones, a prefix); GigaPath's geometry at 2,048 tokens behind a
# prefix mask; small groups and a batch row without a valid key; no mask.
WGMMA_CASES = [
    (3, 777, 16, (100, 300, 500, 600, 700), (1, 2, 4, 8, 16), "holes"),
    (1, 2048, 16, (256, 1024, 2048, 2048, 2048), (1, 2, 4, 8, 16), "prefix"),
    (2, 300, 4, (64, 128, 160), (1, 2, 4), "dead"),
    (1, 333, 8, (64, 128, 333), (1, 2, 4), None),
]
WGMMA_IDS = ["every_ratio", "gigapath_2048", "dead_row", "no_mask"]
ROUTES = ["mega", "fused"]


def _wgmma_inputs(b, length, h, mask, device, dtype=torch.bfloat16):
    q, k, v, dmix = (_randn((b, length, h, 48), s, device, dtype)
                     for s in (31, 32, 33, 34))
    m = torch.ones(b, length, dtype=torch.bool)
    pos = torch.arange(length)
    if mask == "holes":     # row 1: two masked stretches; row 2: a prefix
        m[1] = ((pos < 150) | (pos >= 330)) & ((pos < 520) | (pos >= 700))
        m[2] = pos < 500
    if mask == "prefix":
        m[0] = pos < 1800
    if mask == "dead":
        m[0] = pos < 250
        m[1] = False
    m = m.to(device)
    return q, k, v, dmix * m[:, :, None, None], m, None if mask is None else m


def _wgmma_backward(route, q, k, v, m, dmix, segs, ratios):
    scale = 48 ** -0.5
    if route == "mega":
        _, stats = dm.mega_dilated_attention_cuda(
            q, k, v, m, segs, ratios, scale, with_stats=True)
        return dm.mega_dilated_attention_backward_cuda(
            q, k, v, m, dmix, stats, segs, ratios, scale)
    _, _, lse_c, stats = df.fused_dilated_attention_cuda(
        q, k, v, m, segs, ratios, scale)
    return df.fused_dilated_attention_backward_cuda(
        q, k, v, m, dmix, lse_c, stats, segs, ratios, scale)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("b,length,h,segs,ratios,mask", WGMMA_CASES,
                         ids=WGMMA_IDS)
def test_wgmma_backward_matches_autograd(cuda_device, route, b, length, h,
                                         segs, ratios, mask):
    """K1b and K3b in the tensor-core family against autograd through the
    plain version (fp32 on the same bf16 values) on the valid rows, by
    ``chip_smoke.check_grads`` (rel-L2 <= 1e-2, row-scaled <= 2e-2) and by
    the max-scaled bound 3e-2; a masked key's dk and dv exactly 0, a batch
    row without a valid key all 0, and a rerun bit-equal."""
    assert df.card_family(48, torch.bfloat16) == "wgmma"
    q, k, v, dmix, m, arg = _wgmma_inputs(b, length, h, mask, cuda_device)
    valid = m[:, :, None, None]
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(dilated_attention(
        *leaves, segment_lengths=segs, dilated_ratios=ratios, mask=arg),
        dmix.float())
    want = [x.grad * valid for x in leaves]
    got = _wgmma_backward(route, q, k, v, arg, dmix, segs, ratios)
    torch.cuda.synchronize()
    got_valid = [g_ * valid for g_ in got]
    for name, g_, w_ in zip(("dq", "dk", "dv"), got_valid, want):
        assert g_.dtype == torch.bfloat16 and torch.isfinite(g_).all(), name
        chip_smoke.compare(g_, w_, 3e-2, f"{route} {name}")
    chip_smoke.check_grads(("dq", "dk", "dv"), got_valid, want, dmix,
                           "bfloat16", route)
    for name, g_ in zip(("dk", "dv"), got[1:]):
        assert (g_[~m] == 0).all(), f"{name} of masked keys"
    if mask == "dead":
        assert all((g_[1] == 0).all() for g_ in got)
    again = _wgmma_backward(route, q, k, v, arg, dmix, segs, ratios)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_wgmma_routes_agree(cuda_device):
    """K1b and K3b share the gradient core and the combine; from the same
    inputs they differ only through their forwards' saved planes (K1f's
    and K3f's bf16 branch outputs) and their preps."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[0]
    q, k, v, dmix, _, m = _wgmma_inputs(b, length, h, mask, cuda_device)
    g1 = _wgmma_backward("mega", q, k, v, m, dmix, segs, ratios)
    g3 = _wgmma_backward("fused", q, k, v, m, dmix, segs, ratios)
    for name, a, b_ in zip(("dq", "dk", "dv"), g1, g3):
        rel, row = chip_smoke.grad_readings(a, b_, dmix)
        assert rel <= 5e-3 and row <= 2e-2, (name, rel, row)


def test_dilated_bwd_family_matches_the_entry_points(cuda_device):
    """The C rule (``mt_dilated_family``, which the wrappers ask) and
    the CPU's copy (``df.family``) agree."""
    for d in (8, 16, 24, 32, 40, 48, 64, 72, 128):
        for dtype in (torch.float32, torch.bfloat16):
            assert df.card_family(d, dtype) == df.family(d, dtype)


def test_wgmma_family_raises_on_a_misaligned_tensor(cuda_device):
    """The gathers read 16-byte chunks: an operand off 16 bytes raises, in
    either route's forward and in the backward."""
    x = _randn((1, 64 * 16 * 48 + 4), 35, cuda_device, torch.bfloat16)
    q = x[0, 4:].view(1, 64, 16, 48)       # 8 bytes off the allocation
    scale = 48 ** -0.5
    with pytest.raises(RuntimeError):
        df.fused_dilated_attention_cuda(q, q, q, None, (64,), (1,), scale)
    with pytest.raises(RuntimeError):
        dm.mega_dilated_attention_cuda(q, q, q, None, (64,), (1,), scale)
    a = q.clone()                          # a fresh, aligned allocation
    _, _, lse_c, stats = df.fused_dilated_attention_cuda(
        a, a, a, None, (64,), (1,), scale)
    with pytest.raises(RuntimeError):
        df.fused_dilated_attention_backward_cuda(
            q, q, q, None, a, lse_c, stats, (64,), (1,), scale)


@pytest.mark.parametrize("n", [2, 4])
def test_k1b_in_two_parts_gives_the_whole_calls_bits(cuda_device, n):
    """K1b's two parts over each of ``n`` token ranges, as the
    sequence-parallel island runs them (one process here, the ranks in
    turn): part 0 gives each range's dq, and dk, dv 0; the ranges' delta
    planes summed, part 1 gives each range's dk and dv; every range's rows
    of dq, dk and dv are the whole call's bits. The CUDA-core family
    refuses the parts."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[1]
    q, k, v, dmix, m, arg = _wgmma_inputs(b, length, h, mask, cuda_device)
    scale = 48 ** -0.5
    _, whole_stats = dm.mega_dilated_attention_cuda(
        q, k, v, arg, segs, ratios, scale, with_stats=True)
    whole = dm.mega_dilated_attention_backward_cuda(
        q, k, v, arg, dmix, whole_stats, segs, ratios, scale)
    size = length // n
    ranges = [(i * size, (i + 1) * size) for i in range(n)]
    parts = []
    for rng in ranges:
        _, stats = dm.mega_dilated_attention_cuda(
            q, k, v, arg, segs, ratios, scale, with_stats=True,
            q_token_range=rng)
        local = torch.zeros_like(dmix)
        local[:, rng[0]:rng[1]] = dmix[:, rng[0]:rng[1]]
        scratch = dm.part_scratch(q, segs, ratios)
        dq, dk, dv = dm.mega_dilated_attention_backward_part_cuda(
            q, k, v, arg, local, stats, segs, ratios, scale, 0, rng, scratch)
        assert not dk.any() and not dv.any()
        outside = torch.ones(length, dtype=torch.bool, device=cuda_device)
        outside[rng[0]:rng[1]] = False
        assert not dq[:, outside].any()
        parts.append((rng, scratch, dq))
    delta = sum(scratch[0][2] for _, scratch, _ in parts)
    for rng, scratch, dq in parts:
        scratch[0][2] = delta
        _, dk, dv = dm.mega_dilated_attention_backward_part_cuda(
            q, k, v, arg, dmix, whole_stats, segs, ratios, scale, 1, rng,
            scratch)
        rows = slice(rng[0], rng[1])
        for got, want in zip((dq, dk, dv), whole):
            assert torch.equal(got[:, rows], want[:, rows])
    x = _randn((1, 64, 4, 48), 9, cuda_device)
    _, st = dm.mega_dilated_attention_cuda(x, x, x, None, (32,), (1,), 0.25,
                                           with_stats=True)
    with pytest.raises(RuntimeError):
        dm.mega_dilated_attention_backward_part_cuda(
            x, x, x, None, x, st, (32,), (1,), 0.25, 0, (0, 32),
            dm.part_scratch(x, (32,), (1,)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [2, 4])
def test_k1f_range_stats_are_the_whole_calls_columns(cuda_device, dtype, n):
    """The sequence-parallel island's backward gathers each rank's stats
    columns from K1f with its token range: in either tensor-core family
    (bf16 at D = 48 wgmma, fp32 3xTF32) they are the whole call's bits,
    so the backward on them is the whole call's."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[1]
    q, k, v, _, _, arg = _wgmma_inputs(b, length, h, mask, cuda_device)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    scale = 48 ** -0.5
    _, whole_stats = dm.mega_dilated_attention_cuda(
        q, k, v, arg, segs, ratios, scale, with_stats=True)
    size = length // n
    assert size * n == length
    cols = []
    for i in range(n):
        rng = (i * size, (i + 1) * size)
        _, stats = dm.mega_dilated_attention_cuda(
            q, k, v, arg, segs, ratios, scale, with_stats=True,
            q_token_range=rng)
        cols.append(stats[..., rng[0]:rng[1]])
    gathered = torch.cat(cols, dim=2)
    assert torch.equal(gathered, whole_stats)


# ---------------------------------------------------------------------------
# K1b and K3b: the 3xTF32 family (fp32, D = 48)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("b,length,h,segs,ratios,mask", WGMMA_CASES,
                         ids=WGMMA_IDS)
def test_tf32x3_backward_matches_autograd(cuda_device, route, b, length, h,
                                          segs, ratios, mask):
    """K1b and K3b at fp32 and D = 48 (the 3xTF32 core, the family the
    entry points choose) against autograd through the plain version in
    fp32 on the valid rows: by the max-scaled bound ``GRAD_TOL`` and by
    ``chip_smoke.check_grads``' fp32 limits (rel-L2 <= 1e-5, row-scaled
    <= 5e-5); a masked key's dk and dv exactly 0, a batch row without a
    valid key all 0, a rerun bit-equal."""
    assert df.card_family(48, torch.float32) == "tf32x3"
    q, k, v, dmix, m, arg = _wgmma_inputs(b, length, h, mask, cuda_device,
                                          torch.float32)
    valid = m[:, :, None, None]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(dilated_attention(
        *leaves, segment_lengths=segs, dilated_ratios=ratios, mask=arg), dmix)
    want = [x.grad * valid for x in leaves]
    got = _wgmma_backward(route, q, k, v, arg, dmix, segs, ratios)
    torch.cuda.synchronize()
    got_valid = [g_ * valid for g_ in got]
    for name, g_, w_ in zip(("dq", "dk", "dv"), got_valid, want):
        assert g_.dtype == torch.float32, name
        _assert_grad_close(g_, w_, f"{route} {name}")
    chip_smoke.check_grads(("dq", "dk", "dv"), got_valid, want, dmix,
                           "float32", route)
    for name, g_ in zip(("dk", "dv"), got[1:]):
        assert (g_[~m] == 0).all(), f"{name} of masked keys"
    if mask == "dead":
        assert all((g_[1] == 0).all() for g_ in got)
    again = _wgmma_backward(route, q, k, v, arg, dmix, segs, ratios)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_tf32x3_routes_agree(cuda_device):
    """At fp32 K1b and K3b share the 3xTF32 core and the combine; their
    gradients differ only through their forwards' statistics and preps,
    within the fp32 limits."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[0]
    q, k, v, dmix, _, m = _wgmma_inputs(b, length, h, mask, cuda_device,
                                        torch.float32)
    g1 = _wgmma_backward("mega", q, k, v, m, dmix, segs, ratios)
    g3 = _wgmma_backward("fused", q, k, v, m, dmix, segs, ratios)
    chip_smoke.check_grads(("dq", "dk", "dv"), g1, g3, dmix, "float32",
                           "mega vs fused")


def test_tf32x3_functions_count_by_family(cuda_device):
    """The autograd Functions at fp32, D = 48 run K1b and K3b on the 3xTF32
    family, counted in BWD_LAUNCHES and by family; at D = 16 on the CUDA
    cores."""
    kw = dict(segment_lengths=(64, 128), dilated_ratios=(1, 2))
    for d, fam in ((48, "tf32x3"), (16, "cuda_cores")):
        q, k, v = (_randn((1, 128, 4, d), s, cuda_device).requires_grad_()
                   for s in (36, 37, 38))
        for mod, fn in ((dm, dm.mega_dilated_attention),
                        (df, df.fused_dilated_attention)):
            mod.BWD_LAUNCHES = 0
            mod.BWD_FAMILY_LAUNCHES.update(
                dict.fromkeys(mod.BWD_FAMILY_LAUNCHES, 0))
            fn(q, k, v, **kw).sum().backward()
            assert mod.BWD_LAUNCHES == mod.BWD_FAMILY_LAUNCHES[fam] == 1, \
                (mod.__name__, d, mod.BWD_FAMILY_LAUNCHES)


def test_tf32x3_raises_on_a_misaligned_tensor(cuda_device):
    """The 3xTF32 core gathers 16-byte chunks: an operand off 16 bytes
    raises in either route's backward; it never falls back to the CUDA
    cores."""
    x = _randn((1, 64 * 16 * 48 + 4), 39, cuda_device)
    q = x[0, 1:1 + 64 * 16 * 48].view(1, 64, 16, 48)   # 4 bytes off
    a = q.clone()                          # a fresh, aligned allocation
    scale = 48 ** -0.5
    _, stats = dm.mega_dilated_attention_cuda(a, a, a, None, (64,), (1,),
                                              scale, with_stats=True)
    with pytest.raises(RuntimeError):
        dm.mega_dilated_attention_backward_cuda(q, q, q, None, a, stats,
                                                (64,), (1,), scale)
    _, _, lse_c, st = df.fused_dilated_attention_cuda(
        a, a, a, None, (64,), (1,), scale)
    with pytest.raises(RuntimeError):
        df.fused_dilated_attention_backward_cuda(
            q, q, q, None, a, lse_c, st, (64,), (1,), scale)


@pytest.mark.parametrize("n", [2, 4])
def test_tf32x3_range_gives_the_whole_calls_rows(cuda_device, n):
    """K1b at fp32 with each of ``n`` token ranges (the sequence-parallel
    shards' rows, fed K1f's stats with the range): dq is 0 outside the
    range and the whole call's bits inside it; the ranges' dk and dv sum
    to the whole call's within the fp32 limits."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[1]
    q, k, v, dmix, m, arg = _wgmma_inputs(b, length, h, mask, cuda_device,
                                          torch.float32)
    scale = 48 ** -0.5
    _, whole_stats = dm.mega_dilated_attention_cuda(
        q, k, v, arg, segs, ratios, scale, with_stats=True)
    whole = dm.mega_dilated_attention_backward_cuda(
        q, k, v, arg, dmix, whole_stats, segs, ratios, scale)
    size = length // n
    dk_sum, dv_sum = torch.zeros_like(q), torch.zeros_like(q)
    for i in range(n):
        rng = (i * size, (i + 1) * size)
        _, stats = dm.mega_dilated_attention_cuda(
            q, k, v, arg, segs, ratios, scale, with_stats=True,
            q_token_range=rng)
        dq, dk, dv = dm.mega_dilated_attention_backward_cuda(
            q, k, v, arg, dmix, stats, segs, ratios, scale,
            q_token_range=rng)
        outside = torch.ones(length, dtype=torch.bool, device=cuda_device)
        outside[rng[0]:rng[1]] = False
        assert not dq[:, outside].any()
        assert torch.equal(dq[:, rng[0]:rng[1]], whole[0][:, rng[0]:rng[1]])
        dk_sum += dk
        dv_sum += dv
    chip_smoke.check_grads(("dk", "dv"), (dk_sum, dv_sum), whole[1:], dmix,
                           "float32", f"{n} ranges")


# ---------------------------------------------------------------------------
# K1f and K3f: the tensor-core family (bf16, D = 48)
# ---------------------------------------------------------------------------

FWD_ROUTES = ["mega", "mega_stats", "fused"]


def _wgmma_forward(route, q, k, v, m, segs, ratios):
    """``(out, planes)``: the route's output and its planes, K1's
    ``(stats,)`` or K3's ``(out_c, lse_c, stats)``."""
    scale = 48 ** -0.5
    if route == "fused":
        mixed, *planes = df.fused_dilated_attention_cuda(q, k, v, m, segs,
                                                         ratios, scale)
        return mixed, planes
    if route == "mega":
        return dm.mega_dilated_attention_cuda(q, k, v, m, segs, ratios,
                                              scale), []
    out, *planes = dm.mega_dilated_attention_cuda(q, k, v, m, segs, ratios,
                                                  scale, with_stats=True)
    return out, planes


@pytest.mark.parametrize("route", FWD_ROUTES)
@pytest.mark.parametrize("b,length,h,segs,ratios,mask", WGMMA_CASES,
                         ids=WGMMA_IDS)
def test_wgmma_forward_matches_plain(cuda_device, route, b, length, h, segs,
                                     ratios, mask):
    """K1f (with and without stats) and K3f in the tensor-core family
    against the plain versions (fp32 on the same bf16 values): the output
    by ``chip_smoke.check_out`` (rel-L2 <= 1e-2, row-scaled <= 2e-2) and
    the max-scaled bound 1.6e-2 on the valid rows; K1's stats plane and
    K3's (m, Z) and compact lse within 1e-3 with NEG_INF exactly where the
    plain version has it; K3's compact ``out_b`` by ``check_out``; a batch row without a valid key
    all 0; a rerun bit-equal; the family the entry points' rule names."""
    assert df.card_family(48, torch.bfloat16) == \
        df.family(48, torch.bfloat16) == "wgmma"
    q, k, v, _, m, arg = _wgmma_inputs(b, length, h, mask, cuda_device)
    valid = m[:, :, None, None]
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=arg)
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 48 ** -0.5
    got, planes = _wgmma_forward(route, q, k, v, arg, segs, ratios)
    want = dilated_attention(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    chip_smoke.compare(got.float() * valid, want * valid, 1.6e-2, route)
    chip_smoke.check_out(got.float() * valid, want * valid, "bfloat16",
                         route)
    n = len(segs)
    want_st = dilated_attention_stats(qf, kf, vf, **kw)
    branches = [df.fused_branch_reference(qf, kf, vf, arg, w, r, scale)
                for w, r in zip(segs, ratios)]
    if route == "mega_stats":
        stats, = planes
        assert ((stats == NEG_INF) == (want_st == NEG_INF)).all()
        assert (stats - want_st).abs().max().item() <= 1e-3
    if route == "fused":
        out_c, lse_c, stats = planes
        got_st = stats.reshape(2, b * h, length).transpose(0, 1)
        assert ((got_st == NEG_INF) == (want_st[:, n:] == NEG_INF)).all()
        assert (got_st - want_st[:, n:]).abs().max().item() <= 1e-3
        outs = df.split_branches(out_c, length, segs, ratios)
        lses = df.split_branches(lse_c, length, segs, ratios)
        for i, (want_o, want_l) in enumerate(branches):
            assert ((lses[i] == NEG_INF) == (want_l == NEG_INF)).all()
            assert (lses[i] - want_l).abs().max().item() <= 1e-3
            chip_smoke.check_out(outs[i].float(), want_o, "bfloat16",
                                 f"out_c {i}")
            assert (outs[i][want_l == NEG_INF] == 0).all()
    if mask == "dead":
        assert (got[1] == 0).all()
    again, planes_again = _wgmma_forward(route, q, k, v, arg, segs, ratios)
    assert torch.equal(got, again)
    assert all(torch.equal(x, y) for x, y in zip(planes, planes_again))


def test_wgmma_forward_routes_agree(cuda_device):
    """K1f and K3f share the forward core and the mix: from the same inputs
    their outputs are the same bits, and K1's stats carry K3's (m, Z)."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[0]
    q, k, v, _, _, m = _wgmma_inputs(b, length, h, mask, cuda_device)
    out1, (stats,) = _wgmma_forward("mega_stats", q, k, v, m, segs, ratios)
    out3, (_, _, mz) = _wgmma_forward("fused", q, k, v, m, segs, ratios)
    n = len(segs)
    assert torch.equal(out1, out3)
    assert torch.equal(stats[:, n:], mz.reshape(2, b * h, length)
                       .transpose(0, 1))


# ---------------------------------------------------------------------------
# K1f and K3f: the 3xTF32 family (fp32, D = 48)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", FWD_ROUTES)
@pytest.mark.parametrize("b,length,h,segs,ratios,mask", WGMMA_CASES,
                         ids=WGMMA_IDS)
def test_tf32x3_forward_matches_plain(cuda_device, route, b, length, h, segs,
                                      ratios, mask):
    """K1f (with and without stats) and K3f at fp32 and D = 48 (the 3xTF32
    forward core, the family the entry points choose) against the plain
    versions in fp32 on the valid rows: the output by
    ``chip_smoke.check_out``'s fp32 limits (rel-L2 <= 1e-5, row-scaled
    <= 5e-5) and the max-scaled bound 2e-4; K1's stats plane and K3's
    (m, Z) and compact lse within 1e-3 with NEG_INF exactly where the
    plain version has it; K3's compact ``out_b`` by ``check_out``; a batch
    row without a valid key all 0; a rerun bit-equal."""
    assert df.card_family(48, torch.float32) == \
        df.family(48, torch.float32) == "tf32x3"
    q, k, v, _, m, arg = _wgmma_inputs(b, length, h, mask, cuda_device,
                                       torch.float32)
    valid = m[:, :, None, None]
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=arg)
    scale = 48 ** -0.5
    got, planes = _wgmma_forward(route, q, k, v, arg, segs, ratios)
    want = dilated_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    chip_smoke.compare(got * valid, want * valid, 2e-4, route)
    chip_smoke.check_out(got * valid, want * valid, "float32", route)
    n = len(segs)
    want_st = dilated_attention_stats(q, k, v, **kw)
    if route == "mega_stats":
        stats, = planes
        assert ((stats == NEG_INF) == (want_st == NEG_INF)).all()
        assert (stats - want_st).abs().max().item() <= 1e-3
    if route == "fused":
        out_c, lse_c, stats = planes
        assert out_c.dtype == torch.float32
        got_st = stats.reshape(2, b * h, length).transpose(0, 1)
        assert ((got_st == NEG_INF) == (want_st[:, n:] == NEG_INF)).all()
        assert (got_st - want_st[:, n:]).abs().max().item() <= 1e-3
        outs = df.split_branches(out_c, length, segs, ratios)
        lses = df.split_branches(lse_c, length, segs, ratios)
        for i, (w, r) in enumerate(zip(segs, ratios)):
            want_o, want_l = df.fused_branch_reference(q, k, v, arg, w, r,
                                                       scale)
            assert ((lses[i] == NEG_INF) == (want_l == NEG_INF)).all()
            assert (lses[i] - want_l).abs().max().item() <= 1e-3
            chip_smoke.check_out(outs[i], want_o, "float32", f"out_c {i}")
            assert (outs[i][want_l == NEG_INF] == 0).all()
    if mask == "dead":
        assert (got[1] == 0).all()
    again, planes_again = _wgmma_forward(route, q, k, v, arg, segs, ratios)
    assert torch.equal(got, again)
    assert all(torch.equal(x, y) for x, y in zip(planes, planes_again))


def test_tf32x3_forward_routes_agree(cuda_device):
    """At fp32 K1f and K3f share the 3xTF32 forward core and the mix: from
    the same inputs their outputs are the same bits, and K1's stats carry
    K3's (m, Z)."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[0]
    q, k, v, _, _, m = _wgmma_inputs(b, length, h, mask, cuda_device,
                                     torch.float32)
    out1, (stats,) = _wgmma_forward("mega_stats", q, k, v, m, segs, ratios)
    out3, (_, _, mz) = _wgmma_forward("fused", q, k, v, m, segs, ratios)
    n = len(segs)
    assert torch.equal(out1, out3)
    assert torch.equal(stats[:, n:], mz.reshape(2, b * h, length)
                       .transpose(0, 1))


def test_forwards_count_by_family(cuda_device):
    """K1f and K3f count their launches by family: at D = 48 bf16 on
    wgmma and fp32 on 3xTF32, at D = 16 on the CUDA cores; K1f with a
    token range in QRANGE_LAUNCHES alone."""
    kw = dict(segment_lengths=(64, 128), dilated_ratios=(1, 2))
    for d, dtype, fam in ((48, torch.bfloat16, "wgmma"),
                          (48, torch.float32, "tf32x3"),
                          (16, torch.float32, "cuda_cores")):
        q = _randn((1, 128, 4, d), 40, cuda_device, dtype)
        for mod, fn in ((dm, dm.mega_dilated_attention),
                        (df, df.fused_dilated_attention)):
            mod.LAUNCHES = 0
            mod.FAMILY_LAUNCHES.update(dict.fromkeys(mod.FAMILY_LAUNCHES, 0))
            fn(q, q, q, **kw)
            assert mod.LAUNCHES == mod.FAMILY_LAUNCHES[fam] == 1, \
                (mod.__name__, d, dtype, mod.FAMILY_LAUNCHES)
        dm.mega_dilated_attention(q, q, q, q_token_range=(0, 64), **kw)
        assert dm.LAUNCHES == sum(dm.FAMILY_LAUNCHES.values()) == 1


def test_tf32x3_forward_raises_on_a_misaligned_tensor(cuda_device):
    """The 3xTF32 forward core gathers 16-byte chunks: an operand off 16
    bytes raises in either route's forward; it never falls back to the
    CUDA cores."""
    x = _randn((1, 64 * 16 * 48 + 4), 41, cuda_device)
    q = x[0, 1:1 + 64 * 16 * 48].view(1, 64, 16, 48)   # 4 bytes off
    a = q.clone()                          # a fresh, aligned allocation
    scale = 48 ** -0.5
    with pytest.raises(RuntimeError):
        dm.mega_dilated_attention_cuda(q, a, a, None, (64,), (1,), scale)
    with pytest.raises(RuntimeError):
        dm.mega_dilated_attention_cuda(a, a, q, None, (64,), (1,), scale,
                                       with_stats=True)
    with pytest.raises(RuntimeError):
        df.fused_dilated_attention_cuda(a, q, a, None, (64,), (1,), scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_parts_give_the_whole_calls_bits(cuda_device, dtype):
    """K3f's forward core and mix launched one at a time (as chip_smoke.py
    times them) give the whole call's bits in both tensor-core families,
    and count in PART_LAUNCHES alone; the CUDA-core family's core is
    refused."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[0]
    q, k, v, _, _, m = _wgmma_inputs(b, length, h, mask, cuda_device, dtype)
    scale = 48 ** -0.5
    mixed, out_c, lse_c, stats = df.fused_dilated_attention_cuda(
        q, k, v, m, segs, ratios, scale)
    df.LAUNCHES = 0
    df.PART_LAUNCHES.update(core=0, mix=0)
    pieces = df.fused_forward_part_cuda("core", q, k, v, m, segs, ratios,
                                        scale)
    mixed2, stats2 = df.fused_forward_part_cuda("mix", q, k, v, m, segs,
                                                ratios, scale, pieces)
    assert torch.equal(pieces[0], out_c) and torch.equal(pieces[1], lse_c)
    assert torch.equal(mixed2, mixed) and torch.equal(stats2, stats)
    assert df.LAUNCHES == 0 and df.PART_LAUNCHES == dict(core=1, mix=1)
    x = _randn((1, 64, 4, 16), 42, cuda_device, dtype)
    with pytest.raises(RuntimeError):
        df.fused_forward_part_cuda("core", x, x, x, None, (64,), (1,), 0.25)


@pytest.mark.parametrize("n", [2, 4])
def test_tf32x3_forward_range_gives_the_whole_calls_rows(cuda_device, n):
    """K1f at fp32 with each of ``n`` token ranges (the sequence-parallel
    shards' rows): with and without stats the rows of the range are the
    whole call's bits, every row outside it exactly 0, and the range's
    stats columns the whole call's."""
    b, length, h, segs, ratios, mask = WGMMA_CASES[1]
    q, k, v, _, _, arg = _wgmma_inputs(b, length, h, mask, cuda_device,
                                       torch.float32)
    scale = 48 ** -0.5
    whole, whole_stats = dm.mega_dilated_attention_cuda(
        q, k, v, arg, segs, ratios, scale, with_stats=True)
    size = length // n
    for i in range(n):
        rng = (i * size, (i + 1) * size)
        part = dm.mega_dilated_attention_cuda(q, k, v, arg, segs, ratios,
                                              scale, q_token_range=rng)
        out, stats = dm.mega_dilated_attention_cuda(
            q, k, v, arg, segs, ratios, scale, with_stats=True,
            q_token_range=rng)
        assert torch.equal(part, out)
        assert torch.equal(out[:, rng[0]:rng[1]], whole[:, rng[0]:rng[1]])
        outside = torch.ones(length, dtype=torch.bool, device=cuda_device)
        outside[rng[0]:rng[1]] = False
        assert not out[:, outside].any()
        assert torch.equal(stats[..., rng[0]:rng[1]],
                           whole_stats[..., rng[0]:rng[1]])


# ---------------------------------------------------------------------------
# K5: fused GELU -> LayerNorm
# ---------------------------------------------------------------------------

# (rows shape, F, dtype of x, dtype of gamma/beta): F = 3072 and 384 take
# 4-wide loads, 1000 too, 77 and 3 do not; one row; bf16 parameters as the
# frozen backbone holds them, fp32 ones as an unfrozen model would.
GELU_LN_CASES = [
    ((33,), 3072, torch.float32, torch.float32),
    ((3, 50), 384, torch.float32, torch.float32),
    ((1,), 3072, torch.float32, torch.float32),
    ((7,), 77, torch.float32, torch.float32),
    ((5,), 3, torch.float32, torch.float32),
    ((600,), 1000, torch.float32, torch.float32),
    ((33,), 3072, torch.bfloat16, torch.bfloat16),
    ((3, 50), 384, torch.bfloat16, torch.float32),
    ((1,), 3072, torch.bfloat16, torch.bfloat16),
    ((7,), 77, torch.bfloat16, torch.bfloat16),
    ((2000,), 256, torch.bfloat16, torch.bfloat16),
]


def _gelu_ln_inputs(rows, f, dtype, pdtype, device):
    g = torch.Generator().manual_seed(31)
    x = (torch.randn(rows + (f,), generator=g) * 1.5).to(device, dtype)
    dy = torch.randn(rows + (f,), generator=g).to(device, dtype)
    scale = (1.0 + 0.2 * torch.randn(f, generator=g)).to(device, pdtype)
    bias = (0.1 * torch.randn(f, generator=g)).to(device, pdtype)
    return x, dy, scale, bias


@pytest.mark.parametrize("rows,f,dtype,pdtype", GELU_LN_CASES)
def test_gelu_ln_kernel_matches_plain(cuda_device, rows, f, dtype, pdtype):
    x, _, scale, bias = _gelu_ln_inputs(rows, f, dtype, pdtype, cuda_device)
    got = gl.gelu_ln_cuda(x, scale, bias, 1e-5)
    want = gl.gelu_ln_reference(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    # fp32: the row sums run in another order; bf16: one ulp of the result
    # where the fp32 values straddle a rounding boundary
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("rows,f,dtype,pdtype", GELU_LN_CASES)
def test_gelu_ln_backward_kernel_matches_plain(cuda_device, rows, f, dtype,
                                               pdtype):
    x, dy, scale, _ = _gelu_ln_inputs(rows, f, dtype, pdtype, cuda_device)
    got = gl.gelu_ln_backward_cuda(x, scale, dy, 1e-5)
    want = gl.gelu_ln_backward_reference(x, scale, dy, 1e-5)
    # dgamma, dbeta: the plain version's fp32 sums, before its last cast
    want32 = gl.gelu_ln_backward_reference(x, scale.float(), dy, 1e-5)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == pdtype
    for name, g_, w_ in zip(("dx", "dgamma", "dbeta"), got,
                            (want[0], want32[1], want32[2])):
        assert torch.isfinite(g_).all(), name
        _assert_grad_readings(g_.reshape(-1, f), w_.reshape(-1, f),
                              dy.reshape(-1, f), name)
    again = gl.gelu_ln_backward_cuda(x, scale, dy, 1e-5)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), \
        "the backward is not deterministic"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_ln_function_runs_both_kernels(cuda_device, dtype):
    x, dy, scale, bias = _gelu_ln_inputs((40,), 384, dtype, torch.float32,
                                         cuda_device)
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    gl.LAUNCHES = gl.BWD_LAUNCHES = 0
    got = torch.autograd.grad(gl.gelu_ln(*leaves), leaves, dy)
    assert (gl.LAUNCHES, gl.BWD_LAUNCHES) == (1, 1)
    want = gl.gelu_ln_backward_reference(x, scale, dy)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        err = (g_.float() - w_.float()).abs().max().item()
        assert err <= (GRAD_TOL if dtype == torch.float32 else 2e-2) * max(
            1.0, w_.float().abs().max().item())


def test_gelu_ln_wrapper_raises_instead_of_falling_back(cuda_device):
    x, dy, scale, bias = _gelu_ln_inputs((4,), 64, torch.float32,
                                         torch.float32, cuda_device)
    with pytest.raises(TypeError):
        gl.gelu_ln(x.half(), scale.half(), bias.half())
    with pytest.raises(ValueError):                    # F over the range
        wide = torch.zeros(2, gl.MAX_FEATURES + 4, device=cuda_device)
        gl.gelu_ln(wide, wide[0], wide[0])
    with pytest.raises(ValueError):                    # bf16 gamma, fp32 x
        gl.gelu_ln_cuda(x, scale.bfloat16(), bias.bfloat16())
    with pytest.raises(ValueError):                    # scale on the host
        gl.gelu_ln_cuda(x, scale.cpu(), bias)
    with pytest.raises(ValueError):                    # dy of another shape
        gl.gelu_ln_backward_cuda(x, scale, dy[:2])


# The row-resident route (bf16 x, F = ROW_WIDTH, every pointer 16-byte
# aligned; GELU_LN_CASES's bf16 F = 3072 cases take it too): one row, row
# counts that leave the last group of a block empty (odd), two rows for
# each of an H100's 132 SMs, and more rows than the grid has groups (a
# group walks several), rows of a 3-D tensor, gamma and beta in either
# dtype.
GELU_LN_ROW_CASES = [
    ((1,), 3072, torch.bfloat16),
    ((3,), 3072, torch.float32),
    ((2, 257), 3072, torch.bfloat16),
    ((264,), 3072, torch.bfloat16),
    ((5001,), 3072, torch.bfloat16),
    ((5001,), 3072, torch.float32),
    ((2, 3, 13), 3072, torch.float32),
]


@pytest.mark.parametrize("rows,f,pdtype", GELU_LN_ROW_CASES)
def test_gelu_ln_row_route_matches_plain(cuda_device, rows, f, pdtype):
    """Both kernels and both backward variants on the row-resident route
    against the plain versions (the bf16 limits of chip_smoke.py, the
    output also by ``chip_smoke.check_out``), the variant without
    dgamma/dbeta giving the same dx bits, and reruns of each
    bit-identical."""
    x, dy, scale, bias = _gelu_ln_inputs(rows, f, torch.bfloat16, pdtype,
                                         cuda_device)
    assert gl.route(x.dtype, f, x.data_ptr(), dy.data_ptr(),
                    scale.data_ptr(), bias.data_ptr()) == "rows"
    gl.ROWS_LAUNCHES = gl.BWD_ROWS_LAUNCHES = gl.BWD_DX_ONLY_LAUNCHES = 0
    y = gl.gelu_ln_cuda(x, scale, bias, 1e-5)
    full = gl.gelu_ln_backward_cuda(x, scale, dy, 1e-5)
    dx_only = gl.gelu_ln_backward_cuda(x, scale, dy, 1e-5, param_grads=False)
    torch.cuda.synchronize()
    assert (gl.ROWS_LAUNCHES, gl.BWD_ROWS_LAUNCHES,
            gl.BWD_DX_ONLY_LAUNCHES) == (1, 2, 1)
    want = gl.gelu_ln_reference(x, scale, bias, 1e-5)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2 * max(1.0, want.float().abs().max().item()), err
    chip_smoke.check_out(y, want, "bfloat16", "K5f out")
    want_dx = gl.gelu_ln_backward_reference(x, scale, dy, 1e-5)[0]
    want32 = gl.gelu_ln_backward_reference(x, scale.float(), dy, 1e-5)
    assert full[1].dtype == pdtype
    for name, g_, w_ in zip(("dx", "dgamma", "dbeta"), full,
                            (want_dx, want32[1], want32[2])):
        assert torch.isfinite(g_).all(), name
        _assert_grad_readings(g_.reshape(-1, f), w_.reshape(-1, f),
                              dy.reshape(-1, f), name)
    assert dx_only[1] is None and dx_only[2] is None
    assert torch.equal(dx_only[0], full[0])
    assert torch.equal(gl.gelu_ln_cuda(x, scale, bias, 1e-5), y)
    again = gl.gelu_ln_backward_cuda(x, scale, dy, 1e-5)
    assert all(torch.equal(a, b_) for a, b_ in zip(full, again))
    assert torch.equal(gl.gelu_ln_backward_cuda(
        x, scale, dy, 1e-5, param_grads=False)[0], dx_only[0])


@pytest.mark.parametrize("frozen", [True, False])
def test_gelu_ln_function_skips_param_grads_when_frozen(cuda_device, frozen):
    """Through autograd: with gamma and beta frozen (the train step) the
    backward runs the variant without dgamma/dbeta; unfrozen, the one with
    them; both on the row-resident route, against the plain version."""
    x, dy, scale, bias = _gelu_ln_inputs((3, 100), 3072, torch.bfloat16,
                                         torch.bfloat16, cuda_device)
    leaves = [x.detach().requires_grad_(),
              scale.detach().requires_grad_(not frozen),
              bias.detach().requires_grad_(not frozen)]
    gl.ROWS_LAUNCHES = gl.BWD_ROWS_LAUNCHES = gl.BWD_DX_ONLY_LAUNCHES = 0
    gl.gelu_ln(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert (gl.ROWS_LAUNCHES, gl.BWD_ROWS_LAUNCHES,
            gl.BWD_DX_ONLY_LAUNCHES) == (1, 1, int(frozen))
    want = gl.gelu_ln_backward_reference(x, scale.float(), dy)
    _assert_grad_readings(leaves[0].grad.reshape(-1, 3072),
                          gl.gelu_ln_backward_reference(x, scale, dy)[0]
                          .reshape(-1, 3072), dy.reshape(-1, 3072), "dx")
    if frozen:
        assert leaves[1].grad is None and leaves[2].grad is None
    else:
        for name, g_, w_ in zip(("dgamma", "dbeta"), leaves[1:], want[1:]):
            _assert_grad_readings(g_.grad[None], w_[None],
                                  dy.reshape(-1, 3072), name)


def test_gelu_ln_route_and_frame_match_the_entry_points(cuda_device):
    """The C rule (``mt_gelu_ln_route``, which the wrappers ask) and the
    CPU's copy (``gl.route``) agree, and the frame's constants that the
    wrapper and the CPU emulation copy equal the library's."""
    aligned, off = (1 << 20, 1 << 21), (1 << 20, (1 << 21) + 8)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for f in (384, 1024, 2048, 3064, 3072, 3080, 4096):
            for ptrs in (aligned, off):
                assert gl.card_route(dtype, f, *ptrs) == \
                    gl.route(dtype, f, *ptrs), (dtype, f, ptrs)
    assert gl.card_row_frame() == (gl.ROW_WIDTH, gl.ROW_WARPS,
                                   gl.ROW_GROUPS, gl.REDUCE_ROWS)


def test_gelu_ln_unaligned_rows_take_the_generic_route(cuda_device):
    """bf16 rows at F = 3072 that start 8 bytes off a 16-byte boundary run
    the generic kernels, right; the C entry points refuse them, and bf16
    rows of another width, on the row-resident route."""
    base = _randn((4 * 3072 + 4,), 33, cuda_device, torch.bfloat16)
    x = base[4:].view(4, 3072)
    _, dy, scale, bias = _gelu_ln_inputs((4,), 3072, torch.bfloat16,
                                         torch.bfloat16, cuda_device)
    assert gl.route(x.dtype, 3072, x.data_ptr()) == "generic"
    gl.ROWS_LAUNCHES = gl.BWD_ROWS_LAUNCHES = 0
    y = gl.gelu_ln_cuda(x, scale, bias)
    dx = gl.gelu_ln_backward_cuda(x, scale, dy, param_grads=False)[0]
    torch.cuda.synchronize()
    assert (gl.ROWS_LAUNCHES, gl.BWD_ROWS_LAUNCHES) == (0, 0)
    want = gl.gelu_ln_reference(x, scale, bias)
    assert (y.float() - want.float()).abs().max().item() <= 1.6e-2 * max(
        1.0, want.float().abs().max().item())
    _assert_grad_readings(dx, gl.gelu_ln_backward_reference(x, scale, dy)[0],
                          dy, "dx")
    lib = gl.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.mt_gelu_ln_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                             torch.empty_like(dy).data_ptr(), 4, 3072, 1e-5,
                             1, 1, 1, stream)
    assert err != 0
    narrow = torch.zeros(4, 2048, dtype=torch.bfloat16, device=cuda_device)
    err = lib.mt_gelu_ln_fwd(narrow.data_ptr(), narrow[0].data_ptr(),
                             narrow[0].data_ptr(), torch.empty_like(
                                 narrow).data_ptr(), 4, 2048, 1e-5, 1, 1, 1,
                             stream)
    assert err != 0


# ---------------------------------------------------------------------------
# Rematerialization of the LongNet layers (models/longnet.py) on the card
# ---------------------------------------------------------------------------

def _launch_counts():
    """(K1f, K1b, K3f, K3b, K5f, K5b) launches since the last reset."""
    return (dm.LAUNCHES, dm.BWD_LAUNCHES, df.LAUNCHES, df.BWD_LAUNCHES,
            gl.LAUNCHES, gl.BWD_LAUNCHES)


@pytest.mark.parametrize("route,policy", [
    *(pytest.param("default", p, id=p) for p in ("flash", "flash_ffn",
                                                 "full")),
    *(pytest.param("fused", p, id=f"fused-{p}") for p in ("flash", "full"))])
def test_remat_train_step_is_bit_equal_to_remat_off(cuda_device, route,
                                                    policy):
    """ModalTune-GigaPath at full width, one grad step at the 2,047 bucket
    from the same weights, batch and generator state (dropout on) with
    remat off and under ``policy``: the loss and every adapter gradient
    bit-equal. On the default route (K1) K1f launched once a layer (twice
    under ``"full"``, whose backward runs the attention again) and K1b
    once; on the fused route (K3 for K1, K5 for the FFN chain) K3f and K3b
    the same, K5f twice (the backward runs the FFN past fc1 again under
    every policy) and K5b once."""
    kw = dict(chip_smoke.GIGAPATH if route == "default"
              else chip_smoke.GIGAPATH_FUSED, **chip_smoke.GIGAPATH_2047)
    reads, launches = {}, {}
    for name, remat in (("off", False), (policy, True)):
        model, tcfg, _, text, batch = chip_smoke.build_train(
            cuda_device, **chip_smoke.with_remat(kw, remat, policy))
        dm.LAUNCHES = dm.BWD_LAUNCHES = df.LAUNCHES = df.BWD_LAUNCHES = 0
        gl.LAUNCHES = gl.BWD_LAUNCHES = 0
        reads[name] = chip_smoke.grad_step_readings(cuda_device, model, tcfg,
                                                    text, batch)
        launches[name] = _launch_counts()
        layers = len(model.backbone.encoder.layers)
        del model
    diff, differ = chip_smoke.step_difference(reads[policy], reads["off"])
    assert diff == 0.0 and not differ, (diff, differ[:5])
    again = 2 if policy == "full" else 1
    if route == "default":
        off, want = (layers, layers, 0, 0, 0, 0), (again * layers, layers,
                                                   0, 0, 0, 0)
    else:
        off = (0, 0) + (layers,) * 4
        want = (0, 0, again * layers, layers, 2 * layers, layers)
    assert launches["off"] == off, launches
    assert launches[policy] == want, launches
