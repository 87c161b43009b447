"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips (inside the ``cuda_device`` fixture)
where there is no CUDA device, as on a CPU-only machine. Run them on the
GPU with (the JAX package's ``tests/conftest.py`` imports jax, which a
GPU machine for the port need not have)

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

These cover the edge cases that the full-size shapes of ``chip_smoke.py``
do not: ragged tile edges, head dimensions that pad, segments shorter
than a query tile, head groups without heads, a missing mask, and the
wrappers raising on what the kernels do not take.
"""

import importlib

import pytest
import torch

from modaltune_tpu_torch.ops import NEG_INF
from modaltune_tpu_torch.ops.dilated import dilated_attention

fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")

pytestmark = pytest.mark.cuda

# fp32 kernel against the fp32 plain version: the sums run in another
# order (online softmax, fp32 FMA) — a few ulp of the output scale.
TOL = 2e-5


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
