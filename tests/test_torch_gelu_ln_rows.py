"""A step-by-step emulation of the row-resident K5 kernels on the CPU.

The bf16 route of the fused GELU -> LayerNorm kernels
(``gelu_ln_fwd_rows_kernel``, ``gelu_ln_bwd_rows_kernel`` in
``modaltune_tpu_torch/csrc/gelu_ln_{fwd,bwd}.cu``, on the frame of
``csrc/gelu_ln_common.cuh``) cannot run here, so its arithmetic is written
out in PyTorch in the kernels' order:

* a group of ``WARPS`` warps owns a row; lane t holds the 16-byte vectors
  t, t + LANES, ... of 8 elements each (:func:`lane_columns`);
* each lane sums its elements in element order, each warp forms a
  butterfly of its lanes' sums and the group adds the warps' sums in warp
  order (:func:`group_sum`), for (sum g, sum g^2) and then (sum dyg, sum
  dyg xhat);
* Phi(x) is evaluated once and used for g and again for dx;
* dgamma and dbeta: each lane sums its columns over its group's rows
  (group i of block b takes rows b GROUPS + i + k n_blocks GROUPS), the
  groups of a block add theirs in group order into the block's partial
  row, and the reduce kernel adds the partial rows, every REDUCE_ROWS-th
  in each of its thread rows and those sums in order;
* the variant without dgamma and dbeta computes dx alone.

The emulation is held, with numpy inputs from a seed, against the JAX
package's Pallas kernels in interpret mode (``_fwd_call``, ``_bwd_call``) in
fp32 at the tolerances of ``tests/test_torch_gelu_ln.py``, and against the
port's plain versions in bf16 at ``chip_smoke.py``'s limits. The wrapper's
choice of route (row-resident or generic) and of backward variant (from
``needs_input_grad``) are tested as pure functions, and through autograd
and a train step on the fused route.
"""

import importlib
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jgl = importlib.import_module("modaltune_tpu.ops.gelu_ln")
tgl = importlib.import_module("modaltune_tpu_torch.ops.gelu_ln")


def _load_chip_smoke():
    """``chip_smoke.py`` of the repository root as a module: its
    ``compare`` and ``check_grads`` are the card's gates."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()

# the frame's constants (csrc/gelu_ln_common.cuh) and the reduce kernel's
# thread rows (csrc/gelu_ln_bwd.cu), as the wrapper copies them; the card
# tests hold the copies equal to the library's
WARPS = tgl.ROW_WARPS
LANES = 32 * WARPS
GROUPS = tgl.ROW_GROUPS
REDUCE_ROWS = tgl.REDUCE_ROWS
F = tgl.ROW_WIDTH

EPS = 1e-5
INV_SQRT2 = 1.0 / math.sqrt(2.0)
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
# fp32 against the interpret-mode Pallas kernels: the limits of
# tests/test_torch_gelu_ln.py (forward 1e-6; dx elementwise, dgamma and
# dbeta sums over the rows in another order)
FWD_TOL = 1e-6
BWD_TOL = ((1e-5, 1e-5), (2e-3, 1e-3), (2e-3, 1e-3))


def lane_columns(f):
    """(LANES, 8 V) int64: the column of lane t's element j,
    (j // 8 * LANES + t) * 8 + j % 8."""
    t = torch.arange(LANES)[:, None]
    j = torch.arange(f // LANES)[None, :]
    return (j // 8 * LANES + t) * 8 + j % 8


def lane_sums(a, cols):
    """(rows, f) fp32 -> (rows, LANES): each lane's sum of its elements, in
    element order, from 0."""
    per_lane = a[:, cols]
    s = torch.zeros(per_lane.shape[:2])
    for j in range(per_lane.shape[-1]):
        s = s + per_lane[..., j]
    return s


def group_sum(lanes):
    """(rows, LANES) -> (rows, LANES): every lane's copy of the group's sum,
    a butterfly (own value + partner's) in each warp, then the warps' sums
    in warp order."""
    v = lanes.reshape(lanes.shape[0], WARPS, 32)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ o]
    s = v[:, 0]
    for w in range(1, WARPS):
        s = s + v[:, w]
    return s


def _row_stats(x2, f):
    """x32, Phi(x), g (rounded to x's dtype) and the group's (mu, rstd) of
    each row, as the kernels form them."""
    x32 = x2.float()
    cdf = 0.5 * (1.0 + torch.erf(x32 * INV_SQRT2))
    g = (x32 * cdf).to(x2.dtype).float()
    cols = lane_columns(f)
    s = group_sum(lane_sums(g, cols))[:, :1]
    ss = group_sum(lane_sums(g * g, cols))[:, :1]
    mu = s / f
    rstd = torch.rsqrt(torch.clamp_min(ss / f - mu * mu, 0.0) + EPS)
    return x32, cdf, g, mu, rstd


def emulate_forward(x, scale, bias):
    """The row-resident K5f on ``x`` (..., f)."""
    f = x.shape[-1]
    x2 = x.reshape(-1, f)
    _, _, g, mu, rstd = _row_stats(x2, f)
    y = (g - mu) * rstd * scale.float() + bias.float()
    return y.to(x.dtype).reshape(x.shape)


def emulate_column_sums(a, n_blocks):
    """(rows, f) fp32 -> (f,): the kernels' fixed-order column sum over the
    rows of ``a`` on a grid of ``n_blocks`` blocks."""
    rows, f = a.shape
    stride = n_blocks * GROUPS
    k_rows = -(-rows // stride)
    padded = torch.zeros(k_rows * stride, f)
    padded[:rows] = a
    # row b GROUPS + i + k stride -> [k, b, i]
    per = padded.reshape(k_rows, n_blocks, GROUPS, f)
    acc = torch.zeros(n_blocks, GROUPS, f)
    for k in range(k_rows):                 # each lane over its rows
        acc = acc + per[k]
    part = acc[:, 0]
    for i in range(1, GROUPS):              # the block's groups in order
        part = part + acc[:, i]
    b_rows = -(-n_blocks // REDUCE_ROWS) * REDUCE_ROWS
    parts = torch.zeros(b_rows, f)
    parts[:n_blocks] = part
    parts = parts.reshape(-1, REDUCE_ROWS, f)
    thread_rows = torch.zeros(REDUCE_ROWS, f)
    for q in range(parts.shape[0]):         # thread row y: blocks y, y + 8
        thread_rows = thread_rows + parts[q]
    total = torch.zeros(f)
    for y in range(REDUCE_ROWS):            # then the thread rows in order
        total = total + thread_rows[y]
    return total


def emulate_backward(x, scale, dy, param_grads=True, n_blocks=None):
    """The row-resident K5b: ``(dx, dgamma, dbeta)``, the last two None
    without ``param_grads``; ``n_blocks`` the grid (every group one row at
    most unless given)."""
    f = x.shape[-1]
    x2, dy2 = x.reshape(-1, f), dy.reshape(-1, f)
    x32, cdf, g, mu, rstd = _row_stats(x2, f)
    xhat = (g - mu) * rstd
    d = dy2.float()
    dyg = d * scale.float()
    cols = lane_columns(f)
    m1 = group_sum(lane_sums(dyg, cols))[:, :1] / f
    m2 = group_sum(lane_sums(dyg * xhat, cols))[:, :1] / f
    dg = (rstd * (dyg - m1 - xhat * m2)).to(x.dtype).float()
    pdf = torch.exp(-0.5 * x32 * x32) * INV_SQRT_2PI
    dx = (dg * (cdf + x32 * pdf)).to(x.dtype).reshape(x.shape)
    if not param_grads:
        return dx, None, None
    n_blocks = n_blocks or -(-x2.shape[0] // GROUPS)
    dgamma = emulate_column_sums(d * xhat, n_blocks)
    dbeta = emulate_column_sums(d, n_blocks)
    return dx, dgamma.to(scale.dtype), dbeta.to(scale.dtype)


def _inputs(rows, f, seed):
    """x (rows, f), cotangent, scale and bias (f,) as fp32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return ((rng.randn(rows, f) * 2.0).astype(np.float32),
            rng.randn(rows, f).astype(np.float32),
            (rng.rand(f) + 0.5).astype(np.float32),
            (rng.randn(f) * 0.1).astype(np.float32))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def test_lane_layout_covers_each_column_once():
    """Every column belongs to one lane; a lane's 24 elements are three
    16-byte vectors of 8 consecutive columns, and the lanes of a vector
    index read consecutive vectors (coalesced)."""
    cols = lane_columns(F)
    assert cols.shape == (LANES, 24)
    assert sorted(cols.flatten().tolist()) == list(range(F))
    vec = cols.reshape(LANES, -1, 8)
    assert (vec[..., 0] % 8 == 0).all()
    assert (vec - vec[..., :1] == torch.arange(8)).all()
    assert (vec[1:, :, 0] - vec[:-1, :, 0] == 8).all()


def test_group_sum_is_the_same_in_every_lane():
    """The butterfly leaves every lane of a warp the same bits, so every
    lane of the group reads the same sum; it is the row's sum to fp32
    rounding."""
    lanes = torch.from_numpy(
        np.random.RandomState(3).randn(5, LANES).astype(np.float32))
    s = group_sum(lanes)
    assert torch.equal(s, s[:, :1].expand_as(s))
    want = lanes.double().sum(dim=1)
    assert torch.allclose(s[:, 0].double(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("rows", [8, 48])
def test_emulated_forward_matches_jax_kernel_in_fp32(rows):
    """The emulated K5f against JAX's ``_fwd_call`` in interpret mode:
    <= 1e-6."""
    x, _, s, b = _inputs(rows, F, seed=rows)
    want = jgl._fwd_call(jnp.asarray(x), jnp.asarray(s).reshape(1, F),
                         jnp.asarray(b).reshape(1, F), EPS, True)
    got = emulate_forward(torch.from_numpy(x), torch.from_numpy(s),
                          torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("rows,n_blocks", [(40, 7), (16, 1), (8, 4)])
def test_emulated_backward_matches_jax_kernel_in_fp32(rows, n_blocks):
    """The emulated K5b, both variants, against JAX's ``_bwd_call`` in
    interpret mode: 40 rows on 7 blocks (14 groups: a group walks two or
    three rows), 16 on one block, 8 on 4 (one row a group): at the limits
    of ``tests/test_torch_gelu_ln.py``; the variant without dgamma/dbeta
    gives the same dx bits."""
    x, cot, s, _ = _inputs(rows, F, seed=rows + 1)
    want = jgl._bwd_call(jnp.asarray(x), jnp.asarray(s).reshape(1, F),
                         jnp.asarray(cot), EPS, True)
    xt, st, ct = (torch.from_numpy(a) for a in (x, s, cot))
    got = emulate_backward(xt, st, ct, n_blocks=n_blocks)
    for name, g, w, (atol, rtol) in zip(("dx", "dgamma", "dbeta"), got,
                                        want, BWD_TOL):
        np.testing.assert_allclose(_np(g), _np(w).reshape(_np(g).shape),
                                   atol=atol, rtol=rtol, err_msg=name)
    dx_only = emulate_backward(xt, st, ct, param_grads=False)
    assert dx_only[1] is None and dx_only[2] is None
    assert torch.equal(dx_only[0], got[0])


@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,n_blocks", [(37, 5), (64, 32)])
def test_emulation_in_bf16_holds_the_chip_limits(rows, n_blocks, pdtype):
    """bf16 x and cotangent, gamma and beta in bf16 (the frozen backbone)
    or fp32; 37 rows on 5 blocks (the last block's second group idle on the
    grid's last stride), 64 on 32 (one row a group):
    the emulated forward against ``gelu_ln_reference`` by
    ``chip_smoke.compare`` at 1.6e-2, the backward against
    ``gelu_ln_backward_reference`` by ``chip_smoke.check_grads`` at the
    bf16 limits (rel-L2 <= 1e-2, row-scaled <= 2e-2; dgamma and dbeta
    against its fp32 sums), as ``phase_k5`` and ``phase_k5b`` hold the
    kernels."""
    x, cot, s, b = _inputs(rows, F, seed=rows + 2)
    xt = torch.from_numpy(x).bfloat16()
    ct = torch.from_numpy(cot).bfloat16()
    st, bt = torch.from_numpy(s).to(pdtype), torch.from_numpy(b).to(pdtype)
    chip_smoke.compare(emulate_forward(xt, st, bt),
                       tgl.gelu_ln_reference(xt, st, bt, EPS), 1.6e-2,
                       "emulated K5f")
    got = emulate_backward(xt, st, ct, n_blocks=n_blocks)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == pdtype
    dx = tgl.gelu_ln_backward_reference(xt, st, ct, EPS)[0]
    _, dg, db = tgl.gelu_ln_backward_reference(xt, st.float(), ct, EPS)
    chip_smoke.check_grads(("dx", "dgamma", "dbeta"), got, (dx, dg, db), ct,
                           "bfloat16", "emulated K5b")


def test_column_sums_hold_on_any_grid():
    """dgamma and dbeta by the fixed-order sums of 1, 3, 19 and 50 blocks
    (one of them more blocks than the 37 rows fill) agree with float64 sums
    to 1e-5 of their scale."""
    x, cot, s, _ = _inputs(37, F, seed=9)
    xt, st, ct = (torch.from_numpy(a) for a in (x, s, cot))
    want = [t.double() for t in tgl.gelu_ln_backward_reference(
        xt.double(), st.double(), ct.double(), EPS)[1:]]
    for n_blocks in (1, 3, 19, 50):
        got = emulate_backward(xt, st, ct, n_blocks=n_blocks)[1:]
        for g, w in zip(got, want):
            assert (g.double() - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.parametrize("dtype,f,offset,want", [
    (torch.bfloat16, 3072, 0, "rows"),
    (torch.bfloat16, 3072, 16, "rows"),
    (torch.bfloat16, 3072, 8, "generic"),      # a pointer 8 bytes off
    (torch.bfloat16, 2048, 0, "generic"),
    (torch.bfloat16, 1024, 0, "generic"),
    (torch.bfloat16, 4096, 0, "generic"),
    (torch.bfloat16, 384, 0, "generic"),
    (torch.bfloat16, 3080, 0, "generic"),
    (torch.float32, 3072, 0, "generic"),
    (torch.float16, 3072, 0, "generic"),
])
def test_route_rule(dtype, f, offset, want):
    """bf16 rows of width ROW_WIDTH with every tensor 16-byte aligned
    take the row-resident kernels; anything else the generic ones."""
    ptrs = (1 << 20, (1 << 21) + offset, 1 << 22)
    assert tgl.route(dtype, f, *ptrs) == want


@pytest.mark.parametrize("need", [
    (True, False, False), (True, True, False), (True, False, True),
    (True, True, True), (False, True, True), (False, False, False)])
def test_variant_rule(need):
    """dgamma and dbeta are computed when either is asked for."""
    assert tgl.wants_param_grads(need + (False,)) == (need[1] or need[2])


@pytest.mark.parametrize("frozen", [True, False])
def test_autograd_asks_for_the_variant(monkeypatch, frozen):
    """Through ``gelu_ln``'s autograd Function on CPU tensors: gamma and
    beta frozen ask the backward for dx alone, unfrozen for all three; the
    gradients are the plain version's."""
    x, cot, s, b = _inputs(6, F, seed=5)
    calls = []
    plain = tgl.gelu_ln_backward_reference

    def spy(*args, param_grads):
        calls.append(param_grads)
        return plain(*args, param_grads=param_grads)

    monkeypatch.setattr(tgl, "gelu_ln_backward_reference", spy)
    leaves = [torch.from_numpy(x).requires_grad_(),
              torch.from_numpy(s).requires_grad_(not frozen),
              torch.from_numpy(b).requires_grad_(not frozen)]
    tgl.gelu_ln(*leaves, eps=EPS).backward(torch.from_numpy(cot))
    assert calls == [not frozen]
    want = plain(leaves[0].detach(), leaves[1].detach(),
                 torch.from_numpy(cot), EPS)
    assert torch.equal(leaves[0].grad, want[0])
    if frozen:
        assert leaves[1].grad is None and leaves[2].grad is None
    else:
        assert torch.equal(leaves[1].grad, want[1])
        assert torch.equal(leaves[2].grad, want[2])


def test_fused_train_step_runs_the_variant_without_param_grads(monkeypatch):
    """A train step on the fused route (``chip_smoke.GIGAPATH_FUSED`` at a
    narrow, four-layer configuration) asks each layer's K5b for dx alone,
    since the step freezes the backbone, and the step's loss is finite."""
    from modaltune_tpu_torch import make_train_step
    from modaltune_tpu_torch.configs import tiny_test_config
    calls = []
    plain = tgl.gelu_ln_backward_reference

    def spy(*args, param_grads):
        calls.append(param_grads)
        return plain(*args, param_grads=param_grads)

    monkeypatch.setattr(tgl, "gelu_ln_backward_reference", spy)
    device = torch.device("cpu")
    model, tcfg, opt, text, batch = chip_smoke.build_train(
        device, **dict(chip_smoke.GIGAPATH_FUSED,
                       cfg=tiny_test_config(depth=4), n_genes=60,
                       n_groups=12, max_size=7, in_chans=64, bucket=511,
                       bag_range=(300, 400)))
    assert all(layer.ffn.fused_gelu_ln
               for layer in model.backbone.encoder.layers)
    step = make_train_step(model, tcfg, opt)
    loss = float(step(batch, text, torch.Generator().manual_seed(1)))
    assert math.isfinite(loss)
    assert calls == [False] * 4
