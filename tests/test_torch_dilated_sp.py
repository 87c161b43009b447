"""The port's sequence parallelism against the JAX package's, on the CPU.

* K1's ``q_token_range`` in the plain version against JAX's
  ``mega_dilated_attention(q_token_range=..., interpret=True)`` with the
  shapes of ``tests/test_dilated_sp.py`` (n = 8 puts a shard boundary
  inside a 64-token segment), its bounds rule and error text, its
  gradients (dq zero outside the range, the shards' dk/dv summing to the
  whole), and the tensor-core kernels' tile plan of a range
  (``query_tile_plan``, the CPU copy of ``query_tiles``);
* ``sp_mega_eligible`` against JAX's over a grid of shapes;
* the island on 2 and 4 gloo ranks, forward and dq/dk/dv, against JAX's
  ``sp_island_attention`` on a ``(2, n_seq)`` CPU mesh (JAX's own
  tolerances, 2e-5 out and 3e-5 gradients), and its refusal without a
  mesh;
* a tiny ModalTune model with ``seq_axes`` on 2 ranks: every backbone span
  on a token shard, its loss and adapter gradients against the same model
  in one process.

The multi-process runs start ranks with ``tests/_torch_mp.py``, each run
under its own time limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_mp as tmp_ranks
from modaltune_tpu.ops.dilated_mega import mega_dilated_attention as j_mega
from modaltune_tpu.ops.dilated_sp import sp_island_attention as j_island
from modaltune_tpu.ops.dilated_sp import sp_mega_eligible as j_eligible
from modaltune_tpu.parallel.mesh import make_mesh as j_make_mesh
from modaltune_tpu_torch import make_grad_step
from modaltune_tpu_torch.configs import SlideEncoderConfig
from modaltune_tpu_torch.ops.dilated import dilated_attention
from modaltune_tpu_torch.ops.dilated_mega import (mega_dilated_attention,
                                                  query_tile_plan)
from modaltune_tpu_torch.ops.dilated_sp import (sp_island_attention,
                                                sp_mega_eligible)

torch.set_num_threads(2)

B, S, H, D = 2, 256, 4, 16
SEGS, RATS = (64, 128, 256), (1, 2, 4)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    return q, k, v, rng.rand(B, S) > 0.15


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [4, 8])
def test_qrange_plain_matches_jax(n):
    """Each shard's range through the plain version against JAX's mega
    kernel with the same range in interpret mode: the range's rows, and
    zeros outside, within 1e-5."""
    q, k, v, mask = _inputs()
    kw = dict(segment_lengths=SEGS, dilated_ratios=RATS)
    sl = S // n
    for i in range(n):
        rng = (i * sl, (i + 1) * sl)
        want = j_mega(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask=jnp.asarray(mask), interpret=True,
                      q_token_range=rng, **kw)
        got = mega_dilated_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                                     q_token_range=rng, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=f"shard {i} of {n}")
        assert not got[:, :rng[0]].any() and not got[:, rng[1]:].any()


def test_qrange_bounds_are_multiples_of_r():
    """A bound that is no multiple of R = max ratio raises JAX's
    ``ValueError`` with its text; an empty range or one past the sequence
    raises too."""
    q, k, v, mask = _inputs()
    kw = dict(segment_lengths=SEGS, dilated_ratios=RATS)
    with pytest.raises(ValueError) as jerr:
        j_mega(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               interpret=True, q_token_range=(8, 74), **kw)
    for fn in (mega_dilated_attention, dilated_attention):
        with pytest.raises(ValueError) as err:
            fn(_t(q), _t(k), _t(v), q_token_range=(8, 74), **kw)
        assert str(err.value) == str(jerr.value)
        for bad in ((64, 64), (128, 512), (-4, 8)):
            with pytest.raises(ValueError, match="must lie in"):
                fn(_t(q), _t(k), _t(v), q_token_range=bad, **kw)


def test_qrange_gradients_split_the_whole():
    """Autograd through the range: dq is zero outside it and its rows are
    the whole call's; the shards' dk and dv sum to the whole call's."""
    q, k, v, mask = _inputs(1)
    dout = _t(np.random.RandomState(2).randn(B, S, H, D).astype(np.float32))
    kw = dict(segment_lengths=SEGS, dilated_ratios=RATS, mask=_t(mask))

    def grads(rng):
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        out = mega_dilated_attention(*leaves, q_token_range=rng, **kw)
        return torch.autograd.grad(out, leaves, dout)

    full = grads(None)
    n, sl = 8, S // 8
    parts = [grads((i * sl, (i + 1) * sl)) for i in range(n)]
    for i, (dq, _, _) in enumerate(parts):
        rows = slice(i * sl, (i + 1) * sl)
        assert not dq[:, :rows.start].any() and not dq[:, rows.stop:].any()
        np.testing.assert_allclose(dq[:, rows].numpy(),
                                   full[0][:, rows].numpy(), atol=1e-6)
    for j, name in ((1, "dk"), (2, "dv")):
        np.testing.assert_allclose(sum(p[j] for p in parts).numpy(),
                                   full[j].numpy(), atol=1e-5, err_msg=name)


def _covering_tiles(length, w, r, q0, q1):
    """The 64-row compact tile (in the branch's segment-major enumeration)
    of every position of [q0, q1) in branch (w, r)."""
    sl = min(w, length)
    per_seg = -(-(-(-sl // r)) // 64)
    p = np.arange(q0, q1)
    seg, o = p // sl, p % sl
    return np.unique(seg * per_seg + (o // r) // 64), per_seg


GIGAPATH = SlideEncoderConfig().longnet()


@pytest.mark.parametrize("length,segs,ratios,shards", [
    (256, SEGS, RATS, (2, 4, 8)),
    (10240, GIGAPATH.segment_lengths, GIGAPATH.dilated_ratios, (2, 4, 5)),
    (4096, (1024, 2048, 4096), (1, 2, 4), (2, 4, 8)),
    (1000, (96, 200, 1000), (2, 4, 8), (5,)),
])
def test_query_tile_plan_covers_the_range(length, segs, ratios, shards):
    """The tile plan of a shard's range (``query_tile_plan``, the CPU copy
    of the C rule ``query_tiles``) holds the tile of every row the range
    holds, in every branch and head group, and no tile of a segment that
    lies wholly outside the range; its spans of two tiles cover its tiles.
    The shards put boundaries inside segments and, at 1,000 tokens, inside
    the short last segment."""
    for n in shards:
        sl_n = length // n
        for i in range(n):
            q0, q1 = i * sl_n, (i + 1) * sl_n if i < n - 1 else length
            tiles = query_tile_plan(length, segs, ratios, q0, q1)
            spans = query_tile_plan(length, segs, ratios, q0, q1, span=2)
            for (first, count), (s_first, s_count), w, r in zip(
                    tiles, spans, segs, ratios):
                need, per_seg = _covering_tiles(length, w, r, q0, q1)
                got = np.arange(first, first + count)
                assert np.isin(need, got).all(), (n, i, w, r)
                sl = min(w, length)
                seg_of = got // per_seg
                assert seg_of.min() == q0 // sl and \
                    seg_of.max() == (q1 - 1) // sl, (n, i, w, r)
                pss = -(-per_seg // 2)
                span_tiles = {(s // pss) * per_seg + 2 * (s % pss) + j
                              for s in range(s_first, s_first + s_count)
                              for j in (0, 1)}
                assert set(got) <= span_tiles, (n, i, w, r)


def test_sp_mega_eligible_matches_jax():
    """The port's rule is JAX's on a grid of lengths, shard counts, heads
    and branch schedules, the Pallas kernel's VMEM budget included (the
    GigaPath schedule at 25,600 and 65,536 tokens)."""
    schedules = [(SEGS, RATS), ((64, 128, 256), (1, 2, 8)),
                 ((64, 96), (1, 2)), ((100, 200), (1, 2)),
                 ((128,), (1,)),
                 (GIGAPATH.segment_lengths, GIGAPATH.dilated_ratios)]
    seen = set()
    for segs, ratios in schedules:
        for length in (128, 256, 264, 1024, 4096, 10240, 25600, 65536):
            for n in (1, 2, 3, 4, 8, 16):
                for heads, d in ((4, 16), (16, 48), (12, 64)):
                    want = j_eligible(length, n, heads, d, segs, ratios)
                    got = sp_mega_eligible(length, n, heads, d, segs, ratios)
                    assert got == want, (length, n, heads, d, segs, ratios)
                    seen.add(want)
    assert seen == {True, False}


def test_island_declines_without_mesh():
    """Outside ``use_mesh`` the island returns None, as JAX's does outside
    ``jax.set_mesh``: the caller runs its normal dispatch."""
    q, k, v, mask = _inputs()
    assert sp_island_attention(_t(q), _t(k), _t(v), _t(mask),
                               segment_lengths=SEGS, dilated_ratios=RATS,
                               batch_axis="data", seq_axis="seq") is None


@pytest.mark.parametrize("n_seq", [2, 4])
def test_island_matches_jax(n_seq, tmp_path):
    """The island on ``n_seq`` gloo ranks, each holding its tokens of
    q/k/v and the mask, against JAX's ``sp_island_attention`` on a
    ``(2, n_seq)`` mesh of CPU devices: the rows, sum(sin(out)) and
    dq/dk/dv of ``jax.grad`` at JAX's tolerances."""
    q, k, v, mask = _inputs()
    ranks = tmp_ranks.run_ranks(
        tmp_ranks.island_worker, n_seq, tmp_path,
        dict(q=q, k=k, v=v, mask=mask, segs=SEGS, ratios=RATS))
    assert all(r[0] for r in ranks), "the island ran without a mesh"
    out = np.concatenate([r[1] for r in ranks], axis=1)
    loss = sum(float(r[2]) for r in ranks)
    grads = [np.concatenate([r[j] for r in ranks], axis=1)
             for j in (3, 4, 5)]

    mesh = j_make_mesh(n_data=2, n_seq=n_seq)
    jmask = jnp.asarray(mask)

    def island_loss(q, k, v):
        o = j_island(q, k, v, jmask, segment_lengths=SEGS,
                     dilated_ratios=RATS, batch_axis="data", seq_axis="seq")
        return jnp.sum(jnp.sin(o)), o

    spec = NamedSharding(mesh, P("data", "seq"))
    qs, ks, vs = (jax.device_put(jnp.asarray(t), spec) for t in (q, k, v))
    with jax.set_mesh(mesh):
        (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
            island_loss, argnums=(0, 1, 2), has_aux=True))(qs, ks, vs)
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for g, jg, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g, np.asarray(jg), atol=3e-5, rtol=3e-5,
                                   err_msg=f"d{name}")


# Exactly zero gradients in exact arithmetic, fp32 noise in practice
# (tests/test_torch_train.py's NULL_GRAD): held against the largest.
NULL_GRAD = ("k_proj.bias", "token.b2", "compress_bias")
LOSS_TOL = 3e-5


def sp_payload(rows, depth=2):
    """A seeded state of the tiny model, its Injector gammas drawn (they
    are 0 at init, which would cut the backbone out of the gradient)."""
    packer, _, _ = tmp_ranks.tiny_data(rows)
    model = tmp_ranks.port_model(tmp_ranks.tiny_config(depth=depth), packer)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(7)
    for k in state:
        if k.endswith("injector.gamma"):
            state[k] = (0.5 * rng.randn(*state[k].shape)).astype(np.float32)
    return dict(rows=rows, state=state, depth=depth)


def test_sp_model_matches_one_process(tmp_path):
    """The tiny model with ``seq_axes=("data", "seq")`` on 2 ranks of a
    ``(1, 2)`` mesh runs both backbone spans (layers 0-1 and 2-3, the two
    interactions of the 4-layer model) on 128-token shards (entered by a
    slice, left by a gather); its KD loss equals the same model's in
    one process within 3e-5 (the KD loss's fp32 floor) and every adapter
    gradient within 1e-4 of the tensor's largest (``NULL_GRAD`` tensors:
    of the largest gradient of all), on both ranks alike."""
    p = sp_payload(rows=2, depth=4)
    ranks = tmp_ranks.run_ranks(tmp_ranks.sp_grad_worker, 2, tmp_path, p)
    model, tcfg, batch, text = tmp_ranks._tiny_setup(p, tmp_ranks.SEQ_AXES)
    loss, grads = make_grad_step(model, tcfg)(
        batch, text, torch.Generator().manual_seed(0))
    want = {n: g.numpy() for n, g in grads.items()}
    g_all = max(np.abs(g).max() for g in want.values())
    for rloss, rgrads, shards in ranks:
        assert shards == [2, 2], shards    # two spans, each on 2 shards
        np.testing.assert_allclose(float(rloss), float(loss), rtol=LOSS_TOL)
        assert set(rgrads) == set(want)
        for n, g in rgrads.items():
            scale = g_all if n.endswith(NULL_GRAD) else np.abs(want[n]).max()
            err = np.abs(g - want[n]).max()
            assert err <= 1e-4 * scale, (n, err, scale)
    for n in want:
        np.testing.assert_array_equal(ranks[0][1][n], ranks[1][1][n])
