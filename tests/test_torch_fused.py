"""The port's per-branch dilated attention (``ops/dilated_fused.py``) and the
whole model on its fused kernel route against the JAX package, on the CPU.

* ``fused_dilated_attention`` and its gradients against JAX's
  ``fused_dilated_attention`` (the Pallas kernels in interpret mode) at the
  geometries of ``tests/test_dilated_fused.py``;
* the plain versions of the four kernels (branch, mix, branch backward,
  combine; the oracles of the CUDA kernels K3f and K3b) composed by hand
  against ``dilated_attention`` and autograd through it, ``(m, Z)`` against
  ``dilated_attention_stats``, with a fully masked batch row, a partial
  last segment, heads that no ratio divides, and a mix that carries no
  gradient into its weights;
* the whole slice: the port's ``ModalTuneModel`` built with
  ``mega_attention=False`` and ``fused_gelu_ln=True`` against the JAX
  ``ModalTuneModel`` with ``MODALTUNE_FUSED_GELU_LN=1`` from the same
  parameters (``params_from_jax``, no new mapping): the embed step for both
  registry names and three train steps.

On CPU tensors the port runs its plain versions; the CUDA kernels are held
to these on the card by ``chip_smoke.py`` and ``test_torch_kernels_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.configs import TrainConfig, tiny_test_config
from modaltune_tpu.models import ModalTuneModel as JaxModalTune
from modaltune_tpu.ops.dilated_fused import (fused_dilated_attention
                                             as j_fused, fused_eligible)
from modaltune_tpu.train.train_step import multitask_logits as j_logits
from modaltune_tpu_torch import (create_aggregator, make_embed_step,
                                 params_from_jax)
from modaltune_tpu_torch.ops import NEG_INF, dilated_attention
from modaltune_tpu_torch.ops import dilated_fused as df
from modaltune_tpu_torch.ops.dilated import dilated_attention_stats
from modaltune_tpu_torch.train import batch_to_device

from _one_thread import one_thread  # noqa: F401  (one CPU thread a test)
from test_torch_slice import _batch, _config
from test_torch_train import _t, train_step_against_jax

torch.set_num_threads(2)

# the geometry of tests/test_dilated_fused.py:24-26: all three layout modes
# of the Pallas kernels (slc, comb, crd)
S, H, D = 256, 4, 32
SEGS = (64, 128, 512, 96)
RATIOS = (1, 2, 4, 2)
# fp32 on both sides: the Pallas kernels hold a whole score row, the port
# streams the plain softmax; summation order only
FWD_TOL = 2e-5
GRAD_TOL = 2e-4
# the plain pieces against the plain whole, one framework, fp32
PIECE_TOL = 1e-5


def _inputs(seed, b, s, h, d, masked):
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(b, s, h, d).astype(np.float32)
                    for _ in range(4))
    mask = None
    if masked:
        lens = rng.randint(s // 2, s + 1, size=b)
        mask = np.arange(s)[None, :] < lens[:, None]
        cot = cot * mask[:, :, None, None]
    return q, k, v, mask, cot


@pytest.mark.parametrize("masked", [True, False])
def test_forward_matches_jax_fused(masked):
    """<= 2e-5 on the valid rows."""
    assert fused_eligible(S, H, D, SEGS, RATIOS)
    q, k, v, mask, _ = _inputs(0, 2, S, H, D, masked)
    kw = dict(segment_lengths=SEGS, dilated_ratios=RATIOS)
    want = np.asarray(j_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), interpret=True,
        **kw))
    got = df.fused_dilated_attention(
        _t(q), _t(k), _t(v), mask=None if mask is None else _t(mask),
        **kw).numpy()
    m = 1.0 if mask is None else mask[:, :, None, None]
    np.testing.assert_allclose(got * m, want * m, atol=FWD_TOL, rtol=FWD_TOL)


def test_gradients_match_jax_fused():
    """dq, dk, dv against ``jax.grad`` through the Pallas branch-backward
    and combine kernels at the S = 64 geometry of
    ``tests/test_dilated_fused.py:78-79``: <= 2e-4 on the valid rows."""
    segs, ratios = (16, 32, 48), (1, 2, 2)
    q, k, v, _, cot = _inputs(7, 2, 64, 4, 16, False)
    mask = np.arange(64)[None, :] < np.array([40, 64])[:, None]
    cot = cot * mask[:, :, None, None]
    kw = dict(segment_lengths=segs, dilated_ratios=ratios)
    want = jax.grad(lambda a, b, c: jnp.sum(j_fused(
        a, b, c, mask=jnp.asarray(mask), interpret=True, **kw) * cot),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(
        df.fused_dilated_attention(*leaves, mask=_t(mask), **kw), _t(cot))
    m = mask[:, :, None, None]
    for name, x, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(x.grad.numpy() * m, np.asarray(w) * m,
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


# (B, L, H, D, segments, ratios, valid lengths per batch row or None)
PIECE_CASES = {
    "layouts": (2, S, H, D, SEGS, RATIOS, (200, 256)),
    "unmasked": (1, S, H, D, SEGS, RATIOS, None),
    # the last segment of (50, 4) holds 27 of 50 positions, of (16, 1) 13
    "partial_last_segment": (2, 77, 8, 16, (16, 50, 100), (1, 4, 8),
                             (77, 60)),
    # six heads: ratio 4 pads them to eight, two head groups stay empty
    "heads_no_ratio_divides": (1, 90, 6, 8, (32, 90), (1, 4), (70,)),
    "dead_batch_row": (2, 64, 4, 8, (16, 64), (1, 2), (64, 0)),
    "one_valid_key": (1, 130, 4, 16, (64, 130), (1, 2), (1,)),
}


def _pieces(q, k, v, mask, segs, ratios, scale):
    """Branch -> mix by hand: ``(mixed, m, Z, lses)``."""
    outs, lses = zip(*(df.fused_branch_reference(q, k, v, mask, w, r, scale)
                       for w, r in zip(segs, ratios)))
    mixed, m, z = df.fused_mix_reference(outs, lses, q.shape[1], segs, ratios)
    return mixed, m, z, outs, lses


@pytest.mark.parametrize("name", sorted(PIECE_CASES))
def test_plain_pieces_compose_to_dilated_attention(name):
    """Branch -> mix against ``dilated_attention``, ``(m, Z)`` and every
    branch's lse against ``dilated_attention_stats``; branch backward ->
    combine against autograd through ``dilated_attention``. <= 1e-5 of the
    tensor's scale."""
    b, length, h, d, segs, ratios, lens = PIECE_CASES[name]
    q, k, v, _, cot = (_t(x) if x is not None else None
                       for x in _inputs(3, b, length, h, d, False))
    mask = None
    if lens is not None:
        mask = torch.arange(length)[None, :] < torch.tensor(lens)[:, None]
    scale = d ** -0.5
    kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask)
    mixed, m, z, outs, lses = _pieces(q, k, v, mask, segs, ratios, scale)
    rows = df.branch_rows(length, segs, ratios)
    for (off, nseg, per), o, l in zip(rows, outs, lses):
        assert o.shape == (b, h, nseg * per, d) and l.shape == o.shape[:3]
    assert df.total_rows(length, segs, ratios) == sum(
        n * per for _, n, per in rows)

    want = dilated_attention(q, k, v, **kw)
    np.testing.assert_allclose(mixed.numpy(), want.numpy(), atol=PIECE_TOL,
                               rtol=PIECE_TOL)
    stats = dilated_attention_stats(q, k, v, **kw)
    n = len(segs)
    for i, (w, r) in enumerate(zip(segs, ratios)):
        dense = df.from_compact(lses[i], length, w, r, fill=NEG_INF)
        np.testing.assert_allclose(dense.reshape(b * h, length).numpy(),
                                   stats[:, i].numpy(), atol=PIECE_TOL,
                                   rtol=PIECE_TOL)
        # a row without a valid key, or no real position: out 0, NEG_INF
        assert (outs[i][lses[i] == NEG_INF] == 0).all()
    np.testing.assert_allclose(m.reshape(b * h, length).numpy(),
                               stats[:, n].numpy(), atol=PIECE_TOL,
                               rtol=PIECE_TOL)
    np.testing.assert_allclose(z.reshape(b * h, length).numpy(),
                               stats[:, n + 1].numpy(), atol=PIECE_TOL,
                               rtol=PIECE_TOL)
    if name == "dead_batch_row":
        assert (mixed[1] == 0).all() and (z[1] == 0).all() \
            and (m[1] == NEG_INF).all()

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(dilated_attention(*leaves, **kw), cot)
    grads = [df.fused_branch_backward_reference(
        q, k, v, mask, lses[i], m, z, cot, w, r, scale)
        for i, (w, r) in enumerate(zip(segs, ratios))]
    got = df.fused_combine_reference(grads, length, segs, ratios, q.dtype)
    for gname, g, x in zip(("dq", "dk", "dv"), got, leaves):
        scale_g = max(1.0, x.grad.abs().max().item())
        assert (g - x.grad).abs().max().item() <= PIECE_TOL * scale_g, gname
    if name == "dead_batch_row":
        assert all((g[1] == 0).all() for g in got)
    if mask is not None:            # masked keys: exactly zero dk and dv
        dead = ~mask[:, :, None, None].expand_as(got[1])
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()


def test_compact_layout_round_trip():
    """``to_compact`` and ``from_compact`` are inverse on the slots a
    branch covers; the others read the fill."""
    b, length, h = 2, 77, 8
    x = torch.arange(b * length * h, dtype=torch.float32).reshape(
        b, length, h) + 1.0
    for w, r in ((16, 1), (50, 4), (100, 8)):
        dense = df.from_compact(df.to_compact(x, w, r), length, w, r,
                                fill=-1.0).permute(0, 2, 1)
        real, pos = df.compact_rows(length, h, w, r)
        covered = dense != -1.0
        assert covered.sum().item() == b * real.sum().item()
        assert torch.equal(dense[covered], x[covered])
        sl = min(w, length)
        hg = -(-h // r)
        for head in range(h):
            want = [p for p in range(length) if (p % sl) % r == head // hg]
            assert pos[head][real[head]].tolist() == want


def test_mix_weights_carry_no_gradient():
    """The demix weight scales ``dmix`` as a constant: the branch backward
    equals the gradient of ``sum_b wm_b * out_b`` with ``wm_b`` held fixed,
    and differs from the gradient that flows through the weights."""
    b, length, h, d, segs, ratios = 1, 64, 4, 8, (16, 64), (1, 2)
    q, k, v, _, cot = (_t(x) if x is not None else None
                       for x in _inputs(5, b, length, h, d, False))
    scale = d ** -0.5
    _, m, z, _, lses = _pieces(q, k, v, None, segs, ratios, scale)

    def mixed_from(leaves, detach):
        total = 0.0
        for w, r in zip(segs, ratios):
            o, _ = df.fused_branch_reference(*leaves, None, w, r, scale)
            # lse with its gradient, from the same rows
            qc, kc = (df.to_compact(t, w, r) for t in leaves[:2])
            _, nseg, per = df.branch_rows(length, [w], [r])[0]
            s = torch.matmul(qc.reshape(b, h, nseg, per, d) * scale,
                             kc.reshape(b, h, nseg, per, d).transpose(-1, -2))
            lse = torch.logsumexp(s, dim=-1).reshape(b, h, nseg * per)
            wm = torch.exp(lse - df.to_compact(m.permute(0, 2, 1), w, r)) \
                / df.to_compact(z.permute(0, 2, 1), w, r)
            wm = wm.detach() if detach else wm
            total = total + df.from_compact(o * wm[..., None], length, w, r)
        return total.permute(0, 2, 1, 3)

    got = df.fused_combine_reference(
        [df.fused_branch_backward_reference(q, k, v, None, lses[i], m, z, cot,
                                            w, r, scale)
         for i, (w, r) in enumerate(zip(segs, ratios))],
        length, segs, ratios, q.dtype)
    grads = {}
    for detach in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        torch.autograd.backward(mixed_from(leaves, detach), cot)
        grads[detach] = [x.grad for x in leaves]
    for g, fixed, through in zip(got, grads[True], grads[False]):
        assert (g - fixed).abs().max().item() <= PIECE_TOL * max(
            1.0, fixed.abs().max().item())
    # the weights depend on q and k only: there the two gradients differ
    assert (grads[True][0] - grads[False][0]).abs().max().item() > 1e-3


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v, mask, _ = (_t(x) for x in _inputs(6, 1, 64, 4, 8, True))
    kw = dict(segment_lengths=(16, 64), dilated_ratios=(1, 2), mask=mask)
    df.LAUNCHES = df.BWD_LAUNCHES = 0
    q.requires_grad_()
    out = df.fused_dilated_attention(q, k, v, **kw)
    out.sum().backward()
    assert (df.LAUNCHES, df.BWD_LAUNCHES) == (0, 0)
    assert torch.equal(out, dilated_attention(q, k, v, **kw))
    with pytest.raises(ValueError, match="device"):
        df.fused_dilated_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                   segment_lengths=(16,), dilated_ratios=(1,))


# ---------------------------------------------------------------------------
# The whole slice on the fused route
# ---------------------------------------------------------------------------

FUSED_ENV = {"MODALTUNE_FUSED_GELU_LN": "1", "MODALTUNE_PALLAS_INTERPRET": "1"}
# JAX's own route here: with the interpret switch on, its encoder would run
# the mega attention kernel in interpret mode, span after span; with
# fused_attention off it runs its plain dilated attention, the same
# function, and the switch reaches only the FFN's Pallas kernel.
JAX_BACKBONE = dict(fused_attention=False)


def route_embed_step_against_jax(monkeypatch, name, clinical, port_kw,
                                 jax_backbone_kw, counted, absent):
    """One bag of 300-400 tokens in the 511 bucket through JAX
    ``multitask_logits`` (with ``FUSED_ENV`` set, its FFN through the
    Pallas GELU -> LayerNorm in interpret mode) and the port's embed step
    on a kernel route (``port_kw`` to ``create_aggregator``), from the same
    parameters: <= 1e-4, the bar of ``test_torch_slice.py``. The JAX tree
    converts with no new mapping and loads with ``strict=True``.
    ``jax_backbone_kw`` replaces fields of the JAX backbone's
    configuration. ``counted`` names attributes of the port's
    ``models/longnet.py`` (the route's entry points) whose calls are
    counted, each once a layer; ``absent`` those the route must not reach.
    -> the port's model."""
    for key, value in FUSED_ENV.items():
        monkeypatch.setenv(key, value)
    cfg = _config(clinical, "cat" if clinical else "sum")
    jcfg = cfg if not jax_backbone_kw else dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, **jax_backbone_kw))
    packer, batch = _batch(clinical, bucket=511, bag_range=(300, 400))
    jmodel = JaxModalTune(jcfg, n_gene_groups=packer.n_groups,
                          max_group_len=packer.max_group_len)
    jb = dict(bag=jnp.asarray(batch.bag), coords=jnp.asarray(batch.coords),
              mask=jnp.asarray(batch.mask), genes=jnp.asarray(batch.genes),
              clinical=None if batch.clinical is None
              else jnp.asarray(batch.clinical))
    params = jax.jit(lambda key: jmodel.init(
        key, jb["bag"], jb["coords"], jb["genes"],
        task_token=jnp.eye(3)[:1], clinical=jb["clinical"],
        bag_mask=jb["mask"])["params"])(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(7)      # Injectors are identities at init
    for pname, block in params.items():
        if pname.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    # the LayerNorm the fused kernel reads: not the init's ones and zeros
    for layer in params["backbone"]["encoder"].values():
        if isinstance(layer, dict) and "ffn" in layer:
            ln = layer["ffn"]["ffn_layernorm"]
            ln["scale"] = (1.0 + 0.2 * rng.randn(*ln["scale"].shape)
                           ).astype(np.float32)
            ln["bias"] = (0.1 * rng.randn(*ln["bias"].shape)
                          ).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: j_logits(
        jmodel, p, jb, 3, deterministic=True))(params))

    model = create_aggregator(
        name, device="cpu", cfg=cfg, n_gene_groups=packer.n_groups,
        max_group_len=packer.max_group_len, **port_kw)
    layers = model.backbone.encoder.layers
    assert all(layer.ffn.fused_gelu_ln for layer in layers)
    model.load_state_dict(params_from_jax(params, model), strict=True)
    calls = dict.fromkeys(counted, 0)

    def counted_call(fn, key):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    import modaltune_tpu_torch.models.longnet as port_longnet
    for key in counted:
        monkeypatch.setattr(port_longnet, key,
                            counted_call(getattr(port_longnet, key), key))
    for key in absent:
        monkeypatch.setattr(port_longnet, key, None)
    got = make_embed_step(model, TrainConfig())(batch_to_device(batch, "cpu"))
    assert calls == dict.fromkeys(counted, len(layers))
    assert got.shape == (1, 3, 256) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    return model


@pytest.mark.parametrize("name,clinical", [
    ("longnetvit_gene_adapter", False),
    ("longnetvit_gene_clinical_adapter", True)])
def test_fused_route_embed_step_matches_jax(monkeypatch, name, clinical):
    """:func:`route_embed_step_against_jax` on the fused route (K3 and K5
    once a layer, no K1), JAX on its plain attention (``JAX_BACKBONE``)."""
    cfg = _config(clinical, "cat" if clinical else "sum")
    model = route_embed_step_against_jax(
        monkeypatch, name, clinical,
        dict(longnet=cfg.backbone.longnet(mega_attention=False),
             fused_gelu_ln=True),
        JAX_BACKBONE, counted=("fused_dilated_attention", "gelu_ln"),
        absent=("mega_dilated_attention",))
    assert not model.backbone.encoder.cfg.mega_attention


def test_fused_route_train_step_matches_jax(monkeypatch):
    """Three train steps of the port on the fused route against the JAX
    step with its fused FFN, at the tolerances of
    ``test_torch_train.py::test_train_step_matches_jax``."""
    for key, value in FUSED_ENV.items():
        monkeypatch.setenv(key, value)
    cfg = tiny_test_config(depth=4)     # train_step_against_jax's
    train_step_against_jax(
        port_kw=dict(longnet=cfg.backbone.longnet(mega_attention=False),
                     fused_gelu_ln=True),
        jax_backbone_kw=JAX_BACKBONE)
