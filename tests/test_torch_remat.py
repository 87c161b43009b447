"""The port's per-layer rematerialization (``LongNetConfig.remat``,
``remat_policy``) against itself and against the JAX package, on the CPU.

* ``remat_policy``: the names JAX accepts, None for the same ones, and
  ValueError for the same others; an unknown name raises when the encoder
  is built, as JAX's raises when its layer is set up.
* Neutral with dropout on: a training-mode encoder (dropout 0.25, drop
  path 0.1, padded tokens) on every attention route (K1's ``mega``, K3's
  ``fused`` with the fused GELU -> LayerNorm, the per-branch ``branch``,
  the LoRA layer) gives under every policy the loss and the gradients of
  the input and of every parameter of remat off bit for bit, and leaves
  the dropout generator where remat off leaves it, its backward run on
  a thread of its own. This fails if the recompute draws new bits or
  loses the generator's context.
* What is recomputed: the attention call runs once a layer a step under
  ``"flash"`` and ``"flash_ffn"`` and twice under ``"full"``; the FFN past
  fc1 (K5f on the fused route) twice under every policy; once each with
  remat off or without grad.
* The tiny ModalTune model's grad step (dropout on) is bit-equal under
  every policy to remat off.
* Against JAX: the encoder with remat on against JAX's with remat on,
  from the same numpy weights (``params_from_jax``), at the 1e-5 of
  ``tests/test_remat_policy.py``.
* The sequence-parallel island under ``"full"`` (its all-gather re-run in
  the backward) and ``"flash"``: two gloo ranks equal one process, as
  ``tests/test_torch_dilated_sp.py`` holds them.

The config is ``tests/test_remat_policy.py``'s: 2 layers, d = 64, 4
heads, segments (32, 64), ratios (1, 2), fp32.
"""

import contextlib
import dataclasses
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp as tmp_ranks
from _one_thread import one_thread  # noqa: F401
from modaltune_tpu.configs import LongNetConfig as JLongNetConfig
from modaltune_tpu.models.longnet import LongNetEncoder as JLongNetEncoder
from modaltune_tpu.models.longnet import remat_policy as j_remat_policy
from modaltune_tpu_torch import (freeze_backbone, init_weights,
                                 make_grad_step)
from modaltune_tpu_torch.configs import LongNetConfig, TrainConfig
from modaltune_tpu_torch.models import dropout_generator, fill_normal_
from modaltune_tpu_torch.models import longnet
from modaltune_tpu_torch.models.longnet import LongNetEncoder, remat_policy
from modaltune_tpu_torch.utils.convert import params_from_jax

from test_torch_dilated_sp import LOSS_TOL, NULL_GRAD, sp_payload

TOL = 1e-5
POLICIES = ["flash", "flash_ffn", "full", "none", ""]
ROUTES = ["mega", "fused", "branch", "lora"]
LN_KW = dict(num_layers=2, embed_dim=64, ffn_dim=128, num_heads=4,
             segment_lengths=(32, 64), dilated_ratios=(1, 2))
L = 96


def _cfg(route="mega", remat=True, policy="flash", **kw):
    kw = dict(LN_KW, remat=remat, remat_policy=policy, **kw)
    if route == "fused":
        kw["mega_attention"] = False
    elif route == "branch":
        kw["fused_attention"] = False
    elif route == "lora":
        kw["lora_adapter"] = True
    return LongNetConfig(**kw)


def _encoder(cfg, seed=1):
    """The encoder of ``cfg`` with seeded weights (LoRA B matrices drawn
    too, else the deltas vanish), the K5 route on the fused one."""
    enc = LongNetEncoder(cfg, fused_gelu_ln=not cfg.mega_attention)
    g = torch.Generator().manual_seed(seed)
    init_weights(enc, g)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if "_lora_B_" in name:
                fill_normal_(p, 0.05, g)
    return enc


def _inputs(seed=0, n_valid=80):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, L, 64).astype(np.float32)
    cot = rng.randn(2, L, 64).astype(np.float32)
    mask = np.ones((2, L), bool)
    mask[1, n_valid:] = False
    return x, cot, mask


def _step(enc, seed=5, thread=False):
    """One training-mode forward and backward of ``sum(out * cot)`` under
    a seeded generator -> (loss, input grad, parameter grads, the
    generator's state after). With ``thread`` the backward runs on a
    thread of its own, outside the generator's context, as the autograd
    engine's device threads run it on the card."""
    x, cot, mask = (torch.from_numpy(a) for a in _inputs())
    x.requires_grad_()
    enc.train()
    g = torch.Generator().manual_seed(seed)
    enc.zero_grad(set_to_none=True)
    with dropout_generator(g):
        loss = (enc(x, mask) * cot).sum()
    if thread:
        failed = []

        def backward():
            try:
                loss.backward()
            except Exception as e:     # raised again below
                failed.append(e)
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        if failed:
            raise failed[0]
    else:
        loss.backward()
    return (loss.detach(), x.grad,
            {n: p.grad for n, p in enc.named_parameters()}, g.get_state())


@pytest.mark.parametrize("name", POLICIES)
def test_policy_names_match_jax(name):
    assert (remat_policy(name) is None) == (j_remat_policy(name) is None)


@pytest.mark.parametrize("name", ["bogus", "Flash", "attention", "ffn"])
def test_unknown_policy_raises_as_jax(name):
    with pytest.raises(ValueError):
        j_remat_policy(name)
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat_policy(name)
    with pytest.raises(ValueError, match="unknown remat policy"):
        LongNetEncoder(_cfg(policy=name))
    LongNetEncoder(_cfg(remat=False, policy=name))   # not read, as in JAX


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("route", ROUTES)
def test_policy_is_bit_neutral_with_dropout(route, policy):
    kw = dict(dropout=0.25, drop_path_rate=0.1)
    if route == "lora":
        kw["lora_dropout"] = 0.1
    off = _encoder(_cfg(route, remat=False, **kw))
    on = _encoder(_cfg(route, policy=policy, **kw))
    on.load_state_dict(off.state_dict())
    loss0, dx0, dp0, g0 = _step(off)
    loss1, dx1, dp1, g1 = _step(on, thread=True)
    assert torch.equal(loss0, loss1), (loss0, loss1)
    assert torch.equal(dx0, dx1)
    assert dp0.keys() == dp1.keys()
    for n in dp0:
        assert torch.equal(dp0[n], dp1[n]), n
    assert torch.equal(g0, g1)
    assert torch.isfinite(dx1).all() and dx1.abs().max() > 0


def _calls(route, remat, policy, grad=True):
    """The attention calls, FFN tails (past fc1) and fused GELU ->
    LayerNorm calls of one eval-mode step of the route's encoder."""
    attn = {"mega": "mega_dilated_attention",
            "fused": "fused_dilated_attention", "branch": "dilated_attention",
            "lora": None}[route]
    enc = _encoder(_cfg(route, remat=remat, policy=policy)).eval()
    counts = {"attention": 0, "ffn": 0, "gelu_ln": 0}

    def counted(key, fn):
        def call(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return call

    patches = [mock.patch.object(
        longnet.FeedForwardNetwork, "after_fc1",
        counted("ffn", longnet.FeedForwardNetwork.after_fc1)),
        mock.patch.object(longnet, "gelu_ln",
                          counted("gelu_ln", longnet.gelu_ln))]
    if attn is None:
        from modaltune_tpu_torch.models import extras
        patches.append(mock.patch.object(
            extras, "dilated_attention",
            counted("attention", extras.dilated_attention)))
    else:
        patches.append(mock.patch.object(
            longnet, attn, counted("attention", getattr(longnet, attn))))
    x, cot, mask = (torch.from_numpy(a) for a in _inputs())
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        if grad:
            x.requires_grad_()
            (enc(x, mask) * cot).sum().backward()
        else:
            with torch.no_grad():
                enc(x, mask)
    return counts


@pytest.mark.parametrize("policy", ["off", "flash", "flash_ffn", "full"])
@pytest.mark.parametrize("route", ROUTES)
def test_what_each_policy_recomputes(route, policy):
    layers = LN_KW["num_layers"]
    got = _calls(route, policy != "off", "flash" if policy == "off"
                 else policy)
    attn = 2 if policy == "full" else 1
    ffn = 1 if policy == "off" else 2
    assert got["attention"] == attn * layers, got
    assert got["ffn"] == ffn * layers, got
    assert got["gelu_ln"] == (ffn * layers if route == "fused" else 0), got


@pytest.mark.parametrize("policy", ["flash", "full"])
def test_no_remat_without_grad(policy):
    got = _calls("fused", True, policy, grad=False)
    layers = LN_KW["num_layers"]
    assert got == dict(attention=layers, ffn=layers, gelu_ln=layers), got


@pytest.mark.parametrize("policy", ["flash", "flash_ffn", "full"])
def test_model_grad_step_is_bit_neutral(policy):
    """The tiny ModalTune model (4 layers, two spans) with dropout 0.25 and
    drop path 0.1 in its backbone: ``make_grad_step``'s loss and every
    adapter gradient under ``policy`` equal remat off's bit for bit."""
    def run(remat):
        cfg = tmp_ranks.tiny_config(depth=4)
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, dropout=0.25, drop_path_rate=0.1, remat=remat,
            remat_policy=policy))
        packer, batch, text = tmp_ranks.tiny_data(2)
        model = tmp_ranks.port_model(cfg, packer)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("injector.gamma"):
                    p.fill_(0.5)
        freeze_backbone(model)
        batch = {k: tmp_ranks._t(v) for k, v in batch.items()}
        g = torch.Generator().manual_seed(3)
        loss, grads = make_grad_step(model, TrainConfig())(
            batch, tmp_ranks.text_targets(text), g)
        return loss, grads, g.get_state()

    loss0, grads0, g0 = run(False)
    loss1, grads1, g1 = run(True)
    assert torch.equal(loss0, loss1), (loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for n in grads0:
        assert torch.equal(grads0[n], grads1[n]), n
    assert torch.equal(g0, g1)


@pytest.mark.parametrize("policy", ["flash", "full"])
def test_encoder_matches_jax_with_remat(policy):
    """The port's encoder with remat on against JAX's with remat on, from
    the same weights: the output, the loss ``sum(sin(out))`` and its
    gradients to the input and every parameter, at 1e-5 of the largest
    value (the key bias's, rounding noise, of the largest gradient)."""
    jcfg = JLongNetConfig(**LN_KW, dropout=0.0, drop_path_rate=0.0,
                          remat=True, remat_policy=policy)
    jenc = JLongNetEncoder(jcfg, dtype=jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, L, 64)))
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x))

    def loss(p, xx):
        out = jenc.apply(p, xx)
        return jnp.sum(jnp.sin(out)), out
    (jl, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    enc = LongNetEncoder(_cfg(policy=policy, dropout=0.0,
                              drop_path_rate=0.0))
    holder = torch.nn.ModuleDict(
        {"backbone": torch.nn.ModuleDict({"encoder": enc})})
    tree = {"backbone": {"encoder": jax.device_get(params["params"])}}
    holder.load_state_dict(params_from_jax(tree, holder))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = enc(xt)
    lt = torch.sin(out).sum()
    lt.backward()

    def close(got, want, what, scale=None):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        scale = np.abs(want).max() if scale is None else scale
        err = np.abs(got - want).max() / max(scale, 1e-30)
        assert err <= TOL, (what, err)
    close(out.detach(), jout, "out")
    close(lt.detach(), jl, "loss")
    close(xt.grad, jgx, "dx")
    want = {k: torch.from_numpy(np.asarray(v)) for k, v in
            params_from_jax({"backbone": {"encoder": jax.device_get(
                jgp["params"])}}, holder).items()}
    g_all = max(g.abs().max().item() for g in want.values())
    for n, p in holder.named_parameters():
        # the key bias's gradient is zero but for rounding (softmax is
        # shift invariant): held to the largest gradient of all
        close(p.grad, want[n], n,
              g_all if n.endswith("k_proj.bias") else None)


@pytest.mark.parametrize("policy", ["flash", "full"])
def test_sp_model_under_remat_matches_one_process(policy, tmp_path):
    """The tiny model with ``seq_axes`` on 2 gloo ranks of a ``(1, 2)``
    mesh, its backbone rematerialized under ``policy`` (under ``"full"``
    the island's all-gather of q/k/v runs again in every layer's
    backward), against the same model in one process, by the gates of
    ``tests/test_torch_dilated_sp.py``."""
    p = dict(sp_payload(rows=2, depth=4), remat_policy=policy)
    ranks = tmp_ranks.run_ranks(tmp_ranks.sp_grad_worker, 2, tmp_path, p)
    model, tcfg, batch, text = tmp_ranks._tiny_setup(p, tmp_ranks.SEQ_AXES)
    assert model.backbone.encoder.layers[0].split == remat_policy(policy)
    loss, grads = make_grad_step(model, tcfg)(
        batch, text, torch.Generator().manual_seed(0))
    want = {n: g.numpy() for n, g in grads.items()}
    g_all = max(np.abs(g).max() for g in want.values())
    for rloss, rgrads, shards in ranks:
        assert shards == [2, 2], shards
        np.testing.assert_allclose(float(rloss), float(loss), rtol=LOSS_TOL)
        for n, g in rgrads.items():
            scale = g_all if n.endswith(NULL_GRAD) else np.abs(want[n]).max()
            err = np.abs(g - want[n]).max()
            assert err <= 1e-4 * scale, (n, err, scale)
    for n in want:
        np.testing.assert_array_equal(ranks[0][1][n], ranks[1][1][n])
