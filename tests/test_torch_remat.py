"""The port's per-layer rematerialization (``LongNetConfig.remat``,
``remat_policy``) against itself and against the JAX package, on the CPU.

* ``remat_policy``: the names JAX accepts, None for the same ones, and
  ValueError for the same others; an unknown name raises when the encoder
  is built, as JAX's raises when its layer is set up.
* Neutral with dropout on: a training-mode encoder (dropout 0.25, drop
  path 0.1, padded tokens) on every attention route (K1's ``mega``, K3's
  ``fused`` with the fused GELU -> LayerNorm, K1 with the fused GELU ->
  LayerNorm ``k5``, the per-branch ``branch``, the LoRA layer) gives under every policy the loss and the gradients of
  the input and of every parameter of remat off bit for bit, and leaves
  the dropout generator where remat off leaves it, its backward run on
  a thread of its own. This fails if the recompute draws new bits or
  loses the generator's context.
* What is recomputed, with CPU stand-ins for the card's kernels behind the
  card's autograd Functions (``card_functions``: K1's and K3's Functions
  on plain versions of their kernels, K2's Function as it runs on the
  CPU): the attention's forward kernels run once a layer a step under
  ``"flash"`` (whose recompute takes their outputs back) and
  ``"flash_ffn"``, twice under ``"full"``; the FFN past fc1 (K5f on the
  fused and ``k5`` routes) twice under every policy; once each with remat off or
  without grad.
* What a layer keeps under ``"flash"``, on every route behind those
  Functions: the bytes of the storages its forward made that are still
  alive after it are exactly its output, the attention's output and what
  the attention's backward reads besides q/k/v (K1's stats; K3's compact
  lses, m and Z; each branch's K2 out and lse), JAX's tagged set; with
  remat off and under ``"flash_ffn"`` q/k/v (or the branches' gathered
  copies) are kept besides.
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
import importlib
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
from modaltune_tpu_torch.ops import dilated_fused as df
from modaltune_tpu_torch.ops import dilated_mega as dm
from modaltune_tpu_torch.ops.dilated import (_round_up, dilated_attention,
                                             dilated_attention_stats)
from modaltune_tpu_torch.utils.convert import params_from_jax
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from test_torch_dilated_sp import LOSS_TOL, NULL_GRAD, sp_payload

TOL = 1e-5
POLICIES = ["flash", "flash_ffn", "full", "none", ""]
ROUTES = ["mega", "fused", "k5", "branch", "lora"]
# the routes whose FFN runs the fused GELU -> LayerNorm (K5)
K5_ROUTES = ("fused", "k5")
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


def _encoder(cfg, seed=1, fused_gelu_ln=False):
    """The encoder of ``cfg`` with seeded weights (LoRA B matrices drawn
    too, else the deltas vanish), its FFN on K5 with ``fused_gelu_ln``."""
    enc = LongNetEncoder(cfg, fused_gelu_ln=fused_gelu_ln)
    g = torch.Generator().manual_seed(seed)
    init_weights(enc, g)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if "_lora_B_" in name:
                fill_normal_(p, 0.05, g)
    return enc


def _route_encoder(route, seed=1, **kw):
    """:func:`_encoder` of the route's configuration (``_cfg(route,
    **kw)``), K5 in the FFN on the routes of ``K5_ROUTES``."""
    return _encoder(_cfg(route, **kw), seed, route in K5_ROUTES)


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
    off = _route_encoder(route, remat=False, **kw)
    on = _route_encoder(route, policy=policy, **kw)
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


fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")


def _plain_backward(q, k, v, mask, dmix, segs, ratios, scale):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = dilated_attention(*leaves, segment_lengths=segs,
                                dilated_ratios=ratios, mask=mask, scale=scale)
    return torch.autograd.grad(out, leaves, dmix)


@contextlib.contextmanager
def card_functions(counts):
    """The attention routes as the card runs them, on the CPU: the
    layer's ``mega_dilated_attention`` and ``fused_dilated_attention``
    apply K1's and K3's autograd Functions as their CUDA branch does,
    whose kernel wrappers become plain versions returning what the
    kernels return (K1f: out and stats; K3f: mixed, compact outs and
    lses, m and Z; their backwards by autograd through the plain
    version). K2's Function runs as it does on CPU tensors.
    ``counts["kernel"]`` counts the forward kernels' runs (K1f, K3f, each
    branch's K2f)."""
    def k1f(q, k, v, mask, segs, ratios, scale, with_stats=False,
            q_token_range=None):
        counts["kernel"] += 1
        kw = dict(segment_lengths=segs, dilated_ratios=ratios, mask=mask,
                  scale=scale)
        out = dilated_attention(q, k, v, **kw)
        return (out, dilated_attention_stats(q, k, v, **kw)) if with_stats \
            else out

    def k3f(q, k, v, mask, segs, ratios, scale):
        counts["kernel"] += 1
        outs, lses = zip(*(df.fused_branch_reference(q, k, v, mask, w, r,
                                                     scale)
                           for w, r in zip(segs, ratios)))
        mixed, m, z = df.fused_mix_reference(outs, lses, q.shape[1], segs,
                                             ratios)
        return (mixed.contiguous(), torch.cat(outs, dim=2),
                torch.cat(lses, dim=2), torch.stack([m, z]))

    def k2f(*a):
        counts["kernel"] += 1
        return plain_k2f(*a)
    plain_k2f = fa.flash_attention_reference

    def entry(function, launch):
        def attention(q, k, v, *, segment_lengths, dilated_ratios,
                      mask=None):
            branches = (tuple(segment_lengths), tuple(dilated_ratios),
                        q.shape[-1] ** -0.5)
            if torch.is_grad_enabled() and q.requires_grad:
                extra = (None,) if function is dm._MegaDilatedAttention \
                    else ()
                return function.apply(q, k, v, mask, *branches, *extra)
            out = launch(q, k, v, mask, *branches)
            return out[0] if isinstance(out, tuple) else out
        return attention

    patches = [
        mock.patch.object(dm, "mega_dilated_attention_cuda", k1f),
        mock.patch.object(dm, "mega_dilated_attention_backward_cuda",
                          lambda q, k, v, mask, dmix, stats, *b, **kw:
                          _plain_backward(q, k, v, mask, dmix, *b[:3])),
        mock.patch.object(df, "fused_dilated_attention_cuda", k3f),
        mock.patch.object(df, "fused_dilated_attention_backward_cuda",
                          lambda q, k, v, mask, dmix, lse_c, stats, *b:
                          _plain_backward(q, k, v, mask, dmix, *b)),
        mock.patch.object(fa, "flash_attention_reference", k2f),
        mock.patch.object(longnet, "mega_dilated_attention",
                          entry(dm._MegaDilatedAttention, k1f)),
        mock.patch.object(longnet, "fused_dilated_attention",
                          entry(df._FusedDilatedAttention, k3f))]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield counts


@pytest.mark.parametrize("route", ["mega", "fused", "k5"])
def test_flash_is_bit_neutral_behind_card_functions(route):
    """K1's and K3's Functions behind :func:`card_functions` (K1's beside
    K5 on the ``k5`` route), with dropout on: under ``"flash"`` the
    recompute takes their kept outputs back and gives remat off's loss and
    gradients bit for bit."""
    kw = dict(dropout=0.25, drop_path_rate=0.1)
    off = _route_encoder(route, remat=False, **kw)
    on = _route_encoder(route, policy="flash", **kw)
    on.load_state_dict(off.state_dict())
    with card_functions({"kernel": 0}) as counts:
        loss0, dx0, dp0, g0 = _step(off)
        launched = counts["kernel"]
        loss1, dx1, dp1, g1 = _step(on, thread=True)
    assert counts["kernel"] == 2 * launched == 2 * LN_KW["num_layers"]
    assert torch.equal(loss0, loss1) and torch.equal(dx0, dx1)
    for n in dp0:
        assert torch.equal(dp0[n], dp1[n]), n
    assert torch.equal(g0, g1)


def _calls(route, remat, policy, grad=True):
    """The attention's forward kernel runs (:func:`card_functions`), FFN
    tails (past fc1) and fused GELU -> LayerNorm calls of one eval-mode
    step of the route's encoder."""
    enc = _route_encoder(route, remat=remat, policy=policy).eval()
    counts = {"kernel": 0, "ffn": 0, "gelu_ln": 0}

    def counted(key, fn):
        def call(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return call

    patches = [mock.patch.object(
        longnet.FeedForwardNetwork, "after_fc1",
        counted("ffn", longnet.FeedForwardNetwork.after_fc1)),
        mock.patch.object(longnet, "gelu_ln",
                          counted("gelu_ln", longnet.gelu_ln)),
        card_functions(counts)]
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
    # a call's forward kernels: K1f or K3f, or each branch's K2f
    per_call = 1 if route in ("mega", "fused", "k5") else \
        len(LN_KW["segment_lengths"])
    assert counts["kernel"] % per_call == 0, counts
    return dict(attention=counts.pop("kernel") // per_call, **counts)


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
    assert got["gelu_ln"] == (ffn * layers if route in K5_ROUTES else 0), got


class _Made(TorchDispatchMode):
    """Every storage an op makes while the mode is on (not a view of its
    inputs'), by weak reference with its size: what is still alive after
    is what was kept."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().nbytes():
                st = t.untyped_storage()
                if st.data_ptr() not in inputs:
                    self.made.append((StorageWeakRef(st), st.data_ptr(),
                                      st.nbytes()))
        return out

    def alive_bytes(self):
        alive = {ptr: n for ref, ptr, n in self.made if not ref.expired()}
        return sum(alive.values())


def _kept_bytes(route, remat, policy):
    """The bytes of the storages that layer 0's training-mode forward
    makes and its backward keeps (its output included), its attention
    behind :func:`card_functions`."""
    enc = _route_encoder(route, remat=remat, policy=policy)
    x, _, mask = (torch.from_numpy(a) for a in _inputs())
    x.requires_grad_()
    made = _Made()
    with card_functions({"kernel": 0}), dropout_generator(
            torch.Generator().manual_seed(0)):
        with made:
            out = enc.layers[0](x, mask)
        kept = made.alive_bytes()
    assert out.grad_fn is not None
    return kept


def _flash_set(route):
    """JAX's ``"flash"`` set for layer 0 at the test's shapes, in bytes:
    the layer's output and the attention's output, (B, L, d) fp32 each,
    and what the attention's backward kernel reads besides q/k/v."""
    b, length, d, h = 2, L, LN_KW["embed_dim"], LN_KW["num_heads"]
    segs, ratios = LN_KW["segment_lengths"], LN_KW["dilated_ratios"]
    plane = b * length * d * 4
    if route in ("mega", "k5"):   # K1's stats (B*H, n + 2, L)
        extra = b * h * (len(segs) + 2) * length * 4
    elif route == "fused":    # K3's compact lses (B, H, M) and m, Z
        extra = b * h * (df.total_rows(length, segs, ratios) + 2 * length) * 4
    else:                     # each branch's K2 out (BnH, S, D) and lse
        extra = 0
        for w, r in zip(segs, ratios):
            sl = min(w, length)
            rows = b * (_round_up(length, sl) // sl) * h * (sl // r)
            extra += rows * (d // h + 1) * 4
    return 2 * plane + extra


@pytest.mark.parametrize("route", ROUTES)
def test_flash_keeps_what_jax_keeps(route):
    """Under ``"flash"`` a layer keeps exactly JAX's tagged set: no q/k/v,
    no gathered branch q/k/v, no branch output of K1 or K3; with remat off
    and under ``"flash_ffn"`` q/k/v (or the branches' gathered copies,
    as large) are kept besides."""
    want = _flash_set(route)
    assert _kept_bytes(route, True, "flash") == want
    qkv = 3 * 2 * L * LN_KW["embed_dim"] * 4
    for remat, policy in ((False, "flash"), (True, "flash_ffn")):
        assert _kept_bytes(route, remat, policy) >= want + qkv, policy


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
