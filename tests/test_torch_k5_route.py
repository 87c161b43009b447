"""The default GigaPath route with the fused GELU -> LayerNorm: K1's dilated
attention (``mega_attention``, the default) beside K5 in every FFN, the
pairing that the JAX package builds under ``MODALTUNE_FUSED_GELU_LN=1`` on
its default mega route, against the JAX package on the CPU.

* the embed step for both registry names, JAX on its default mega route
  with both of its Pallas kernels (the mega attention and the GELU ->
  LayerNorm) in interpret mode: <= 1e-4;
* one grad step there, JAX's mega kernel's backward in interpret mode:
  every adapter gradient at 1e-4 of its largest value, the loss within the
  KD loss's own fp32 floor on those embeddings, the eval step's logits at
  1e-4;
* three train steps at the bars of ``test_torch_train.py``, JAX on its
  plain dilated attention (see :func:`test_k5_route_train_step_matches_jax`
  for why);
* the switch: ``fused_gelu_ln=None`` reads ``MODALTUNE_FUSED_GELU_LN`` once,
  at construction, into every layer, and leaves ``mega_attention`` on;
* the train CLI with the switch set builds K1 with K5 in every layer and
  trains;
* ``chip_smoke.py``'s route ``"k5"`` and the launches it expects of a train
  step under each remat policy (:func:`chip_smoke.launches_per_step`),
  counted on the CPU with the plain versions standing in for the card's
  kernels behind their autograd Functions.

On CPU tensors the port runs its kernels' plain versions; the CUDA kernels
are held to these on the card by ``chip_smoke.py``.
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modaltune_tpu.models.longnet as jax_longnet
from modaltune_tpu.configs import TrainConfig as JTrainConfig
from modaltune_tpu.configs import tiny_test_config as j_tiny_config
from modaltune_tpu_torch import create_aggregator, make_grad_step
from modaltune_tpu_torch.configs import tiny_test_config
from modaltune_tpu_torch.models import longnet
from modaltune_tpu_torch.ops import dilated_mega as dm
from modaltune_tpu_torch.tools import train as cli
from modaltune_tpu_torch.utils.convert import params_from_jax

from _one_thread import one_thread  # noqa: F401  (one CPU thread a test)
from test_torch_fused import (FUSED_ENV, JAX_BACKBONE,
                              route_embed_step_against_jax)
from test_torch_remat import card_functions
from test_torch_train import (N_GENES, NULL_GRAD, BucketedLoader,
                              GenePacker, JaxModalTune,
                              SyntheticSlideDataset, TrainState,
                              _kd_loss_floor, _projectors, _t,
                              batch_to_device, freeze_backbone,
                              j_make_eval_step, j_make_grad_step,
                              j_make_optimizer, j_project_text,
                              make_eval_step, project_text,
                              synthetic_pathways, train_step_against_jax)

torch.set_num_threads(2)

gl = importlib.import_module("modaltune_tpu_torch.ops.gelu_ln")
fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """``chip_smoke.py`` of the repository root as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()


@pytest.fixture
def jax_mega_route(monkeypatch):
    """``FUSED_ENV`` set, and the JAX encoder's calls of its mega attention
    and its GELU -> LayerNorm counted as it traces them (both reached: JAX
    ran its default mega route with the fused FFN)."""
    for key, value in FUSED_ENV.items():
        monkeypatch.setenv(key, value)
    traced = {"mega_dilated_attention": 0, "gelu_ln": 0}

    def counted(key):
        fn = getattr(jax_longnet, key)

        def call(*a, **kw):
            traced[key] += 1
            return fn(*a, **kw)
        return call

    for key in traced:
        monkeypatch.setattr(jax_longnet, key, counted(key))
    return traced


@pytest.mark.parametrize("name,clinical", [
    ("longnetvit_gene_adapter", False),
    ("longnetvit_gene_clinical_adapter", True)])
def test_k5_route_embed_step_matches_jax_mega(monkeypatch, jax_mega_route,
                                              name, clinical):
    """:func:`test_torch_fused.route_embed_step_against_jax` on K1 with K5
    (``fused_gelu_ln=True`` alone: K1 and K5 once a layer, no K3), JAX on
    its default route: the comb-resident mega kernel and the Pallas GELU ->
    LayerNorm, both in interpret mode."""
    model = route_embed_step_against_jax(
        monkeypatch, name, clinical, dict(fused_gelu_ln=True), None,
        counted=("mega_dilated_attention", "gelu_ln"),
        absent=("fused_dilated_attention",))
    assert model.backbone.encoder.cfg.mega_attention
    assert all(jax_mega_route.values()), jax_mega_route


def test_k5_route_grad_step_matches_jax_mega(monkeypatch, jax_mega_route):
    """One grad step of the port on K1 with K5 against JAX's grad step on
    its default mega route in interpret mode (the mega kernel's custom VJP
    and the GELU -> LayerNorm's), from the same parameters and projector,
    on ``train_step_against_jax``'s bag: every adapter gradient within 1e-4
    of its tensor's largest value (the ``NULL_GRAD`` tensors, rounding
    noise, of the largest gradient of all), the bar of
    ``test_torch_train.py``; the eval step's logits at 1e-4. The loss is
    held within the KD loss's own fp32 floor on JAX's embeddings here
    (``_kd_loss_floor``: JAX against itself in other summation orders),
    which on this route reads above the 3e-5 of the plain route's."""
    cfg = j_tiny_config(depth=4)
    tcfg = JTrainConfig(lr=0.2, kd_loss_scale=1e-8)
    groups = synthetic_pathways(n_genes=N_GENES, n_groups=12, max_size=7,
                                seed=0)
    packer = GenePacker.build(groups, [f"g{i}" for i in range(N_GENES)])
    ds = SyntheticSlideDataset(n_cases=1, in_chans=64, bag_range=(300, 400),
                               packer=packer, n_genes=N_GENES, seed=1)
    (batch,) = list(BucketedLoader(ds, buckets=(511,), batch_size=1,
                                   shuffle=False, prefetch=0,
                                   device_prefetch=False))
    jmodel = JaxModalTune(cfg, n_gene_groups=packer.n_groups,
                          max_group_len=packer.max_group_len)
    jb = dict(bag=jnp.asarray(batch.bag), coords=jnp.asarray(batch.coords),
              mask=jnp.asarray(batch.mask), genes=jnp.asarray(batch.genes),
              clinical=None)
    params = jax.jit(lambda key: jmodel.init(
        key, jb["bag"], jb["coords"], jb["genes"], task_token=jnp.eye(3)[:1],
        bag_mask=jb["mask"])["params"])(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(7)        # Injectors are identities at init
    for name, block in params.items():
        if name.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    jproj, proj_params, projector = _projectors()
    jtext = j_project_text(jproj, proj_params, jnp.asarray(batch.text))
    state = TrainState.create(params, j_make_optimizer(tcfg, 3))
    row_valid = np.ones(1, np.float32)
    jlogits, _ = j_make_eval_step(jmodel, tcfg)(state, jb, jtext,
                                                jnp.asarray(row_valid))
    floor = _kd_loss_floor(jlogits, jtext)
    jloss, jgrads = j_make_grad_step(jmodel, tcfg)(state, jb, jtext,
                                                   jax.random.PRNGKey(0))

    model = create_aggregator("longnetvit_gene_adapter", device="cpu",
                              cfg=tiny_test_config(depth=4),
                              n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len,
                              fused_gelu_ln=True)
    layers = model.backbone.encoder.layers
    assert model.backbone.encoder.cfg.mega_attention
    assert all(layer.ffn.fused_gelu_ln for layer in layers)
    model.load_state_dict(params_from_jax(params, model))
    freeze_backbone(model)
    text = project_text(projector, _t(batch.text))
    inputs = batch_to_device(batch, "cpu")
    monkeypatch.setattr(longnet, "fused_dilated_attention", None)
    logits, _ = make_eval_step(model, tcfg)(inputs, text, _t(row_valid))
    loss, grads = make_grad_step(model, tcfg)(inputs, text,
                                              torch.Generator().manual_seed(0))

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    assert abs(float(loss) - float(jloss)) <= floor * abs(float(jloss)), (
        float(loss), float(jloss), floor)
    want = params_from_jax(dict(jax.device_get(jgrads),
                                backbone=params["backbone"]), model)
    assert grads.keys() == {n for n in want if not n.startswith("backbone.")}
    g_all = max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        scale = g_all if n.endswith(NULL_GRAD) else \
            float(want[n].abs().max())
        err = float((g - want[n]).abs().max())
        assert err <= 1e-4 * scale, (n, err, scale)
    assert all(jax_mega_route.values()), jax_mega_route


def test_k5_route_train_step_matches_jax(monkeypatch):
    """Three train steps of the port on K1 with K5 against JAX's with its
    fused FFN (the Pallas GELU -> LayerNorm in interpret mode), at the
    tolerances of ``test_torch_train.py::test_train_step_matches_jax``.
    JAX runs its plain dilated attention here (``JAX_BACKBONE``: the same
    function as its mega kernel): on the mega route's embeddings the KD
    loss's own fp32 floor in other summation orders reads 5.6e-5, above
    the 1e-5 and 3e-5 that ``train_step_against_jax`` holds the losses to,
    and asserts its floor under; :func:`test_k5_route_grad_step_matches_jax_mega`
    holds the gradients against the mega route."""
    for key, value in FUSED_ENV.items():
        monkeypatch.setenv(key, value)
    calls = {"mega_dilated_attention": 0, "gelu_ln": 0}

    def counted(key):
        fn = getattr(longnet, key)

        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    for key in calls:
        monkeypatch.setattr(longnet, key, counted(key))
    monkeypatch.setattr(longnet, "fused_dilated_attention", None)
    train_step_against_jax(port_kw=dict(fused_gelu_ln=True),
                           jax_backbone_kw=JAX_BACKBONE)
    assert all(calls.values()), calls


@pytest.mark.parametrize("switch", ["1", "0", None])
def test_switch_is_read_once_into_every_layer(monkeypatch, switch):
    """``fused_gelu_ln=None`` (the CLI's) reads ``MODALTUNE_FUSED_GELU_LN``
    at construction: "1" puts K5 in every layer's FFN, anything else none;
    ``mega_attention`` stays the configuration's (on); the variable read
    later changes nothing, and an explicit ``fused_gelu_ln`` wins."""
    if switch is None:
        monkeypatch.delenv("MODALTUNE_FUSED_GELU_LN", raising=False)
    else:
        monkeypatch.setenv("MODALTUNE_FUSED_GELU_LN", switch)
    cfg = tiny_test_config(depth=4)

    def build(**kw):
        return create_aggregator("longnetvit_gene_adapter", device="cpu",
                                 cfg=cfg, n_gene_groups=12, max_group_len=7,
                                 **kw)

    def fused(model):
        return {layer.ffn.fused_gelu_ln
                for layer in model.backbone.encoder.layers}
    model = build()
    assert model.backbone.encoder.cfg.mega_attention
    assert fused(model) == {switch == "1"}
    monkeypatch.setenv("MODALTUNE_FUSED_GELU_LN",
                       "0" if switch == "1" else "1")
    assert fused(model) == {switch == "1"}
    assert fused(build(fused_gelu_ln=False)) == {False}
    assert fused(build(fused_gelu_ln=True)) == {True}


def test_cli_with_the_switch_trains_k1_with_k5(monkeypatch, tmp_path):
    """``python -m modaltune_tpu_torch.tools.train --tiny 1 --synthetic 1
    --device cpu`` with ``MODALTUNE_FUSED_GELU_LN=1`` set, as a JAX user
    sets it: the model has ``mega_attention`` on and K5 in every layer, each
    train forward runs K1 and K5 in every layer and never K3, and the run's
    losses are finite."""
    monkeypatch.setenv("MODALTUNE_FUSED_GELU_LN", "1")
    import modaltune_tpu_torch.models as models
    built, calls = [], {"mega_dilated_attention": 0, "gelu_ln": 0}
    make = models.create_aggregator

    def create(*a, **kw):
        built.append(make(*a, **kw))
        return built[-1]

    def counted(key):
        fn = getattr(longnet, key)

        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(models, "create_aggregator", create)
    for key in calls:
        monkeypatch.setattr(longnet, key, counted(key))
    monkeypatch.setattr(longnet, "fused_dilated_attention", None)
    cli.main(["--tiny", "1", "--synthetic", "1", "--device", "cpu",
              "--num_epochs", "1", "--output_path", str(tmp_path)])
    (model,) = built
    layers = model.backbone.encoder.layers
    assert model.backbone.encoder.cfg.mega_attention
    assert all(layer.ffn.fused_gelu_ln for layer in layers)
    assert calls["mega_dilated_attention"] == calls["gelu_ln"] > 0
    assert calls["gelu_ln"] % len(layers) == 0
    rows = [json.loads(line) for line in
            open(tmp_path / "seed_0" / "run_metrics.jsonl")]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    assert losses and all(math.isfinite(x) for x in losses)


def test_chip_smoke_k5_route():
    """``chip_smoke.route_kw``'s ``"k5"``: ``fused_gelu_ln`` alone, so the
    default attention; ``GIGAPATH_K5`` is GigaPath's cell on it; an unknown
    route fails."""
    cfg = chip_smoke.model_config("gigapath_modaltune_config")
    assert chip_smoke.route_kw(cfg, "k5") == dict(fused_gelu_ln=True)
    assert chip_smoke.GIGAPATH_K5 == dict(chip_smoke.GIGAPATH, route="k5")
    with pytest.raises(chip_smoke.SmokeFailure, match="unknown route"):
        chip_smoke.route_kw(cfg, "k1k5")


# a train step's launches on K1 with K5 at the tiny model's 4 layers, by
# remat policy ("off": remat off): K5f runs again under every policy, K1f
# only under "full"
LAYERS = 4
WANT_PER_STEP = {
    "off": dict(K1f=LAYERS, K1b=LAYERS, K5f=LAYERS, K5b=LAYERS),
    "flash": dict(K1f=LAYERS, K1b=LAYERS, K5f=2 * LAYERS, K5b=LAYERS),
    "flash_ffn": dict(K1f=LAYERS, K1b=LAYERS, K5f=2 * LAYERS, K5b=LAYERS),
    "full": dict(K1f=2 * LAYERS, K1b=LAYERS, K5f=2 * LAYERS, K5b=LAYERS),
}


@pytest.mark.parametrize("frozen", ["bfloat16", "float32"])
@pytest.mark.parametrize("policy", sorted(WANT_PER_STEP))
def test_chip_smoke_launches_per_step_on_k5(policy, frozen):
    """``chip_smoke.build_train`` of ``GIGAPATH_K5`` at a narrow four-layer
    configuration under each remat policy, the backbone frozen in bf16 (the
    steps' autocast) or fp32 (``--bf16 0``): one train step, with K1's
    Function on plain stand-ins for its kernels
    (``test_torch_remat.card_functions``) and K5's Function on its plain
    versions, launches each kernel as often as
    :func:`chip_smoke.launches_per_step` says, which the card's paths
    check: K1f once a layer (twice under ``"full"``), K1b once, K5f twice
    (the recompute's) but with remat off, K5b once, every K5b without
    dgamma/dbeta; no K2 at D = 48, K3 or K4."""
    from modaltune_tpu_torch import make_train_step
    cfg = tiny_test_config(depth=LAYERS)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, remat=policy != "off",
        remat_policy="flash" if policy == "off" else policy))
    model, tcfg, opt, text, batch = chip_smoke.build_train(
        torch.device("cpu"), frozen=frozen,
        **dict(chip_smoke.GIGAPATH_K5, cfg=cfg, n_genes=60, n_groups=12,
               max_size=7, in_chans=64, bucket=255, bag_range=(150, 200)))
    want = chip_smoke.launches_per_step(model)
    assert {k: n for k, n in want.items() if n and k[:2] != "K2"} == \
        WANT_PER_STEP[policy]
    assert want["K2f"] == want["K2b"] == chip_smoke.calls_per_forward(
        model)["K2"] and chip_smoke.k2_branch_calls(model) == 0

    counts = {"kernel": 0, "K1b": 0, "K2f": 0, "K5f": 0, "K5b": []}
    plain_fwd, plain_bwd = gl.gelu_ln_reference, gl.gelu_ln_backward_reference

    def k5f(*a, **kw):
        counts["K5f"] += 1
        return plain_fwd(*a, **kw)

    def k5b(*a, param_grads):
        counts["K5b"].append(param_grads)
        return plain_bwd(*a, param_grads=param_grads)

    step = make_train_step(model, tcfg, opt)
    # card_functions counts K1f's and the adapter's K2f's runs together
    with card_functions(counts):
        k1b, k2f = dm.mega_dilated_attention_backward_cuda, \
            fa.flash_attention_reference

        def counted(key, fn):
            def call(*a, **kw):
                counts[key] += 1
                return fn(*a, **kw)
            return call
        with mock.patch.object(dm, "mega_dilated_attention_backward_cuda",
                               counted("K1b", k1b)), \
                mock.patch.object(fa, "flash_attention_reference",
                                  counted("K2f", k2f)), \
                mock.patch.object(gl, "gelu_ln_reference", k5f), \
                mock.patch.object(gl, "gelu_ln_backward_reference", k5b):
            loss = float(step(batch, text, torch.Generator().manual_seed(1)))
    assert math.isfinite(loss)
    got = dict(K1f=counts["kernel"] - counts["K2f"], K1b=counts["K1b"],
               K5f=counts["K5f"], K5b=len(counts["K5b"]))
    assert got == WANT_PER_STEP[policy], got
    assert counts["K2f"] == want["K2f"]
    assert counts["K5b"] == [False] * LAYERS
