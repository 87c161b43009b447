"""The port's ModalTune-TITAN against the JAX package's, on the CPU, fp32.

One synthetic slide is grid-scattered by ``TitanGridDataset`` (~350
foreground cells in the 511 bucket) and goes, with the same parameters
carried across by ``params_from_jax``, through:

* (d) ``TitanViT`` alone (embed, every block, the attentional pooler),
  and the 3-task embeddings of ``TitanModalTuneModel`` for both registry
  names; background cells must not influence the output;
* (e) three train steps of JAX's ``make_train_step`` and the port's;
* (f) ``params_from_jax`` on a leftover or misshapen TITAN key.

Off the TPU the JAX model adds the dense ``alibi_bias`` tensor to its
scores; the port always goes through ``alibi_flash_attention``, whose
plain version runs here (``tests/test_torch_alibi.py`` holds that op
against JAX's Pallas kernels in interpret mode).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.configs import (AdapterConfig, GeneEncoderConfig,
                                   TitanConfig, TitanModalTuneConfig,
                                   TrainConfig)
from modaltune_tpu.data import (BucketedLoader, GenePacker,
                                SyntheticSlideDataset, TitanGridDataset,
                                synthetic_pathways)
from modaltune_tpu.models import TitanModalTuneModel as JaxTitanModalTune
from modaltune_tpu.models import TitanViT as JaxTitanViT
from modaltune_tpu.train import TrainState
from modaltune_tpu.train import make_eval_step as j_make_eval_step
from modaltune_tpu.train import make_optimizer as j_make_optimizer
from modaltune_tpu.train import make_train_step as j_make_train_step
from modaltune_tpu.train import project_text as j_project_text
from modaltune_tpu.train.train_step import make_grad_step as j_make_grad_step
from modaltune_tpu.train.train_step import multitask_logits as j_logits
from modaltune_tpu_torch import (TitanModalTuneModel, create_aggregator,
                                 freeze_backbone, init_weights,
                                 make_embed_step, make_eval_step,
                                 make_grad_step, make_optimizer,
                                 make_train_step, params_from_jax,
                                 project_text)
from modaltune_tpu_torch.models import TitanViT
from modaltune_tpu_torch.train import batch_to_device

from test_torch_train import (LOSS_TOL, NULL_GRAD, _kd_loss_floor,
                              _projectors, _t)

torch.set_num_threads(2)

N_GENES = 60
# fp32 on both sides, the same algorithm; the bar of test_torch_slice.py.
TOL = 1e-4
# The KD loss's fp32 floor on the tiny TITAN's embeddings (JAX against
# itself under 16 channel permutations, measured in the train-step test:
# 4.7e-5, a lower bound of the floor) lies above test_torch_train.py's
# LOSS_TOL of 3e-5.
TITAN_LOSS_TOL = 7e-5
NAMES = {False: "titan_gene_adapter", True: "titan_gene_clinical_adapter"}


def _config(clinical=False, depth=4, output_dim=32):
    """The tiny TITAN of tests/test_titan.py, two blocks per interaction so
    that the prompt self-attention and the extra extractors run."""
    backbone = TitanConfig(in_dim=32, embed_dim=64, depth=depth, num_heads=4,
                           mlp_patch_embed_dim=32, attn_pooler_queries=8,
                           attn_pooler_heads=4, drop_path_rate=0.0)
    adapter = AdapterConfig(num_heads=4, output_dim=output_dim,
                            interaction_indexes=((0, 1), (2, 3)),
                            token_agg="cat", drop_path_rate=0.0,
                            clinfeat_dim=5 if clinical else 0)
    gene = GeneEncoderConfig(latent_dim=16, depth=1, final_groups=4,
                             output_dim=64, dropout=0.0)
    return TitanModalTuneConfig(backbone=backbone, adapter=adapter, gene=gene)


def _batch(clinical=False, bucket=511, bag_range=(300, 400)):
    groups = synthetic_pathways(n_genes=N_GENES, n_groups=12, max_size=7,
                                seed=0)
    packer = GenePacker.build(groups, [f"g{i}" for i in range(N_GENES)])
    ds = TitanGridDataset(SyntheticSlideDataset(
        n_cases=1, in_chans=32, bag_range=bag_range, packer=packer,
        n_genes=N_GENES, clinical_dim=5 if clinical else 0, seed=1))
    (batch,) = list(BucketedLoader(ds, buckets=(bucket,), batch_size=1,
                                   shuffle=False, prefetch=0,
                                   device_prefetch=False))
    return packer, batch


def _jax_batch(batch):
    return dict(bag=jnp.asarray(batch.bag), coords=jnp.asarray(batch.coords),
                mask=jnp.asarray(batch.mask), genes=jnp.asarray(batch.genes),
                clinical=None if batch.clinical is None
                else jnp.asarray(batch.clinical))


def _jax_params(jmodel, jb, seed=0):
    """Randomly initialised JAX parameters as numpy, the Injector gammas
    set non-zero (init_values = 0 makes every Injector an identity)."""
    params = jax.jit(lambda key: jmodel.init(
        key, jb["bag"], jb["coords"], jb["genes"], task_token=jnp.eye(3)[:1],
        clinical=jb["clinical"], bag_mask=jb["mask"])["params"])(
        jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(7)
    for name, block in params.items():
        if name.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    return params


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "clinical"])
def case(request):
    clinical = request.param
    cfg = _config(clinical)
    packer, batch = _batch(clinical)
    jmodel = JaxTitanModalTune(cfg, n_gene_groups=packer.n_groups,
                               max_group_len=packer.max_group_len)
    jb = _jax_batch(batch)
    params = _jax_params(jmodel, jb)
    want = np.asarray(jax.jit(lambda p: j_logits(
        jmodel, p, jb, 3, deterministic=True))(params))
    return dict(cfg=cfg, packer=packer, batch=batch, params=params,
                want=want, clinical=clinical)


def _port_model(case):
    return create_aggregator(NAMES[case["clinical"]], device="cpu",
                             cfg=case["cfg"],
                             n_gene_groups=case["packer"].n_groups,
                             max_group_len=case["packer"].max_group_len)


def test_titan_batch_is_a_grid(case):
    """The slide lands in the bucket as foreground grid cells with small
    integer coordinates, some padding behind them."""
    b = case["batch"]
    n_fg = int(b.mask.sum())
    assert b.bag.shape == (1, 511, 32) and 250 < n_fg < 400
    assert np.all(b.coords == np.round(b.coords)) and b.coords.max() < 225
    assert np.all(b.bag[0, n_fg:] == 0)


def test_titan_embed_step_matches_jax(case):
    """(d) 3-task embeddings at 1e-4 for both names."""
    model = _port_model(case)
    assert isinstance(model, TitanModalTuneModel)
    model.load_state_dict(params_from_jax(case["params"], model))
    got = make_embed_step(model, TrainConfig())(
        batch_to_device(case["batch"], "cpu"))
    assert got.shape == (1, 3, 32) == case["want"].shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), case["want"], atol=TOL, rtol=TOL)


def test_titan_bg_invariance(case):
    """Background (invalid) grid cells must not influence the output."""
    model = _port_model(case)
    model.load_state_dict(params_from_jax(case["params"], model))
    step = make_embed_step(model, TrainConfig())
    batch = case["batch"]
    noise = (np.random.RandomState(1).randn(*batch.bag.shape) * 30
             ).astype(np.float32)
    noisy = dataclasses.replace(
        batch, bag=np.where(batch.mask[..., None], batch.bag, noise))
    out1 = step(batch_to_device(batch, "cpu"))
    out2 = step(batch_to_device(noisy, "cpu"))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=TOL, rtol=TOL)


def test_titan_converter_raises_on_leftover_keys(case):
    """(f) a missing, a stray and a misshapen TITAN key."""
    model = _port_model(case)
    params = case["params"]

    def backbone(**changes):
        return dict(params, backbone=dict(params["backbone"], **changes))

    blk = dict(params["backbone"]["blocks_1"])
    del blk["mlp_fc2"]
    with pytest.raises(KeyError, match=r"backbone.blocks.1.mlp.fc2.weight"):
        params_from_jax(backbone(blocks_1=blk), model)
    with pytest.raises(KeyError, match=r"backbone.blocks.9.norm1.weight"):
        params_from_jax(backbone(blocks_9={"norm1": {
            "scale": np.ones(64, np.float32)}}), model)
    with pytest.raises(KeyError, match=r"backbone.patch_embed.fc3.weight"):
        params_from_jax(backbone(patch_embed_fc3={
            "kernel": np.zeros((2, 2), np.float32)}), model)
    with pytest.raises(ValueError, match=r"backbone.cls_token"):
        params_from_jax(backbone(cls_token=np.zeros((1, 64), np.float32)),
                        model)
    pool = dict(params["backbone"]["attn_pool"],
                query=np.zeros((9, 64), np.float32))
    with pytest.raises(ValueError, match=r"backbone.attn_pool.query"):
        params_from_jax(backbone(attn_pool=pool), model)


def test_titan_parameter_names_follow_the_checkpoint(case):
    """The port's backbone keeps the original torch checkpoint's names."""
    names = set(_port_model(case).backbone.state_dict())
    for n in ("cls_token", "patch_embed.fc1.weight", "patch_embed.fc2.bias",
              "norm_pre.weight", "blocks.0.norm1.weight",
              "blocks.3.attn.qkv.weight", "blocks.3.attn.proj.bias",
              "blocks.2.mlp.fc1.weight", "blocks.2.mlp.fc2.weight",
              "norm.bias", "attn_pool.query", "attn_pool.ln_k.weight",
              "attn_pool.q_proj.weight", "attn_pool.k_proj.weight",
              "attn_pool.v_proj.bias", "attn_pool.out_proj.weight",
              "attn_pool.ln_out.bias"):
        assert n in names, n
    assert len(names) == 3 + 4 + 4 * 12 + 2 + 13


def test_titan_vit_pool_matches_jax():
    """(d) TitanViT on its own: embed, every block, the pooler."""
    cfg = _config().backbone
    _, batch = _batch(bucket=255, bag_range=(150, 200))
    args = [jnp.asarray(a) for a in (batch.bag, batch.coords, batch.mask)]
    jmodel = JaxTitanViT(cfg)
    params = jmodel.init(jax.random.PRNGKey(1), *args)["params"]
    want = np.asarray(jmodel.apply({"params": params}, *args))
    port = TitanViT(cfg)
    holder = torch.nn.ModuleDict({"backbone": port})
    holder.load_state_dict(params_from_jax(
        {"backbone": jax.device_get(params)}, holder))
    with torch.inference_mode():
        got = port.eval()(*(torch.from_numpy(a) for a in (
            batch.bag, batch.coords, batch.mask)))
    assert got.shape == (1, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_titan_without_alibi_is_a_plain_softmax():
    """``pos_encode_type`` other than "alibi": no bias context, a plain
    softmax over every token, as in JAX."""
    cfg = dataclasses.replace(_config(depth=2).backbone,
                              pos_encode_type="none")
    _, batch = _batch(bucket=255, bag_range=(150, 200))
    mask = np.ones_like(batch.mask)
    args = [jnp.asarray(a) for a in (batch.bag, batch.coords, mask)]
    jmodel = JaxTitanViT(cfg)
    params = jmodel.init(jax.random.PRNGKey(2), *args)["params"]
    want = np.asarray(jmodel.apply({"params": params}, *args))
    port = TitanViT(cfg)
    holder = torch.nn.ModuleDict({"backbone": port})
    holder.load_state_dict(params_from_jax(
        {"backbone": jax.device_get(params)}, holder))
    with torch.inference_mode():
        got = port.eval()(*(torch.from_numpy(a) for a in (
            batch.bag, batch.coords, mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_titan_random_init_and_default_device():
    """init_weights reaches every TITAN parameter and is reproducible from
    its generator; without a card ``create_aggregator`` and
    ``batch_to_device`` raise unless given the CPU."""
    cfg = _config(clinical=True)
    packer, batch = _batch(clinical=True, bucket=255, bag_range=(150, 200))
    kw = dict(cfg=cfg, n_gene_groups=packer.n_groups,
              max_group_len=packer.max_group_len)
    a, b = (init_weights(
        create_aggregator("titan_gene_clinical_adapter", device="cpu", **kw),
        torch.Generator().manual_seed(3)) for _ in range(2))
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    out = make_embed_step(a, TrainConfig())(batch_to_device(batch, "cpu"))
    assert out.shape == (1, 3, 32) and torch.isfinite(out).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_aggregator("titan_gene_clinical_adapter", **kw)
        with pytest.raises((RuntimeError, AssertionError)):
            batch_to_device(batch)


def test_titan_frozen_cast_keeps_the_slopes():
    """Casting the frozen backbone to bf16 must not round the ALiBi
    slopes, which are no parameters."""
    cfg = _config()
    packer, batch = _batch(bucket=255, bag_range=(150, 200))
    model = init_weights(create_aggregator(
        "titan_gene_adapter", device="cpu", cfg=cfg,
        n_gene_groups=packer.n_groups, max_group_len=packer.max_group_len),
        torch.Generator().manual_seed(0))
    freeze_backbone(model, torch.bfloat16)
    inputs = batch_to_device(batch, "cpu")
    _, bias, _ = model.backbone.embed(
        inputs["bag"].to(torch.bfloat16), inputs["coords"], inputs["mask"])
    kind, coords3, slopes, key_mask = bias
    assert kind == "alibi" and slopes.dtype == torch.float32
    assert np.array_equal(slopes.numpy(), np.array(
        [2.0 ** (-8.0 * (i + 1) / 4) for i in range(4)], np.float32))
    assert coords3.dtype == torch.float32 and coords3.shape == (1, 256, 3)
    assert coords3[0, 0].tolist() == [0.0, 0.0, 1.0]
    assert torch.equal(coords3[0, 1:, :2], inputs["coords"][0])
    assert key_mask[0, 0] and torch.equal(key_mask[0, 1:], inputs["mask"][0])


def test_titan_train_step_matches_jax():
    """(e) JAX ``make_train_step`` and the port's from the same parameters
    and text projector, dropout off (the tiny config has none), three
    steps on one grid-scattered slide.

    Tolerances as ``test_torch_train.py::test_train_step_matches_jax``,
    for its reasons, but for the losses: the KD loss's fp32 floor on
    these embeddings (JAX against itself in other summation orders) is
    measured here at 4.7e-5, above that test's 3e-5, and the two packages'
    losses differ by 8e-7 to 5e-5, so all three are held at
    ``TITAN_LOSS_TOL``; the first
    step's adapter gradients at 1e-4 x max|g| per tensor (the
    ``NULL_GRAD`` tensors, whose gradient is rounding noise, at 1e-4 x the
    largest gradient of all); parameters after three steps within 2 % of
    the tensor's update. The loss is scaled by 1e-8 so that every
    gradient lies below AdamW's eps and the step is proportional to the
    gradient."""
    cfg = _config(output_dim=256)       # the text projector's width
    tcfg = TrainConfig(lr=0.2, kd_loss_scale=1e-8)
    spe = 3
    packer, batch = _batch()
    jmodel = JaxTitanModalTune(cfg, n_gene_groups=packer.n_groups,
                               max_group_len=packer.max_group_len)
    jb = _jax_batch(batch)
    params = _jax_params(jmodel, jb)
    jproj, proj_params, projector = _projectors()
    jtext = j_project_text(jproj, proj_params, jnp.asarray(batch.text))

    state = TrainState.create(params, j_make_optimizer(tcfg, spe))
    row_valid = np.ones(1, np.float32)
    jlogits, jeval_loss = j_make_eval_step(jmodel, tcfg)(
        state, jb, jtext, jnp.asarray(row_valid))
    floor = _kd_loss_floor(jlogits, jtext)
    assert LOSS_TOL < floor <= TITAN_LOSS_TOL, floor
    _, jgrads = j_make_grad_step(jmodel, tcfg)(state, jb, jtext,
                                               jax.random.PRNGKey(0))
    jstep = j_make_train_step(jmodel, tcfg, donate=False)
    jlosses = []
    for i in range(3):
        state, loss = jstep(state, jb, jtext, jax.random.PRNGKey(i))
        jlosses.append(float(loss))

    model = create_aggregator("titan_gene_adapter", device="cpu", cfg=cfg,
                              n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    p0 = params_from_jax(params, model)
    model.load_state_dict(p0)
    opt = make_optimizer(tcfg, freeze_backbone(model), spe)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    assert frozen and all(n.startswith("backbone.") for n in frozen)
    text = project_text(projector, _t(batch.text))
    inputs = batch_to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(0)
    logits, eval_loss = make_eval_step(model, tcfg)(inputs, text,
                                                    _t(row_valid))
    _, grads = make_grad_step(model, tcfg)(inputs, text, gen)
    step = make_train_step(model, tcfg, opt)
    losses = [float(step(inputs, text, gen)) for _ in range(3)]

    np.testing.assert_allclose(losses, jlosses, rtol=TITAN_LOSS_TOL)

    def as_port(trainable):
        return params_from_jax(dict(trainable, backbone=params["backbone"]),
                               model)

    want_g = as_port(jax.device_get(jgrads))
    assert set(grads) == {n for n in p0 if not n.startswith("backbone.")}
    g_all = max(float(g.abs().max()) for g in want_g.values())
    for n, g in grads.items():
        scale = g_all if n.endswith(NULL_GRAD) else \
            float(want_g[n].abs().max())
        err = float((g - want_g[n]).abs().max())
        assert err <= 1e-4 * scale, (n, err, scale)

    want_p = as_port(jax.device_get(state.trainable))
    got_p = model.state_dict()
    upd = {n: float((want_p[n] - p0[n]).abs().max()) for n in grads}
    upd_all = max(upd.values())
    assert upd_all > 0
    for n in grads:
        scale = upd_all if n.endswith(NULL_GRAD) else upd[n]
        err = float((got_p[n] - want_p[n]).abs().max())
        assert err <= 0.02 * scale, (n, err, scale)
    for n, p in frozen.items():
        assert torch.equal(got_p[n], p), n

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(eval_loss), float(jeval_loss),
                               rtol=TITAN_LOSS_TOL)
