"""The port's ModalTune embed step against the JAX package's, on the CPU.

One bag of ~1,500 valid tokens in the 2047 bucket (L = 2048 with the cls
token) goes through JAX ``multitask_logits`` and the port's
``make_embed_step`` with the same parameters, carried across by
``params_from_jax``. ``tiny_test_config(depth=4)`` has 2 interaction
blocks, so the prompt self-attention and the extra extractors run, and its
segment schedule (1024, 1448, 2048, 2896, 4096) really segments and pads
at L = 2048 (the 1448 branch pads to 2896). A third, smaller case takes
the remaining configuration branches (gene cls token, ``prompt_agg="cls"``,
the masked-mean image token of ``global_pool``), and the backbone alone
is compared through its own pooling head.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.configs import TrainConfig, tiny_test_config
from modaltune_tpu.data import (BucketedLoader, GenePacker,
                                SyntheticSlideDataset, synthetic_pathways)
from modaltune_tpu.models import ModalTuneModel as JaxModalTune
from modaltune_tpu.models.slide_encoder import LongNetViT as JaxLongNetViT
from modaltune_tpu.train.train_step import multitask_logits as j_logits
from modaltune_tpu_torch import (create_aggregator, init_weights,
                                 make_embed_step, params_from_jax)
from modaltune_tpu_torch.models import LongNetViT
from modaltune_tpu_torch.train import batch_to_device

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BUCKET = 2047
N_GENES = 60
# fp32 on both sides, the same algorithm; well inside the 2e-3 bar the
# JAX package met against the original torch model.
TOL = 1e-4

CASES = {
    "sum": dict(clinical=False, token_agg="sum"),
    "cat_clinical": dict(clinical=True, token_agg="cat"),
    "cls_pool_small": dict(clinical=False, token_agg="sum", depth=2,
                           prompt_agg="cls", gene_cls=True, global_pool=True,
                           bucket=511, bag_range=(300, 400)),
}


def _config(clinical, token_agg, depth=4, prompt_agg="avg", gene_cls=False,
            global_pool=False, **_):
    cfg = tiny_test_config(depth=depth, clinical=clinical)
    return dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(cfg.backbone, global_pool=global_pool),
        adapter=dataclasses.replace(cfg.adapter, token_agg=token_agg,
                                    prompt_agg=prompt_agg),
        gene=dataclasses.replace(cfg.gene, cls_token=gene_cls))


def _batch(clinical, bucket=BUCKET, bag_range=(1400, 1600)):
    groups = synthetic_pathways(n_genes=N_GENES, n_groups=12, max_size=7,
                                seed=0)
    packer = GenePacker.build(groups, [f"g{i}" for i in range(N_GENES)])
    ds = SyntheticSlideDataset(n_cases=1, in_chans=64,
                               bag_range=bag_range, packer=packer,
                               n_genes=N_GENES,
                               clinical_dim=5 if clinical else 0, seed=1)
    loader = BucketedLoader(ds, buckets=(bucket,), batch_size=1,
                            shuffle=False, prefetch=0,
                            device_prefetch=False)
    (batch,) = list(loader)
    return packer, batch


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """JAX parameters (Injector gammas set non-zero), the batch and the
    JAX embeddings, built once per case."""
    spec = CASES[request.param]
    cfg = _config(**spec)
    packer, batch = _batch(spec["clinical"], spec.get("bucket", BUCKET),
                           spec.get("bag_range", (1400, 1600)))
    jmodel = JaxModalTune(cfg, n_gene_groups=packer.n_groups,
                          max_group_len=packer.max_group_len)
    jb = dict(bag=jnp.asarray(batch.bag), coords=jnp.asarray(batch.coords),
              mask=jnp.asarray(batch.mask), genes=jnp.asarray(batch.genes),
              clinical=None if batch.clinical is None
              else jnp.asarray(batch.clinical))
    # jitted: one XLA program each is ~2x faster on the CPU than eager
    params = jax.jit(lambda key: jmodel.init(
        key, jb["bag"], jb["coords"], jb["genes"],
        task_token=jnp.eye(3)[:1], clinical=jb["clinical"],
        bag_mask=jb["mask"])["params"])(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    # init_values = 0 makes every Injector an identity at init; give the
    # gammas values so that the comparison sees the Injector at all
    rng = np.random.RandomState(7)
    for name, block in params.items():
        if name.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: j_logits(
        jmodel, p, jb, 3, deterministic=True))(params))
    return dict(name=request.param, cfg=cfg, packer=packer, batch=batch,
                params=params, want=want)


def _port_model(case):
    name = ("longnetvit_gene_clinical_adapter" if case["cfg"].adapter.
            with_clinical else "longnetvit_gene_adapter")
    return create_aggregator(name, device="cpu", cfg=case["cfg"],
                             n_gene_groups=case["packer"].n_groups,
                             max_group_len=case["packer"].max_group_len)


def test_embed_step_matches_jax(case):
    model = _port_model(case)
    model.load_state_dict(params_from_jax(case["params"], model))
    step = make_embed_step(model, TrainConfig())
    got = step(batch_to_device(case["batch"], "cpu"))
    assert got.shape == (1, 3, 256) == case["want"].shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), case["want"], atol=TOL, rtol=TOL)


def test_converter_raises_on_missing_and_extra_keys(case):
    model = _port_model(case)
    params = dict(case["params"])
    params["final_norm"] = {"scale": params["final_norm"]["scale"]}
    with pytest.raises(KeyError, match="final_norm.bias"):
        params_from_jax(params, model)
    params = dict(case["params"], stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="stray.weight"):
        params_from_jax(params, model)
    params = dict(case["params"], gene_pe=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="gene_pe"):
        params_from_jax(params, model)


def test_random_init_embed_step():
    """init_weights reaches every parameter and is reproducible from its
    generator; the randomly initialised model embeds a small bag to finite
    (B, 3, 256) values."""
    cfg = _config(clinical=True, token_agg="cat")
    packer, batch = _batch(clinical=True, bucket=511, bag_range=(300, 400))

    def build():
        return create_aggregator(
            "longnetvit_gene_clinical_adapter", device="cpu", cfg=cfg,
            n_gene_groups=packer.n_groups,
            max_group_len=packer.max_group_len)

    a = init_weights(build(), torch.Generator().manual_seed(3))
    b = init_weights(build(), torch.Generator().manual_seed(3))
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    out = make_embed_step(a, TrainConfig())(batch_to_device(batch, "cpu"))
    assert out.shape == (1, 3, 256)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("global_pool", [False, True])
def test_backbone_pool_matches_jax(global_pool):
    """LongNetViT on its own: embed, every layer, and the pooling head
    (cls token or masked mean, encoder and output LayerNorms)."""
    cfg = dataclasses.replace(_config(False, "sum", depth=2).backbone,
                              global_pool=global_pool)
    _, batch = _batch(False, bucket=511, bag_range=(300, 400))
    jmodel = JaxLongNetViT(cfg)
    args = [jnp.asarray(a) for a in (batch.bag, batch.coords, batch.mask)]
    params = jmodel.init(jax.random.PRNGKey(1), *args)["params"]
    want = np.asarray(jmodel.apply({"params": params}, *args))
    port = LongNetViT(cfg)
    holder = torch.nn.ModuleDict({"backbone": port})
    holder.load_state_dict(params_from_jax(
        {"backbone": jax.device_get(params)}, holder))
    with torch.inference_mode():
        got = port.eval()(*(torch.from_numpy(a) for a in (
            batch.bag, batch.coords, batch.mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_port_imports_no_jax():
    code = ("import sys; import modaltune_tpu_torch, "
            "modaltune_tpu_torch.ops, modaltune_tpu_torch.models, "
            "modaltune_tpu_torch.train, modaltune_tpu_torch.utils, "
            "modaltune_tpu_torch.configs, modaltune_tpu_torch.data; "
            "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
