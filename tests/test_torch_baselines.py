"""The port's supervised baselines against the JAX package's, on the CPU.

ABMIL, TransMIL (Nystrom attention, PPEG) and the genomics-only model,
their heads, losses, duration bins and trainers, with parameters carried
across by ``utils.convert.params_from_jax`` and inputs made with numpy
from a seed, in fp32. Tolerances:

* **Models**, every mode (feature, classifier, survival) and fusion (none,
  "(cat)"), eval mode, on bags that hold padding: the largest error over
  the largest output, ``MODEL_TOL`` = 1e-5 for ABMIL and the gene model
  and ``TRANSMIL_TOL`` = 1e-4 for TransMIL, whose Newton-Schulz
  pseudo-inverse amplifies rounding. Read on this file's inputs: at most
  5.7e-7 (ABMIL), 1.1e-7 (gene model) and 2.6e-7 (TransMIL); predicted
  bins equal.
* **Padding** never leaks: the output is unchanged (1e-5, as
  ``tests/test_mil.py``) when the padded rows' values change.
* **Pseudo-inverse**: on well-conditioned matrices the iteration meets
  ``torch.linalg.pinv`` within 1e-4; on softmax matrices it equals JAX's
  within 1e-5 relative.
* **PPEG** with an asymmetric kernel (kh != kw order) equals JAX's within
  1e-6 of its largest output; its kernels read with a plain transpose
  give another result.
* **Losses** and their gradients through the survival head within 1e-6
  relative; duration bins and bin indices equal.
* **Trainers**, 2 epochs from the same parameters with dropout 0 on both
  sides (the gene model; ABMIL classifier; TransMIL "(cat)" survival):
  each epoch's train loss within ``LOSS_TOL`` = 1e-4 relative (read: at
  most 6.7e-7), every val and test metric within ``METRIC_TOL`` = 1e-3;
  the best weights are written and reloaded.
* **CLI**: ``--mil_name abmil|transmil|gene_mixer_group --tiny 1
  --device cpu`` trains, validates and tests on synthetic data.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.configs import GeneEncoderConfig as JGeneCfg
from modaltune_tpu.configs import TrainConfig as JTrainConfig
from modaltune_tpu.data import SyntheticSlideDataset as JSynthetic
from modaltune_tpu.models import mil as j_mil
from modaltune_tpu.models.gene import GeneOnlyModel as JGeneOnly
from modaltune_tpu.models.heads import survival_from_logits as j_survival
from modaltune_tpu.train import gene_trainer as j_gene_trainer
from modaltune_tpu.train import losses as j_losses
from modaltune_tpu.train.mil_trainer import MilBaselineTrainer as JMilTrainer
from modaltune_tpu_torch import create_aggregator, params_from_jax
from modaltune_tpu_torch.configs import GeneEncoderConfig, TrainConfig
from modaltune_tpu_torch.data import SyntheticSlideDataset
from modaltune_tpu_torch.models import mil as p_mil
from modaltune_tpu_torch.models.heads import survival_from_logits
from modaltune_tpu_torch.tools import train as cli
from modaltune_tpu_torch.train import gene_trainer as p_gene_trainer
from modaltune_tpu_torch.train import losses as p_losses
from modaltune_tpu_torch.train.mil_trainer import MilBaselineTrainer
from _one_thread import one_thread  # noqa: F401

MODEL_TOL = 1e-5
TRANSMIL_TOL = 1e-4
LOSS_TOL = 1e-4
METRIC_TOL = 1e-3
IN_DIM = 32
GENE = dict(latent_dim=16, depth=1, output_dim=24, final_groups=4)
MIL = dict(abmil=dict(hidden=32, attn_dim=16),
           transmil=dict(hidden=32, heads=4, landmarks=16))
PACKER = SyntheticSlideDataset(n_cases=1).packer


def _inputs(seed=0, b=2, n=50):
    rng = np.random.RandomState(seed)
    bag = rng.randn(b, n, IN_DIM).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([[37], [n]])
    genes = rng.randn(b, PACKER.n_groups, PACKER.max_group_len) \
        .astype(np.float32)
    return bag, mask, genes


def _gene_kw(fusion, dropout):
    if fusion != "cat":
        return {}, {}
    cfg = GENE if dropout is None else dict(GENE, dropout=dropout)
    common = dict(n_gene_groups=PACKER.n_groups,
                  max_group_len=PACKER.max_group_len)
    return (dict(common, gene_cfg=JGeneCfg(**cfg)),
            dict(common, gene_cfg=GeneEncoderConfig(**cfg)))


def _pair(name, mode, fusion, n_classes=3, dropout=None):
    """-> (JAX model, its parameters, the port's model holding them)."""
    bag, mask, genes = _inputs()
    if name == "gene_mixer_group":
        cfg = dict(GENE, dropout=0.0 if dropout is None else dropout)
        jm = JGeneOnly(JGeneCfg(**cfg), PACKER.n_groups, PACKER.max_group_len,
                       n_classes=n_classes, mode=mode)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(genes))["params"]
        pm = create_aggregator(name, device="cpu",
                               cfg=GeneEncoderConfig(**cfg),
                               n_gene_groups=PACKER.n_groups,
                               max_group_len=PACKER.max_group_len,
                               n_classes=n_classes, mode=mode)
    else:
        jkw, pkw = _gene_kw(fusion, dropout)
        extra = {} if dropout is None else dict(dropout=dropout)
        cls = {"abmil": j_mil.AbmilModel, "transmil": j_mil.TransMilModel}
        jm = cls[name](n_classes=n_classes, mode=mode, **MIL[name], **jkw,
                       **extra)
        args = [jnp.asarray(bag), jnp.asarray(mask)]
        if fusion == "cat":
            args.append(jnp.asarray(genes))
        params = jm.init(jax.random.PRNGKey(1), *args)["params"]
        pm = create_aggregator(name, device="cpu", in_dim=IN_DIM,
                               n_classes=n_classes, mode=mode, **MIL[name],
                               **pkw, **extra)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    # give the zero-initialised tensors (biases, cls token) values, so
    # that a misplaced one shows
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32)
        if not a.any() else a, params)
    pm.load_state_dict(params_from_jax(params, pm))
    return jm, params, pm.eval()


def _apply(jm, params, pm, name, fusion, bag, mask, genes):
    if name == "gene_mixer_group":
        jargs, pargs = (jnp.asarray(genes),), (torch.from_numpy(genes),)
    else:
        jargs = (jnp.asarray(bag), jnp.asarray(mask))
        pargs = (torch.from_numpy(bag), torch.from_numpy(mask))
        if fusion == "cat":
            jargs += (jnp.asarray(genes),)
            pargs += (torch.from_numpy(genes),)
    want = jm.apply({"params": params}, *jargs)
    with torch.no_grad():
        got = pm(*pargs)
    return want, got


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


CASES = [(name, mode, fusion)
         for name in ("abmil", "transmil")
         for mode in ("feature", "classifier", "survival")
         for fusion in ("none", "cat")] + [
    ("gene_mixer_group", mode, "none")
    for mode in ("feature", "classifier", "survival")]


@pytest.mark.parametrize("name,mode,fusion", CASES,
                         ids=["-".join(c) for c in CASES])
def test_model_matches_jax(name, mode, fusion):
    jm, params, pm = _pair(name, mode, fusion)
    bag, mask, genes = _inputs(seed=3)
    want, got = _apply(jm, params, pm, name, fusion, bag, mask, genes)
    want, got = _outputs(want), _outputs(got)
    assert len(want) == len(got)
    tol = TRANSMIL_TOL if name == "transmil" else MODEL_TOL
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if mode == "survival" and i == 2:         # the predicted bin
            np.testing.assert_array_equal(g, w)
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        print(f"{name} {mode} {fusion} output {i}: max rel err {err:.3g}")
        assert err <= tol, (i, err)


@pytest.mark.parametrize("name", ["abmil", "transmil"])
def test_padding_never_leaks(name):
    _, _, pm = _pair(name, "classifier", "cat")
    bag, mask, genes = _inputs(seed=4)
    garbage = np.where(mask[:, :, None], bag, 1e3).astype(np.float32)
    with torch.no_grad():
        a = pm(torch.from_numpy(bag), torch.from_numpy(mask),
               torch.from_numpy(genes))
        b = pm(torch.from_numpy(garbage), torch.from_numpy(mask),
               torch.from_numpy(genes))
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5)


def test_newton_schulz_pinv_against_pinv_and_jax():
    rng = np.random.RandomState(0)
    a = (np.eye(16) + 0.1 * rng.randn(3, 16, 16)).astype(np.float32)
    got = p_mil._newton_schulz_pinv(torch.from_numpy(a), iters=6)
    want = torch.linalg.pinv(torch.from_numpy(a))
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    # the model's inputs: softmax rows, near-singular, where the truncated
    # iteration regularises (tests/test_mil.py) and the two packages agree
    logits = rng.randn(3, 16, 16).astype(np.float32)
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    got = p_mil._newton_schulz_pinv(torch.from_numpy(soft)).numpy()
    want = np.asarray(j_mil._newton_schulz_pinv(jnp.asarray(soft)))
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_ppeg_asymmetric_kernels_match_jax():
    c, n = 6, 30
    rng = np.random.RandomState(2)
    tokens = rng.randn(2, n, c).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([[23], [n]])
    jm = j_mil.PPEG(c)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                     jnp.asarray(mask))["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    for k in (7, 5, 3):
        # rows and columns of the kernel carry different values
        kern = rng.randn(k, k, 1, c).astype(np.float32)
        kern[:, 0] += 3.0
        assert not np.allclose(kern, kern.transpose(1, 0, 2, 3))
        params[f"conv{k}"] = dict(kernel=kern,
                                  bias=rng.randn(c).astype(np.float32))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens),
                               jnp.asarray(mask)))
    pm = p_mil.PPEG(c)
    pm.load_state_dict(params_from_jax(params, pm))
    with torch.no_grad():
        got = pm(torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"PPEG: max rel err {err:.3g}")
    assert err <= 1e-6, err
    # the trap: the kernels read with a plain transpose swap kh and kw
    sd = {f"conv{k}.weight": torch.from_numpy(params[f"conv{k}"]["kernel"].T
                                              .copy()) for k in (7, 5, 3)}
    pm.load_state_dict(sd, strict=False)
    with torch.no_grad():
        swapped = pm(torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()
    assert np.abs(swapped - want).max() > 1e-2


def test_losses_and_gradients_match_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(9, 4).astype(np.float32)
    labels = rng.randint(0, 4, 9).astype(np.int32)
    events = (rng.rand(9) < 0.5).astype(np.int32)
    events[:2] = (0, 1)

    def j_ce(x):
        return j_losses.cross_entropy_loss(x, jnp.asarray(labels))

    def j_surv(x):
        hazards, s, _ = j_survival(x)
        return j_losses.survival_nll_loss(hazards, s, jnp.asarray(labels),
                                          jnp.asarray(events))

    def p_ce(x):
        return p_losses.cross_entropy_loss(x, torch.from_numpy(labels))

    def p_surv(x):
        hazards, s, _ = survival_from_logits(x)
        return p_losses.survival_nll_loss(hazards, s,
                                          torch.from_numpy(labels),
                                          torch.from_numpy(events))

    for jf, pf in ((j_ce, p_ce), (j_surv, p_surv)):
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        pv = pf(x)
        pv.backward()
        np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   rtol=1e-6, atol=1e-6 * np.abs(jg).max())


def test_duration_bins_equal_jax():
    rng = np.random.RandomState(7)
    t = rng.randint(1, 120, 40).astype(float)
    for e in ((rng.rand(40) < 0.6).astype(int), np.zeros(40, int)):
        for n_bins in (2, 4, 7):
            want = j_gene_trainer.duration_bins(t, e, n_bins)
            got = p_gene_trainer.duration_bins(t, e, n_bins)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                p_gene_trainer.to_bins(t, got),
                j_gene_trainer.to_bins(t, want))


# ----------------------------------------------------------------------
# trainers, 2 epochs from the same parameters
# ----------------------------------------------------------------------

def _planted(synthetic, n_train=16, n_eval=12):
    """Bags whose label is a mean shift of the instance features."""
    sets = {}
    for name, (n, seed) in (("train", (n_train, 0)), ("val", (n_eval, 1)),
                            ("test", (n_eval, 2))):
        ds = synthetic(n_cases=n, in_chans=IN_DIM, bag_range=(30, 60),
                       seed=seed)
        for e in ds._examples:
            e.bag = e.bag + 0.5 * e.label
        sets[name] = ds
    return sets


TRAIN = dict(lr=1e-3, num_epochs=2, warmup_epochs=1, seed=0)
TRAINER_CASES = [("gene_mixer_group", "classifier", "none"),
                 ("abmil", "classifier", "none"),
                 ("transmil", "survival", "cat")]


def _rows(out_dir):
    return [json.loads(line) for line in open(Path(out_dir) /
                                              "run_metrics.jsonl")]


@pytest.mark.parametrize("name,mode,fusion", TRAINER_CASES,
                         ids=["-".join(c) for c in TRAINER_CASES])
def test_trainer_matches_jax(name, mode, fusion, tmp_path):
    jm, params, pm = _pair(name, mode, fusion, n_classes=2, dropout=0.0)
    kw = dict(batch_size=4, buckets=(64,))
    if name == "gene_mixer_group":
        jt = j_gene_trainer.GeneBaselineTrainer(
            jm, JTrainConfig(**TRAIN), _planted(JSynthetic), str(
                tmp_path / "jax"), batch_size=4)
        pt = p_gene_trainer.GeneBaselineTrainer(
            pm, TrainConfig(**TRAIN), _planted(SyntheticSlideDataset),
            str(tmp_path / "port"), batch_size=4)
    else:
        jt = JMilTrainer(jm, JTrainConfig(**TRAIN), _planted(JSynthetic),
                         str(tmp_path / "jax"), **kw)
        pt = MilBaselineTrainer(pm, TrainConfig(**TRAIN),
                                _planted(SyntheticSlideDataset),
                                str(tmp_path / "port"), **kw)
    jbest = jt.run(params)
    pbest = pt.run(params_from_jax(params, pm))
    jrows, prows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]
    for jr, pr in zip(jrows, prows):
        for k, v in jr.items():
            if k in ("_time", "_step", "epoch", "epoch_sec"):
                continue
            if k == "train_loss":
                print(f"{name} epoch {jr['epoch']} loss rel "
                      f"{abs(pr[k] - v) / abs(v):.3g}")
                assert abs(pr[k] - v) <= LOSS_TOL * abs(v), (k, pr[k], v)
            else:
                assert abs(pr[k] - v) <= METRIC_TOL, (k, pr[k], v)
    assert abs(pbest - jbest) <= METRIC_TOL
    # the best weights were written, and the model holds them after run()
    best = torch.load(tmp_path / "port" / "best_model_weights.pt",
                      weights_only=True)
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, best[k]), k
    assert any(k.startswith("test_") for r in prows for k in r)


@pytest.mark.parametrize("flags", [["--mil_name", "abmil"],
                                   ["--mil_name", "transmil", "--fusion",
                                    "cat", "--mode", "survival"],
                                   ["--mil_name", "gene_mixer_group",
                                    "--num_classes", "3"]],
                         ids=["abmil", "transmil-cat-survival",
                              "gene_mixer_group"])
def test_cli_trains_the_baselines(flags, tmp_path):
    cli.main(["--tiny", "1", "--synthetic", "1", "--device", "cpu",
              "--num_epochs", "2", "--output_path", str(tmp_path), *flags])
    run = tmp_path / "seed_0"
    rows = _rows(run)
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (run / "best_model_weights.pt").exists()
    key = "test_c_index" if "survival" in flags else "test_bal_acc"
    assert any(key in r for r in rows)
