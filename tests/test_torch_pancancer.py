"""The port's pan-cancer readout, trainer and CLI against the JAX package's,
on the CPU.

**The readout.** ``perform_testing_pancancer`` of both packages on the same
planted 4-site embeddings, whose classes and sites are well separated, with
``strata_pooled`` False and True: every ``acc`` and ``bal_acc`` equal (the
port's LogReg is liblinear's exact minimiser, sklearn's is iterative:
``test_torch_readout.py``), every ``c_index`` and ``pooled_c_index`` within
1e-6 (``CoxPH`` is the same code in both, ``test_torch_imports.py``).

**The trainers.** One run of the JAX package's ``PanCancerTrainer.run`` +
``deploy`` and one of the port's, from the same parameters
(``params_from_jax``) and text projector (``projector_from_jax``), on
``tiny_test_config()`` (no dropout) and ``SyntheticSlideDataset`` splits of
24 / 12 / 12 cases, four sites with real TCGA project ids (the wrapper of
``tests/test_pancancer.py``; the synthetic dataset's own ids name no site),
under ``test_torch_trainer.py``'s ``TrainConfig`` for 2 epochs. Each epoch's
loss within ``LOSS_TOL`` (3e-5) relative; every ``val_site{s}_bal_acc`` and
``val_cancer_site_acc`` equal, every ``val_site{s}_c_index`` within
``READOUT_TOL`` (1e-3): the heads are fitted on embeddings that differ by
fp32 rounding. ``deploy_results_pancancer.json`` has the same keys, its
c-indices within 1e-3 and its classification metrics equal.

**Port only:** under ``reference_quirks`` a pan-cancer epoch runs every
batch of the loader where the single-site trainer runs 6; the CLI with
``--tiny 1 --device cpu --pancancer 1`` trains, tests and deploys on the
reference's drop-in formats with four projects' ids.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modaltune_tpu.configs import TrainConfig as JTrainConfig
from modaltune_tpu.configs import tiny_test_config as j_tiny_config
from modaltune_tpu.data import SyntheticSlideDataset as JSynthetic
from modaltune_tpu.eval import pancancer as j_pancancer
from modaltune_tpu.models import ModalTuneModel as JModel
from modaltune_tpu.train.pancancer_trainer import \
    PanCancerTrainer as JPanCancer
from modaltune_tpu_torch import (create_aggregator, init_weights,
                                 params_from_jax, projector_from_jax)
from modaltune_tpu_torch.configs import TrainConfig, tiny_test_config
from modaltune_tpu_torch.data import SyntheticSlideDataset
from modaltune_tpu_torch.eval import pancancer as p_pancancer
from modaltune_tpu_torch.tools import train as cli
from modaltune_tpu_torch.train.pancancer_trainer import PanCancerTrainer
from modaltune_tpu_torch.train.trainer import ModalTuneTrainer
from modaltune_tpu_torch.utils.constants import SITE_LABEL
from test_dropin_e2e import _write_reference_artifacts
from test_torch_trainer import LOSS_TOL, READOUT_TOL, TRAIN
from _one_thread import one_thread  # noqa: F401

PROJECTS = ["TCGA-BRCA", "TCGA-GBM", "TCGA-LUAD", "TCGA-KIRC"]
SITES = ("TCGA-BRCA", "TCGA-GBMLGG", "TCGA-NSCLC", "TCGA-RCC")
CASES = dict(train=24, val=12, test=12)
EPOCHS = 2


def _planted(n=160, tasks=3, dim=12, seed=0):
    """Embeddings whose class and site signals lie on disjoint, well
    separated dims; durations follow the first dim."""
    rng = np.random.RandomState(seed)
    meta, xs = [], []
    for i in range(n):
        proj = PROJECTS[i % 4]
        y = rng.randint(0, 2)
        x = rng.randn(tasks, dim)
        x[:, :4] += y * 6.0
        x[:, 4 + SITE_LABEL[proj]] += 6.0
        xs.append(x)
        meta.append(dict(case_id=f"c{i}", primary_class=y,
                         durations=float(np.exp(-x[0, 0] / 4) * 20 + 1),
                         vital_status=int(rng.rand() < 0.8),
                         project_id=proj))
    return np.stack(xs), meta


def _results_agree(got, want, c_tol):
    assert got.keys() == want.keys()
    for site, tasks in want.items():
        assert got[site].keys() == tasks.keys(), site
        for task, metrics in tasks.items():
            assert got[site][task].keys() == metrics.keys(), (site, task)
            for k, v in metrics.items():
                if k in ("c_index", "pooled_c_index"):
                    assert abs(got[site][task][k] - v) <= c_tol, \
                        (site, task, k, got[site][task][k], v)
                elif k in ("acc", "bal_acc", "recall", "precision", "f1"):
                    assert got[site][task][k] == v, (site, task, k)


@pytest.mark.parametrize("strata_pooled", [False, True])
def test_perform_testing_pancancer_matches_jax(strata_pooled):
    x_tr, m_tr = _planted(seed=0)
    x_te, m_te = _planted(seed=1)
    want = j_pancancer.perform_testing_pancancer(
        x_tr, m_tr, x_te, m_te, strata_pooled=strata_pooled)
    got = p_pancancer.perform_testing_pancancer(
        x_tr, m_tr, x_te, m_te, strata_pooled=strata_pooled)
    assert set(SITES) | {"site_classification"} == set(got)
    assert got["site_classification"].keys() == {"General", "Diagnosis",
                                                 "Survival"}
    _results_agree(got, want, 1e-6)


# ----------------------------------------------------------------------
# the trainers
# ----------------------------------------------------------------------

class _Sites:
    """A dataset whose cases carry real TCGA project ids, one site after
    another, and at least two observed events a site."""

    def __init__(self, inner):
        self.inner = inner
        self.packer = inner.packer
        self.case_ids = inner.case_ids

    def __len__(self):
        return len(self.inner)

    def metadata(self):
        rows = []
        for i, m in enumerate(self.inner.metadata()):
            m = dict(m, project_id=PROJECTS[i % 4])
            if i < 8:
                m["vital_status"] = 1
            rows.append(m)
        return rows

    def get(self, i, rng):
        return self.inner.get(i, rng)


def _splits(synthetic, cases=CASES):
    packer = synthetic(n_cases=1).packer
    return {name: _Sites(synthetic(n_cases=n, in_chans=64,
                                   bag_range=(40, 80), packer=packer,
                                   seed=i))
            for i, (name, n) in enumerate(cases.items())}


def _rows(out_dir):
    return [json.loads(line) for line in open(Path(out_dir) /
                                              "run_metrics.jsonl")]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_pancancer")
    cfg = j_tiny_config()
    datasets = _splits(JSynthetic)
    packer = datasets["train"].packer
    model = JModel(cfg, n_gene_groups=packer.n_groups,
                   max_group_len=packer.max_group_len)
    trainer = JPanCancer(model, JTrainConfig(**dict(TRAIN,
                                                    num_epochs=EPOCHS)),
                         datasets, str(out), buckets=(96,), model_cfg=cfg)
    ex = datasets["train"].get(0, np.random.RandomState(0))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ex.bag[None, :40]),
                        jnp.asarray(ex.coords[None, :40]),
                        jnp.asarray(ex.genes[None]),
                        task_token=jnp.eye(3)[:1])["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(7)        # Injectors are identities at init
    for name, block in params.items():
        if name.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    best = trainer.run(params)
    deploy = trainer.deploy()
    return dict(out=out, params=params, best=best, deploy=deploy,
                proj=jax.device_get(trainer.proj_params))


def _port_model(cfg=None):
    cfg = cfg or tiny_test_config()
    packer = SyntheticSlideDataset(n_cases=1).packer
    return create_aggregator("longnetvit_gene_adapter", device="cpu", cfg=cfg,
                             n_gene_groups=packer.n_groups,
                             max_group_len=packer.max_group_len), cfg


def test_port_pancancer_trainer_matches_jax(jax_run, tmp_path):
    model, cfg = _port_model()
    trainer = PanCancerTrainer(
        model, TrainConfig(**dict(TRAIN, num_epochs=EPOCHS)),
        _splits(SyntheticSlideDataset), str(tmp_path), buckets=(96,),
        model_cfg=cfg, projector=projector_from_jax(jax_run["proj"]))
    best = trainer.run(params_from_jax(jax_run["params"], model))
    deploy = trainer.deploy()

    jrows, prows = _rows(jax_run["out"]), _rows(tmp_path)
    jtrain = [r for r in jrows if "train_loss" in r]
    ptrain = [r for r in prows if "train_loss" in r]
    assert [r["epoch"] for r in ptrain] == [r["epoch"] for r in jtrain] == \
        list(range(EPOCHS))
    np.testing.assert_allclose([r["train_loss"] for r in ptrain],
                               [r["train_loss"] for r in jtrain],
                               rtol=LOSS_TOL)
    for jr, pr in zip(jtrain, ptrain):
        assert set(pr) == set(jr)
        for s in range(4):          # every site has both heads
            assert f"val_site{s}_bal_acc" in pr and \
                f"val_site{s}_c_index" in pr, (jr["epoch"], s)
        for k, v in jr.items():
            if k.endswith("bal_acc") or k.endswith("cancer_site_acc"):
                assert pr[k] == v, (jr["epoch"], k)
            elif k.endswith("c_index"):
                assert abs(pr[k] - v) <= READOUT_TOL, (jr["epoch"], k)
            elif k.endswith("cls_loss"):
                np.testing.assert_allclose(pr[k], v, rtol=LOSS_TOL)
    assert best == jax_run["best"]
    want = json.load(open(jax_run["out"] / "deploy_results_pancancer.json"))
    got = json.load(open(tmp_path / "deploy_results_pancancer.json"))
    assert set(got) == set(SITES) | {"site_classification"}
    _results_agree(got, want, READOUT_TOL)
    _results_agree(deploy, jax_run["deploy"], READOUT_TOL)


@pytest.mark.parametrize("cls,steps", [(PanCancerTrainer, 8),
                                       (ModalTuneTrainer, 6)],
                         ids=["pancancer", "single_site"])
def test_reference_quirks_cap_only_the_single_site_epoch(cls, steps,
                                                         tmp_path):
    import torch
    model, cfg = _port_model()
    init_weights(model, torch.Generator().manual_seed(0))
    trainer = cls(model, TrainConfig(**dict(TRAIN, reference_quirks=True)),
                  _splits(SyntheticSlideDataset, dict(train=8)),
                  str(tmp_path), buckets=(96,), model_cfg=cfg)
    trainer.init_state(model.state_dict())
    assert len(trainer.train_loader) == 8
    trainer.train_one_epoch()
    assert len(trainer.step_ms) == steps


def test_cli_pancancer_on_the_reference_files(tmp_path):
    db = tmp_path / "db"
    splits = _write_reference_artifacts(db, np.random.RandomState(0))
    for path in splits.values():       # four projects, one after another
        data = json.load(open(path))
        cases = list(dict.fromkeys(r["case_id"] for r in data["data"]))
        for r in data["data"]:
            r["project_id"] = PROJECTS[cases.index(r["case_id"]) % 4]
        json.dump(data, open(path, "w"))
    out = tmp_path / "results"
    cli.main(["--tiny", "1", "--device", "cpu", "--pancancer", "1",
              "--num_epochs", "1", "--save_embeddings",
              "--output_path", str(out),
              "--train_json", splits["train"], "--val_json", splits["val"],
              "--test_json", splits["test"],
              "--genomics_csv_path",
              str(db / "tcga_brca_xena_clean_pathway.csv"),
              "--pathway_csv", str(db / "gene_pathway_processed.csv"),
              "--text_location", str(db / "BRCA_textembeddings_conch.pt")])
    run = out / "seed_0"
    rows = _rows(run)
    assert all(np.isfinite(r["train_loss"]) for r in rows
               if "train_loss" in r)
    assert any("val_cancer_site_acc" in r for r in rows)
    deploy = json.load(open(run / "deploy_results_pancancer.json"))
    assert set(SITES) <= set(deploy)
    assert deploy["site_classification"].keys() == {"General", "Diagnosis",
                                                    "Survival"}
