"""The port's trainer and train CLI, on the CPU.

**The two trainers compared.** One run of the JAX package's
``ModalTuneTrainer.run`` and one of the port's, from the same parameters
(``params_from_jax``) and text projector (``projector_from_jax``), on
``tiny_test_config()`` (no dropout), ``SyntheticSlideDataset`` splits of 8
cases with bags of 40-80 patches, ``buckets=(96,)``, ``TrainConfig(lr=0.2,
kd_loss_scale=1e-8, num_epochs=3, warmup_epochs=1)``; the 1e-8 scale keeps
AdamW's step proportional to the gradient (``tests/test_torch_train.py::
train_step_against_jax`` says why). Tolerances:

* each epoch's train loss within ``LOSS_TOL`` (3e-5) relative, the KD
  loss's fp32 floor (``test_torch_train.py``);
* the last epoch's val task-0 embeddings within ``EMB_REL_L2`` (1e-3)
  relative L2;
* ``val_cls_acc`` and ``val_cls_bal_acc`` equal every epoch, ``auc`` and
  ``c_index`` within ``READOUT_TOL`` (1e-3): the readout heads are fitted
  on embeddings that differ by fp32 rounding, sklearn's liblinear against
  the port's exact minimiser (``test_torch_readout.py``).

**A JAX checkpoint deployed by the port.** The JAX run's
``best_model_weights.npz`` deployed by the port's trainer gives the JAX
deploy's ``x_feats_test`` within 1e-4 (the bar of ``test_torch_slice.py``)
and its ``deploy_results`` within the readout tolerances above.

**Port only:** the strict load refuses a mismatch; a checkpoint restores
bit-equal; ``run()`` resumes at the saved epoch; ``run_kfold``;
``fused_attention=False`` (each dilated branch on the flash-attention op)
gives the default route's embeddings within 1e-4.

**The CLI:** ``python -m modaltune_tpu_torch.tools.train --tiny 1
--device cpu`` on the reference's drop-in formats (written by
``tests/test_dropin_e2e.py``'s writer): train -> val -> test ->
``--save_embeddings``; then ``--eval_only 1 --eval_weights`` reloads the
run's ``config.json``; without a GPU and without ``--device cpu`` it exits
non-zero.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modaltune_tpu.configs import TrainConfig as JTrainConfig
from modaltune_tpu.configs import tiny_test_config as j_tiny_config
from modaltune_tpu.data import SyntheticSlideDataset as JSynthetic
from modaltune_tpu.models import ModalTuneModel as JModel
from modaltune_tpu.train.trainer import ModalTuneTrainer as JTrainer
from modaltune_tpu_torch import (create_aggregator, init_weights,
                                 make_embed_step, params_from_jax,
                                 projector_from_jax)
from modaltune_tpu_torch.configs import TrainConfig, tiny_test_config
from modaltune_tpu_torch.data import (SyntheticSlideDataset, kfold_splits,
                                      BucketedLoader)
from modaltune_tpu_torch.tools import train as cli
from modaltune_tpu_torch.train import batch_to_device
from modaltune_tpu_torch.train.trainer import ModalTuneTrainer, run_kfold
from test_dropin_e2e import _write_reference_artifacts

REPO = Path(__file__).resolve().parent.parent
LOSS_TOL = 3e-5
EMB_REL_L2 = 1e-3
READOUT_TOL = 1e-3
TRAIN = dict(lr=0.2, kd_loss_scale=1e-8, num_epochs=3, warmup_epochs=1)
SPLITS = ("train", "val", "test")


def _splits(synthetic, n_cases=8):
    packer = synthetic(n_cases=1).packer
    return {name: synthetic(n_cases=n_cases, in_chans=64, bag_range=(40, 80),
                            packer=packer, seed=i)
            for i, name in enumerate(SPLITS)}, packer


def _record_eval(trainer):
    """Keep every (stage, task-0 embeddings, metadata, loss) the trainer's
    eval pass returns."""
    calls, orig = [], trainer._eval_outputs

    def wrapped(stage):
        out = orig(stage)
        calls.append((stage,) + tuple(out))
        return out

    trainer._eval_outputs = wrapped
    return calls


def _rows(out_dir):
    return [json.loads(line) for line in open(Path(out_dir) /
                                              "run_metrics.jsonl")]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_run")
    cfg = j_tiny_config()
    datasets, packer = _splits(JSynthetic)
    model = JModel(cfg, n_gene_groups=packer.n_groups,
                   max_group_len=packer.max_group_len)
    trainer = JTrainer(model, JTrainConfig(**TRAIN), datasets, str(out),
                       buckets=(96,), model_cfg=cfg)
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
    calls = _record_eval(trainer)
    best = trainer.run(params)
    deploy = trainer.deploy()
    return dict(out=out, params=params, best=best, calls=calls,
                deploy=deploy,
                proj=jax.device_get(trainer.proj_params))


def _port_model(cfg=None):
    cfg = cfg or tiny_test_config()
    packer = SyntheticSlideDataset(n_cases=1).packer
    return create_aggregator("longnetvit_gene_adapter", device="cpu", cfg=cfg,
                             n_gene_groups=packer.n_groups,
                             max_group_len=packer.max_group_len), cfg


def _port_trainer(jax_run, out_dir, n_cases=8, **train_kw):
    model, cfg = _port_model()
    datasets, _ = _splits(SyntheticSlideDataset, n_cases)
    trainer = ModalTuneTrainer(
        model, TrainConfig(**{**TRAIN, **train_kw}), datasets, str(out_dir),
        buckets=(96,), model_cfg=cfg,
        projector=projector_from_jax(jax_run["proj"]))
    return trainer, params_from_jax(jax_run["params"], model)


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_run")
    trainer, params = _port_trainer(jax_run, out)
    calls = _record_eval(trainer)
    best = trainer.run(params)
    deploy = trainer.deploy()
    return dict(out=out, best=best, calls=calls, deploy=deploy,
                trainer=trainer, params=params)


def test_port_trainer_matches_jax_trainer(jax_run, port_run):
    jrows, prows = _rows(jax_run["out"]), _rows(port_run["out"])
    jtrain = [r for r in jrows if "train_loss" in r]
    ptrain = [r for r in prows if "train_loss" in r]
    assert [r["epoch"] for r in ptrain] == [r["epoch"] for r in jtrain] == \
        [0, 1, 2]
    np.testing.assert_allclose([r["train_loss"] for r in ptrain],
                               [r["train_loss"] for r in jtrain],
                               rtol=LOSS_TOL)
    for jr, pr in zip(jtrain, ptrain):
        for k in ("val_cls_acc", "val_cls_bal_acc"):
            assert pr[k] == jr[k], (jr["epoch"], k)
        for k in ("val_cls_auc", "val_c_index"):
            assert abs(pr[k] - jr[k]) <= READOUT_TOL, \
                (jr["epoch"], k, pr[k], jr[k])
        np.testing.assert_allclose(pr["val_cls_loss"], jr["val_cls_loss"],
                                   rtol=LOSS_TOL)
    # the last epoch's val task-0 embeddings (the calls: val per epoch,
    # then test)
    assert [c[0] for c in port_run["calls"]] == \
        [c[0] for c in jax_run["calls"]] == ["val"] * 3 + ["test"]
    (_, jx, jmeta, _), (_, px, pmeta, _) = (jax_run["calls"][2],
                                            port_run["calls"][2])
    assert [m["case_id"] for m in pmeta] == [m["case_id"] for m in jmeta]
    rel = np.linalg.norm(px - jx) / np.linalg.norm(jx)
    assert rel <= EMB_REL_L2, rel
    assert port_run["best"] == jax_run["best"]
    assert (port_run["out"] / "best_model_weights.pt").exists()
    for name in ("config.json", "summary.json", "confusion_val.json",
                 "roc_val.json", "confusion_test.json", "roc_test.json"):
        assert (port_run["out"] / name).exists(), name


def _deploy_results_agree(got, want):
    assert got.keys() == want.keys() == {"General", "Diagnosis", "Survival"}
    for task in want:
        assert got[task].keys() == want[task].keys()
        for k, v in want[task].items():
            if k == "c_index":
                assert abs(got[task][k] - v) <= READOUT_TOL, (task, k)
            else:
                assert got[task][k] == v, (task, k)


def test_jax_checkpoint_deploys_through_the_port(jax_run, port_run,
                                                 tmp_path):
    trainer, params = _port_trainer(jax_run, tmp_path / "deploy")
    trainer.init_state(params)
    results = trainer.deploy(str(jax_run["out"] / "best_model_weights.npz"))
    for split in SPLITS:
        want = np.load(jax_run["out"] / "data" / f"x_feats_{split}.npy")
        got = np.load(tmp_path / "deploy" / "data" / f"x_feats_{split}.npy")
        assert got.shape == want.shape == (8, 3, 256)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert json.load(open(tmp_path / "deploy" / "data" /
                              f"meta_{split}.json")) == json.load(
            open(jax_run["out"] / "data" / f"meta_{split}.json"))
    _deploy_results_agree(results, jax_run["deploy"])
    _deploy_results_agree(json.load(open(tmp_path / "deploy" /
                                         "deploy_results.json")),
                          jax_run["deploy"])
    # the port's own best weights deploy to the port run's deploy
    _deploy_results_agree(port_run["deploy"], jax_run["deploy"])


def test_strict_load_refuses_a_mismatch(jax_run, tmp_path):
    trainer, params = _port_trainer(jax_run, tmp_path, n_cases=3)
    trainer.init_state(params)
    trainer.save_weights("w.pt")
    trainer.load_weights(str(tmp_path / "w.pt"))
    sd = torch.load(tmp_path / "w.pt", weights_only=True)
    name = "interactions.0.injector.gamma"
    cases = {"missing": {k: v for k, v in sd.items() if k != name},
             "unexpected": dict(sd, extra=torch.zeros(1)),
             "shape": dict(sd, **{name: torch.zeros(3)})}
    for what, bad in cases.items():
        torch.save(bad, tmp_path / f"{what}.pt")
        with pytest.raises(ValueError, match="do not match the model"):
            trainer.load_weights(str(tmp_path / f"{what}.pt"))
    # a JAX checkpoint of another model: the clinical variant
    model, _ = _port_model(tiny_test_config(clinical=True))
    init_weights(model, torch.Generator().manual_seed(0))
    datasets, _ = _splits(SyntheticSlideDataset, 3)
    other = ModalTuneTrainer(model, TrainConfig(**TRAIN), datasets,
                             str(tmp_path / "clinical"), buckets=(96,))
    other.init_state(model.state_dict())
    with pytest.raises(ValueError, match="do not match the model"):
        other.load_weights(str(jax_run["out"] / "best_model_weights.npz"))


def test_checkpoint_restores_bit_equal(jax_run, tmp_path):
    trainer, params = _port_trainer(jax_run, tmp_path, n_cases=3)
    trainer.init_state(params)
    trainer.train_one_epoch()
    trainer.best_metric = 0.25
    trainer.save_checkpoint("ckpt", resume_epoch=1)
    second, params2 = _port_trainer(jax_run, tmp_path / "second", n_cases=3)
    second.init_state(params2)
    second.out_dir = trainer.out_dir
    assert second.restore_checkpoint("ckpt")
    assert (second.current_epoch, second.best_metric) == (1, 0.25)
    assert (second.optimizer.updates, second.optimizer.micro_steps) == \
        (trainer.optimizer.updates, trainer.optimizer.micro_steps) == (3, 3)
    want = dict(trainer.model.named_parameters())
    for n, p in second.model.named_parameters():
        assert torch.equal(p, want[n]), n
    sw = trainer.optimizer.adamw.state_dict()
    sg = second.optimizer.adamw.state_dict()
    assert sw["param_groups"] == sg["param_groups"]
    assert sw["state"].keys() == sg["state"].keys()
    for i, st in sw["state"].items():
        for k, v in st.items():
            assert torch.equal(sg["state"][i][k], v), (i, k)
    assert not second.restore_checkpoint("absent")


def test_run_resumes_at_the_saved_epoch(jax_run, tmp_path, capsys):
    first, params = _port_trainer(jax_run, tmp_path, n_cases=3,
                                  num_epochs=1, save_interval=1)
    first.run(params)
    second, params = _port_trainer(jax_run, tmp_path, n_cases=3,
                                   num_epochs=2, save_interval=1)
    second.run(params)
    assert "Resumed from checkpoint at epoch 1" in capsys.readouterr().out
    epochs = [r["epoch"] for r in _rows(tmp_path) if "epoch" in r]
    assert epochs == [0, 1]
    assert second.optimizer.updates == 6


def test_run_kfold(jax_run, tmp_path):
    model, cfg = _port_model()
    datasets, _ = _splits(SyntheticSlideDataset, n_cases=6)
    folds = kfold_splits(datasets["train"], 2, seed=0)
    p0 = params_from_jax(jax_run["params"], model)

    def make_trainer(k):
        tr, va = folds[k]
        return ModalTuneTrainer(
            model, TrainConfig(**{**TRAIN, "num_epochs": 1}),
            dict(datasets, train=tr, val=va), str(tmp_path / f"fold_{k}"),
            buckets=(96,), model_cfg=cfg,
            projector=projector_from_jax(jax_run["proj"]))

    metrics = run_kfold(make_trainer, lambda k: p0, n_folds=2)
    assert len(metrics) == 2 and all(-1.0 <= m <= 1.0 for m in metrics)
    for k in range(2):
        rows = _rows(tmp_path / f"fold_{k}")
        assert [r["epoch"] for r in rows if "epoch" in r] == [0]
        assert any("test_cls_bal_acc" in r for r in rows)


def test_fused_attention_off_matches_default_route(jax_run):
    default, cfg = _port_model()
    plain_cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, fused_attention=False))
    per_branch, _ = _port_model(plain_cfg)
    assert not per_branch.backbone.encoder.layers[0].self_attn.cfg \
        .fused_attention
    p0 = params_from_jax(jax_run["params"], default)
    default.load_state_dict(p0)
    per_branch.load_state_dict(p0)
    datasets, _ = _splits(SyntheticSlideDataset, n_cases=3)
    tcfg = TrainConfig()
    for batch in BucketedLoader(datasets["val"], buckets=(96,),
                                shuffle=False, prefetch=0):
        inputs = batch_to_device(batch, "cpu")
        want = make_embed_step(default, tcfg)(inputs)
        got = make_embed_step(per_branch, tcfg)(inputs)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)


def _cli(*flags, env=None):
    return subprocess.run(
        [sys.executable, "-m", "modaltune_tpu_torch.tools.train", *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_cli_trains_evaluates_and_deploys_the_reference_files(tmp_path):
    db = tmp_path / "db"
    splits = _write_reference_artifacts(db, np.random.RandomState(0))
    data = ["--train_json", splits["train"], "--val_json", splits["val"],
            "--test_json", splits["test"],
            "--genomics_csv_path",
            str(db / "tcga_brca_xena_clean_pathway.csv"),
            "--pathway_csv", str(db / "gene_pathway_processed.csv"),
            "--text_location", str(db / "BRCA_textembeddings_conch.pt"),
            "--clinical_location", str(db / "simple_clinical_dict_brca.pt")]
    out = tmp_path / "results"
    done = _cli("--tiny", "1", "--device", "cpu", "--num_epochs", "2",
                "--mil_name", "longnetvit_gene_clinical_adapter",
                "--save_embeddings", "--output_path", str(out), *data)
    assert done.returncode == 0, done.stderr[-3000:]
    run = out / "seed_0"
    rows = _rows(run)
    assert all(np.isfinite(r["train_loss"]) for r in rows
               if "train_loss" in r)
    assert sum("val_cls_bal_acc" in r for r in rows) == 2
    assert any("test_cls_bal_acc" in r for r in rows)
    deploy = json.load(open(run / "deploy_results.json"))
    assert set(deploy) == {"General", "Diagnosis", "Survival"}
    x_test = np.load(run / "data" / "x_feats_test.npy")
    assert x_test.shape == (6, 3, 256) and np.isfinite(x_test).all()
    # the two-slide case is one case
    assert len(json.load(open(run / "data" / "meta_train.json"))) == 8

    # eval-only: the model is rebuilt from the config.json beside the
    # weights (the clinical variant, its bucket), not from the flags; in a
    # process like the first, so the bf16 CPU kernels round alike
    done = _cli("--tiny", "1", "--device", "cpu", "--eval_only", "1",
                "--eval_weights", str(run / "best_model_weights.pt"),
                "--buckets", "4095", "--output_path", str(tmp_path / "eval"),
                *data)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "model config reloaded" in done.stdout
    got = np.load(tmp_path / "eval" / "seed_0" / "data" /
                  "x_feats_test.npy")
    np.testing.assert_allclose(got, x_test, atol=1e-6, rtol=1e-6)
    assert json.load(open(tmp_path / "eval" / "seed_0" /
                          "deploy_results.json")) == deploy


def test_cli_refuses_without_a_gpu_and_unported_paths(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = _cli("--tiny", "1", "--synthetic", "1", "--output_path",
                str(tmp_path), env=env)
    assert done.returncode != 0
    assert "--device cpu" in done.stderr
    assert not (tmp_path / "seed_0").exists()
    # the multi-process flags are accepted (their runs:
    # test_torch_multihost.py), and a trainer over a 2-process shard
    # builds: rank 0 of two, iterating half of the cases
    parse = cli.build_parser().parse_args
    for flags in (["--distributed", "1"], ["--dp", "2"]):
        assert cli.check_supported(parse(["--device", "cpu", *flags])) == \
            torch.device("cpu")
    assert cli.data_parallel_size(parse(["--device", "cpu", "--dp", "2"]),
                                  torch.device("cpu")) == 2
    datasets, _ = _splits(SyntheticSlideDataset, 4)
    trainer = ModalTuneTrainer(_port_model()[0], TrainConfig(), datasets,
                               str(tmp_path / "shard"), buckets=(96,),
                               process_shard=(0, 2))
    assert trainer.is_main and len(trainer.train_loader) == 2


def test_backbone_weights_set_the_backbone_strictly(jax_run, tmp_path):
    """``--backbone_weights``: a JAX-layout ``.npz`` of the backbone alone
    or of a whole model sets every backbone tensor and nothing else; a
    file with a key missing or one too many is refused."""
    from modaltune_tpu.utils.params_io import save_params_npz
    model, _ = _port_model()
    want = params_from_jax(jax_run["params"], model)
    plain = cli.initial_params(model, cli.build_parser().parse_args(
        ["--seed", "3"]))
    backbone = jax_run["params"]["backbone"]
    save_params_npz(str(tmp_path / "backbone.npz"), backbone)
    save_params_npz(str(tmp_path / "model.npz"), jax_run["params"])
    for name in ("backbone.npz", "model.npz"):
        got = cli.initial_params(model, cli.build_parser().parse_args(
            ["--seed", "3", "--backbone_weights", str(tmp_path / name)]))
        assert got.keys() == want.keys()
        for k, v in got.items():
            ref = want[k] if k.startswith("backbone.") else plain[k]
            assert torch.equal(v, ref), (name, k)
    extra = dict(backbone, stray={"kernel": np.zeros((2, 2), np.float32)})
    missing = {k: v for k, v in backbone.items() if k != "cls_token"}
    for name, tree in (("extra.npz", extra), ("missing.npz", missing)):
        save_params_npz(str(tmp_path / name), tree)
        with pytest.raises(KeyError):
            cli.initial_params(model, cli.build_parser().parse_args(
                ["--backbone_weights", str(tmp_path / name)]))
