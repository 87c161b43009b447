"""The port's trainer against the JAX package's over a whole warmup ->
cosine schedule, at the loss scale users train at.

Both ``ModalTuneTrainer``s run from the same parameters
(``params_from_jax``) and text projector (``projector_from_jax``) on the
same cohort (``tests/_multiepoch.py``): ``tiny_test_config()`` (no
dropout, so both runs are deterministic), ``batch_size=1`` (F3 makes
``len(loader)`` a lower bound above that), one bucket of 48 with bags of
20-40 patches (the JAX trainer jits one shape per bucket; half the bags of
``test_torch_trainer.py``, to keep the file within 90 s), the Injector
gammas perturbed as in ``test_torch_trainer.py``. The schedule is the
reference's, ``TrainConfig(lr=5e-4, weight_decay=0.01, num_epochs=14,
warmup_epochs=10, warmup_factor=20, temperature=1.0)``, with
``kd_loss_scale`` at its default of 10: Adam's update is normalised there,
not proportional to the gradient as at the 1e-8 of the other trainer
tests, and it runs through ten warmup epochs from lr/20 and four cosine
ones. The cohort is ``SyntheticSlideDataset(learnable=True)`` of each
package from the same seeds: 6 train cases (the reference's epoch cap, so
an epoch is the same six updates on both sides), 12 val and 12 test. Its
text rows are random per case; the KD loss still falls by more than 60 %
in 14 epochs on them, and the best weights of ``default`` move past the
first epoch.

Three cases:

* ``default``: the whole ``run()``, eval every epoch, the test stage with
  the best weights;
* ``grad_accum2``: ``grad_accum=2``, three applied updates an epoch;
  ``init_state``, then ``train_one_epoch`` 14 times, no eval;
* ``quirks8``: ``reference_quirks=True`` on 8 train cases: the epoch stops
  at 6 steps and the schedule counts updates over ``min(len(loader), 6)``,
  JAX's semantics, which the port keeps; driven as ``grad_accum2``.

Tolerances, with their reasons:

* the learning rate of every applied update (the port's
  ``TrainOptimizer.lr()`` before the update and the rate AdamW applied,
  against JAX's schedule at the optax update count): ``LR_TOL`` (1e-6)
  relative, one closed form in fp64 and in fp32;
* each epoch's mean train loss: ``LOSS_TOL`` (5e-3) relative. The two
  fp32 runs start from the KD loss's floor of ~2e-5 (``test_torch_train.
  py``) and drift along 84 normalised Adam steps; ``PARITY.md`` records
  6e-4 between two frameworks on a larger model over this schedule;
* learning: on both sides the last epoch's loss is below ``LEARNS`` (0.8)
  of the first's;
* readout, every epoch and on test: ``*_cls_acc`` and ``*_cls_bal_acc``
  equal, ``*_cls_auc`` and ``*_c_index`` within ``READOUT_TOL`` (1e-3),
  the bars of ``test_torch_trainer.py``; the eval loss at ``LOSS_TOL``;
  the best weights saved at the same epochs, so the same one won;
* the trainable parameters after the last epoch: the rel-L2 of their
  concatenation at most ``PARAM_REL_L2`` (1e-2). The ``NULL_GRAD``
  tensors are left out of it: their gradient is zero in exact arithmetic
  and fp32 noise in each framework, so each of their elements steps +-lr
  at random. Every tensor's rel-L2, theirs too, is printed.

The JAX runs go in processes of their own, started at once, while the
test's process makes the port's runs, one after another on one torch
thread.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _multiepoch import CASES, EPOCHS, port_run, wait_for
from modaltune_tpu_torch.utils.convert import port_names

REPO = Path(__file__).resolve().parent.parent
HELPER = Path(__file__).resolve().parent / "_multiepoch.py"
LR_TOL = 1e-6
LOSS_TOL = 5e-3
READOUT_TOL = 1e-3
PARAM_REL_L2 = 1e-2
LEARNS = 0.8
RUN_TIMEOUT = 600
UPDATES_PER_EPOCH = {"default": 6, "grad_accum2": 3, "quirks8": 6}
# test_torch_train.py's: tensors whose gradient is zero in exact arithmetic
NULL_GRAD = ("k_proj.bias", "token.b2", "compress_bias")


class Runs:
    """The JAX runs, each started at once in a process of its own, and the
    port's, made here on the first call of :meth:`port`."""

    def __init__(self, root: Path):
        self.root = root
        self.init = root / "init.pkl"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO)] + [p for p in [os.environ.get(
                           "PYTHONPATH")] if p]))
        self.procs = {}
        for case in CASES:
            out = root / f"jax_{case}"
            out.mkdir()
            log = open(out / "log.txt", "w")
            self.procs[case] = (out, log, subprocess.Popen(
                [sys.executable, str(HELPER), case, str(self.init), str(out)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        self.ports = None

    def port(self, case: str) -> dict:
        if self.ports is None:
            self.params, self.proj = wait_for(self.init)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)      # beside three JAX processes
            try:
                self.ports = {
                    c: dict(port_run(c, self.params, self.proj,
                                     self.root / f"port_{c}"),
                            out=self.root / f"port_{c}")
                    for c in CASES}
            finally:
                torch.set_num_threads(threads)
        return self.ports[case]

    def jax(self, case: str) -> dict:
        out, log, proc = self.procs[case]
        rc = proc.wait(timeout=RUN_TIMEOUT)
        log.close()
        assert rc == 0, (out / "log.txt").read_text()[-3000:]
        with open(out / "record.pkl", "rb") as f:
            return dict(pickle.load(f), out=out)

    def close(self):
        for _, log, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    runs = Runs(tmp_path_factory.mktemp("multiepoch"))
    yield runs
    runs.close()


def _rows(out_dir):
    return [json.loads(line) for line in open(Path(out_dir) /
                                              "run_metrics.jsonl")]


def _readouts_agree(got: dict, want: dict, stage: str, where):
    for k in (f"{stage}_cls_acc", f"{stage}_cls_bal_acc"):
        assert got[k] == want[k], (where, k, got[k], want[k])
    for k in (f"{stage}_cls_auc", f"{stage}_c_index"):
        assert abs(got[k] - want[k]) <= READOUT_TOL, \
            (where, k, got[k], want[k])
    np.testing.assert_allclose(got[f"{stage}_cls_loss"],
                               want[f"{stage}_cls_loss"], rtol=LOSS_TOL,
                               err_msg=str(where))


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax_over_the_schedule(runs, case):
    port, jax_rec = runs.port(case), runs.jax(case)
    # the port ran with the JAX trainer's own projector
    want = port_names(jax_rec["proj"])
    for k, v in port_names(runs.proj).items():
        assert np.array_equal(v, want[k]), k

    n = EPOCHS * UPDATES_PER_EPOCH[case]
    assert len(jax_rec["lrs"]) == len(port["lrs"]) == n
    for i, (lr, applied) in enumerate(port["lrs"]):
        want = jax_rec["lrs"][i]
        assert abs(lr - want) <= LR_TOL * want, (i, lr, want)
        assert abs(applied - want) <= LR_TOL * want, (i, applied, want)

    if CASES[case]["run"]:
        jrows, prows = _rows(jax_rec["out"]), _rows(port["out"])
        jepochs = [r for r in jrows if "train_loss" in r]
        pepochs = [r for r in prows if "train_loss" in r]
        assert [r["epoch"] for r in pepochs] == \
            [r["epoch"] for r in jepochs] == list(range(EPOCHS))
        jloss = np.array([r["train_loss"] for r in jepochs])
        ploss = np.array([r["train_loss"] for r in pepochs])
    else:
        jloss, ploss = np.array(jax_rec["losses"]), np.array(port["losses"])
    assert len(jloss) == len(ploss) == EPOCHS
    rel = np.abs(ploss - jloss) / jloss
    print(f"{case}: epoch loss JAX {jloss.tolist()}\n"
          f"{case}: epoch loss port {ploss.tolist()}\n"
          f"{case}: relative difference {rel.tolist()}")
    assert rel.max() <= LOSS_TOL, rel
    assert jloss[-1] < LEARNS * jloss[0], jloss
    assert ploss[-1] < LEARNS * ploss[0], ploss

    if CASES[case]["run"]:
        for jr, pr in zip(jepochs, pepochs):
            _readouts_agree(pr, jr, "val", jr["epoch"])
        assert port["best"] == jax_rec["best"] and jax_rec["best"], \
            (port["best"], jax_rec["best"])
        (jtest,), (ptest,) = ([r for r in rows if "test_cls_acc" in r]
                              for rows in (jrows, prows))
        _readouts_agree(ptest, jtest, "test", "test")
        print(f"{case}: best weights saved at epochs {port['best']}; "
              f"test {({k: v for k, v in ptest.items() if k[0] != '_'})}")

    want = port_names(jax_rec["final"])
    got = port["final"]
    dist = {n: float(np.linalg.norm(got[n] - want[n])
                     / np.linalg.norm(want[n])) for n in got}
    held = sorted(n for n in got if not n.endswith(NULL_GRAD))
    total = float(np.linalg.norm(np.concatenate(
        [(got[n] - want[n]).ravel() for n in held])) / np.linalg.norm(
        np.concatenate([want[n].ravel() for n in held])))
    print(f"{case}: trainable parameters, rel-L2 of the {len(held)} held "
          f"tensors {total:.3e}; worst held "
          f"{max((dist[n], n) for n in held)}; NULL_GRAD tensors "
          f"{ {n: round(d, 4) for n, d in dist.items() if n not in held} }")
    assert total <= PARAM_REL_L2, total
