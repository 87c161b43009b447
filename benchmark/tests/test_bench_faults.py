"""``correct`` comes out false for each fault a cell can have, planted
under a run that skips only the look for a chip; and the control, the
reference in fp8 in the program's place, reads over the limits.

The faults: a step that leaves the weights as they were; half of each
bag left out (its valid tiles after the first half masked), the mean
taken over the rest. (The cell runs on one chip: there is no exchange
between chips to leave out.)"""

import time

import pytest
import torch

from modaltune_tpu_torch.train import state, trainer
from benchmark.entries import train
from benchmark.harness import cell, compare
from benchmark.harness.cell import Context
from benchmark.harness.inputs import Seeds
from benchmark.harness.manifest import Manifest
from benchmark.traffic import cohort

SEED = 987654321012


def _run(root, name):
    return cell.run(root, name, SEED, 0.2, False, torch.device("cpu"),
                    time.perf_counter(), log=print)


def _half_bag(to_device):
    def put(batch, device=None):
        out = to_device(batch, device)
        m = out["mask"].clone()
        n = int(m[0].sum())
        m[:, (n + 1) // 2:] = False
        out["mask"] = m
        return out
    return put


def test_unchanged_state_fails(tiny_root, monkeypatch):
    def no_update(self):
        self.micro_steps += 1
        self.adamw.zero_grad(set_to_none=True)
        return False
    monkeypatch.setattr(state.TrainOptimizer, "step", no_update)
    r = _run(tiny_root, "tiny-gigapath-train")
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_bag_fails_train(tiny_root, monkeypatch):
    monkeypatch.setattr(trainer, "batch_to_device",
                        _half_bag(trainer.batch_to_device))
    assert not _run(tiny_root, "tiny-gigapath-train")["correct"]


def _ctx(root, name):
    m = Manifest.load(root)
    c = m.cell(name)
    cfg, wl = m.config(c), m.workload(c)
    seeds = Seeds.of(SEED, wl["trainer_seed"])
    return Context(m, c, cfg, wl, seeds, torch.device("cpu"),
                   cohort.make_cohort(wl, cfg, seeds.data))


def test_control_fails_train(tiny_root):
    ctx = _ctx(tiny_root, "tiny-gigapath-train")
    ids = [k.case_id for k in ctx.cases[:train.CHECKED_STEPS]]
    ref = train.reference_readings(ctx, ids, len(ctx.cases))
    ctl = train.reference_readings(ctx, ids, len(ctx.cases), "fp8")
    checks = compare.held(compare.train(ctl, ref), ctx.workload["limits"])
    assert any(v > lim for v, lim in checks.values()), checks
