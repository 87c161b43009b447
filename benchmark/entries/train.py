"""Entry ``train``: the fine-tune job as the trainer runs it.

Set-up builds one ``ModalTuneTrainer`` from the benchmark's weights and
drives it from the seed: its first steps one at a time, each through
``train_one_epoch`` (loader -> ``batch_to_device`` -> ``project_text`` ->
the train step), on rows that all differ, reading after each what the
check needs; then on through the same pass until every bucket of the
cohort has run once. The cases are handed to the loader so that its first
epoch opens with one case of each bucket (:func:`dataset_order`): the
checked steps cover every bucket. The same trainer then runs the window:
whole epochs, ``train_one_epoch`` after ``train_one_epoch``, until
``--seconds`` have passed at an epoch's end, so every epoch of every seed
does the same work.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np
from torch.profiler import record_function

from ..harness import compare
from ..harness.trace import Profiled
from ..reference import steps as reference
from . import port

# steps the reference follows: one of each of the cell's four buckets
CHECKED_STEPS = 4


@dataclasses.dataclass
class Step:
    case_id: str
    bucket: int
    length: int
    traced: bool = False


def visit_order(cases, buckets) -> list:
    """The order in which the loader's first epoch should take the cases:
    the first case of each bucket, then the rest, each in the cohort's
    order."""
    lead, rest, seen = [], [], set()
    for k in cases:
        b = reference.bucket_of(k.length, buckets)
        (rest if b in seen else lead).append(k)
        seen.add(b)
    return lead + rest


def dataset_order(cases, buckets, loader_seed: int) -> list:
    """The cases placed so that the loader's first epoch takes them in
    :func:`visit_order`. ``BucketedLoader`` visits ``arange(n)`` shuffled by
    ``RandomState(seed + epoch)``, its first epoch being 1. Should the
    loader draw otherwise, the reference still follows the steps that ran
    (set-up logs them); only the buckets they cover change."""
    slots = np.arange(len(cases))
    np.random.RandomState(loader_seed + 1).shuffle(slots)
    out = [None] * len(cases)
    for slot, k in zip(slots, visit_order(cases, buckets)):
        out[slot] = k
    return out


class Feed:
    """Stands in for the trainer's train loader and logs each batch it
    hands out, each wait for one in a profiler range (``bench.data.next``,
    so a traced idle gap there is named). With ``quota`` set (set-up), every ``iter`` continues one
    pass of the loader and ends once ``quota()`` says so; otherwise every
    ``iter`` is a whole new pass, as the loader's own."""

    def __init__(self, loader, lengths: dict):
        self.loader, self.lengths = loader, lengths
        self.log: List[Step] = []
        self.quota = None
        self.traced = False
        self._pass = None

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self.quota is None:
            it = iter(self.loader)
        else:
            self._pass = self._pass or iter(self.loader)
            it = self._pass
        try:
            while self.quota is None or not self.quota():
                with record_function("bench.data.next"):
                    batch = next(it, None)
                if batch is None:
                    return
                cid = batch.case_ids[0]
                self.log.append(Step(cid, batch.bag.shape[1],
                                     self.lengths[cid], self.traced))
                yield batch
        finally:
            if self.quota is None:
                it.close()

    def end_pass(self):
        if self._pass is not None:
            self._pass.close()
        self._pass, self.quota = None, None


class Entry:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        import torch
        from modaltune_tpu_torch import ModalTuneTrainer
        from modaltune_tpu_torch.configs import TrainConfig
        c = self.ctx
        model, pcfg = port.build_model(c.config, c.device)
        tcfg = TrainConfig(**c.config["train"], seed=c.seeds.train)
        self.out_dir = tempfile.mkdtemp(prefix="bench-train-")
        weights = c.weights()
        trainer = ModalTuneTrainer(
            model, tcfg, {"train": port.CohortDataset(dataset_order(
                c.cases, c.workload["buckets"], tcfg.seed))},
            self.out_dir, buckets=c.workload["buckets"], batch_size=1,
            model_cfg=pcfg, device=c.device,
            projector=port.build_projector(weights["projector"], c.device))
        trainer.init_state(weights["model"],
                           frozen_dtype=port.frozen_dtype(c.config))
        del weights
        self.steps_per_epoch = len(trainer.train_loader)
        feed = Feed(trainer.train_loader,
                    {k.case_id: k.length for k in c.cases})
        trainer.train_loader = feed
        self.trainer, self.feed = trainer, feed

        params = {n: p for n, p in trainer.model.named_parameters()
                  if p.requires_grad}
        start = {n: p.detach().clone() for n, p in params.items()}
        losses, grad, first = [], None, None
        for k in range(CHECKED_STEPS):
            feed.quota = lambda n=len(feed.log): len(feed.log) > n
            losses.append(trainer.train_one_epoch())
            if k == 0:
                # AdamW's first moment after one step is (1 - beta1) g; a
                # leaf the optimizer never got reads 0. Kept on the host.
                state = trainer.optimizer.adamw.state
                first = {n: (state[p]["exp_avg"] / (1.0 - tcfg.beta1)).cpu()
                         if "exp_avg" in state.get(p, {})
                         else torch.zeros(p.shape) for n, p in params.items()}
                grad = {n: float(g.norm()) for n, g in first.items()}
        change = {n: float((p.detach() - start[n]).norm())
                  for n, p in params.items()}
        del start
        self.readings = dict(loss=losses, grad=grad, change=change,
                             first=first)
        self.checked = [s.case_id for s in feed.log]
        if len(set(self.checked)) != CHECKED_STEPS:
            raise RuntimeError(f"the checked steps ran cases {self.checked}")
        buckets = {reference.bucket_of(k.length, c.workload["buckets"])
                   for k in c.cases}
        feed.quota = lambda: buckets <= {s.bucket for s in feed.log}
        trainer.train_one_epoch()
        feed.end_pass()
        self.setup_steps = len(feed.log)

    def window(self, seconds: float, trace: bool) -> dict:
        import torch
        t, feed = self.trainer, self.feed
        feed.log = []
        n0 = len(t.loader_ms)
        prof: Optional[Profiled] = None
        passes: List[float] = []
        while True:
            # the window is the epochs' own time: not the profiler's stop
            if trace and len(passes) == 1:
                feed.traced = True
                with Profiled() as prof:
                    t.train_one_epoch()
                feed.traced = False
                passes.append(prof.window_s)
            else:
                t0 = time.perf_counter()
                t.train_one_epoch()
                if self.ctx.device.type == "cuda":
                    torch.cuda.synchronize(self.ctx.device)
                passes.append(time.perf_counter() - t0)
            if sum(passes) >= seconds and (not trace or prof is not None):
                break
        return dict(seconds=sum(passes), steps=feed.log, pass_s=passes,
                    traced_pass=1 if trace else None,
                    loader_ms=t.loader_ms[n0:],
                    trace=None if prof is None else prof.trace)

    @staticmethod
    def end_to_end(record: dict) -> dict:
        return {"train_slides_per_s": len(record["steps"])
                / record["seconds"]}

    def release(self):
        self.trainer = self.feed = None
        gc.collect()
        shutil.rmtree(self.out_dir, ignore_errors=True)

    def check(self, precision: str = "fp32", fault: str = "") -> dict:
        """The reference's readings of the checked steps (in ``precision``,
        with ``fault`` planted), the program's against them -> (checks,
        how many are over their limits)."""
        c = self.ctx
        ref = reference_readings(c, self.checked, self.steps_per_epoch,
                                 precision, fault)
        values = compare.train(self.readings, ref)
        self.values = values
        checks = compare.held(values, c.workload["limits"])
        return checks, sum(v > lim for v, lim in checks.values())


def reference_readings(c, case_ids, steps_per_epoch, precision="fp32",
                       fault=""):
    model, proj, rt = reference.build(
        c.config["reference"], c.config, c.config["genes"], c.weights(),
        c.device, precision)
    by_id = {k.case_id: k for k in c.cases}
    rows = [reference.rows_of(by_id[i], c.config, c.workload["buckets"],
                              c.device, fault) for i in case_ids]
    return reference.train_readings(
        model, proj, rt, rows, [by_id[i].text for i in case_ids],
        c.config["train"], c.seeds.train, steps_per_epoch)
