"""Experiment lifecycle: the ModalTune trainer.

Counterpart of ``modaltune_tpu/train/trainer.py``, method for method:
seeding, run directory, config dump, epoch loop with the epoch-cap quirk,
in-loop LogReg/CoxPH readout on val, best weights on val balanced
accuracy, test with the best weights, full-state checkpoint and resume,
embedding export and deploy, k-fold; on one GPU, or on several, one
process each (``parallel/``):

* ``mesh`` (``--dp N``): every rank draws the same global batch
  (``pad_to_batch``) and the steps split its rows over the mesh's ``data``
  axis (``parallel.mesh.make_dp_train_step``; eval and embed gather the
  rows back), so every rank holds every output;
* ``process_shard=(rank, n)`` (``--distributed 1``): each process iterates
  its case-modulo shard, the gradients are averaged across processes
  (``parallel.multihost.DdpGradSync``) over the common step count, and
  the eval outputs are gathered back into the dataset's case order.

Rank 0 alone writes the run's files (``is_main``). The best weights that
the test and deploy load are rank 0's, sent to every rank (the JAX
trainer reloads them from each process's own directory, ROADMAP F2).

What differs from the JAX trainer by design:

* weights are the model's ``state_dict`` written with ``torch.save``
  (``best_model_weights.pt``); :meth:`ModalTuneTrainer.load_weights` also
  reads a JAX-written ``best_model_weights.npz``;
* a checkpoint is one ``torch.save`` file (orbax in JAX): the trainable
  tensors, AdamW's state, the optimizer's micro-step and update counts,
  the epoch to resume from and the best metric;
* the frozen random text projector is drawn by torch (seed
  ``cfg.seed + 12345``) unless one is given, e.g. the JAX package's
  through ``utils.convert.projector_from_jax``;
* the dropout bits come from a generator on the device seeded
  ``cfg.seed``, drawn from at every step.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..configs import ModalTuneConfig, TrainConfig
from ..data.datasets import Batch, BucketedLoader
from ..eval.readout import (CoxPH, classification_metrics, filter_labelset,
                            fit_logreg, perform_testing)
from ..models.layers import init_weights
from ..utils.convert import port_names
from ..utils.logging import MetricsLogger, dump_config
from ..utils.params_io import load_params_npz
from ..utils.tracing import span
from .losses import TextProjector, project_text
from .state import FROZEN_KEY, TrainOptimizer, freeze_backbone
from .train_step import (batch_to_device, make_embed_step, make_eval_step,
                         make_grad_step, make_train_step)


def set_seed(seed: int) -> np.random.RandomState:
    np.random.seed(seed)
    return np.random.RandomState(seed)


def check_weights(cur: Dict[str, tuple], new: Dict[str, tuple],
                  path: str) -> None:
    """The strict-load guard (``train_modaltune.py:546-548``): raises
    ``ValueError`` when the names or shapes of ``new`` differ from the
    model's ``cur`` (name -> shape)."""
    missing = sorted(set(cur) - set(new))
    unexpected = sorted(set(new) - set(cur))
    bad_shape = sorted(k for k in set(cur) & set(new) if cur[k] != new[k])
    if missing or unexpected or bad_shape:
        raise ValueError(
            f"weights at {path} do not match the model: "
            f"missing={missing[:5]} unexpected={unexpected[:5]} "
            f"shape-mismatch={bad_shape[:5]} "
            f"({len(missing)}/{len(unexpected)}/{len(bad_shape)} total)")


class _NullLogger:
    """The metrics logger of a rank that writes no files."""

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        pass

    def dump_summary(self) -> None:
        pass


class ModalTuneTrainer:
    """Single-site multi-task KD trainer.

    Args:
      model: a ModalTuneModel or TitanModalTuneModel of the port.
      cfg: TrainConfig.
      datasets: dict with 'train'/'val'/'test' FeatureBagDataset-likes.
      out_dir: run directory (config dump, metrics, weights, checkpoint).
      buckets: bag-length buckets for static-shape batching.
      model_cfg: the model's configuration, written to ``config.json``.
      device: where the model runs; None is the device of its parameters
        (``create_aggregator`` builds on the card unless asked for the
        CPU). On a CUDA device the train loader copies each batch to the
        device ahead of its step.
      projector: the frozen text projector; None draws one from torch.
      mesh: a ``parallel.mesh.make_mesh`` mesh over this run's processes
        (data parallelism over its ``data`` axis), or None.
      process_shard: ``(rank, n_processes)`` of a multi-process DDP run, or
        None.
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig, datasets: Dict,
                 out_dir: str, buckets: Sequence[int] = (4095, 8191,
                                                         16383, 25599),
                 batch_size: int = 1,
                 model_cfg: Optional[ModalTuneConfig] = None,
                 device=None, projector: Optional[nn.Module] = None,
                 mesh=None, process_shard=None):
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device
        self.model = model.to(self.device)
        self.cfg = cfg
        self.datasets = datasets
        self.out_dir = Path(out_dir)
        self.buckets = tuple(buckets)
        self.batch_size = batch_size
        self.mesh = mesh
        self.process_shard = process_shard
        self.rng = set_seed(cfg.seed)
        # processes of this run and this one's rank: only rank 0 writes
        # files (the reference's rank-0 guard, base_trainer.py:438-440)
        ddp = process_shard is not None and process_shard[1] > 1
        self.world = dist.get_world_size() if dist.is_initialized() and (
            ddp or mesh is not None) else 1
        self.rank = dist.get_rank() if self.world > 1 else 0
        self.is_main = self.rank == 0 and (process_shard is None
                                           or process_shard[0] == 0)
        self.logger = MetricsLogger(str(self.out_dir)) if self.is_main \
            else _NullLogger()
        if self.is_main:
            dump_config(str(self.out_dir), {
                "train": dataclasses.asdict(cfg),
                "model": dataclasses.asdict(model_cfg) if model_cfg else {},
                "buckets": list(buckets),
            })
        # under a mesh the steps split each global batch's rows, so every
        # rank draws the same batches, padded to batch_size by wrapping
        self.train_loader = BucketedLoader(
            datasets["train"], buckets=self.buckets, batch_size=batch_size,
            shuffle=True, seed=cfg.seed,
            device_prefetch=self.device.type == "cuda" and mesh is None,
            process_shard=process_shard, pad_to_batch=mesh is not None)
        self.eval_loaders = {
            k: BucketedLoader(datasets[k], buckets=self.buckets,
                              batch_size=batch_size, shuffle=False,
                              seed=cfg.seed, process_shard=process_shard,
                              pad_to_batch=mesh is not None)
            for k in ("train", "val", "test") if k in datasets}

        # frozen random text projector (train_modaltune.py:113-116)
        if projector is None:
            projector = init_weights(
                TextProjector(), torch.Generator().manual_seed(cfg.seed
                                                               + 12345))
        self.projector = projector.to(self.device).requires_grad_(False)

        self.optimizer: Optional[TrainOptimizer] = None
        self.current_epoch = 0
        self.best_metric = float("-inf")
        self._lr_head = None
        self._cph = None
        self._steps_cap = None
        # host clock of every train step of this trainer, ms: each step (it
        # ends when its loss reaches the host, which waits for the update)
        # and each wait in the train loader's next() before it
        self.step_ms: List[float] = []
        self.loader_ms: List[float] = []

    # ------------------------------------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor],
                   frozen_dtype: Optional[torch.dtype] = None
                   ) -> TrainOptimizer:
        """Load ``params`` (a full ``state_dict``) into the model, freeze
        the backbone (cast to ``frozen_dtype``: the steps then autocast to
        it) and build the optimizer and the steps."""
        self.model.load_state_dict(params)
        trainable = freeze_backbone(self.model, frozen_dtype)
        steps = max(1, len(self.train_loader))
        if self.cfg.reference_quirks:
            steps = min(steps, 6)
        self.optimizer = TrainOptimizer(self.cfg, trainable, steps)
        frozen_n = sum(p.numel() for p in
                       getattr(self.model, FROZEN_KEY).parameters())
        train_n = sum(p.numel() for p in trainable)
        if self.is_main:
            print(f"Initialized model: trainable={train_n:,} "
                  f"frozen={frozen_n:,}")
        self._steps_cap = None
        self._step_gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        if self.process_shard is not None and self.process_shard[1] > 1:
            # multi-process DDP: the local grad step, then the gradient
            # mean and the same update on every rank (the reference's DDP
            # wrap, base_trainer.py:205-211)
            from ..parallel.multihost import DdpGradSync, global_steps_min
            gstep = make_grad_step(self.model, self.cfg)
            sync = DdpGradSync(self.optimizer, self._trainable())

            def ddp_step(batch, text_targets, generator):
                loss, grads = gstep(batch, text_targets, generator)
                return sync.step(grads, loss)

            self._train_step = ddp_step
            # dropout decorrelated across processes (JAX folds in the pid)
            self._step_gen.manual_seed(int(np.random.SeedSequence(
                [self.cfg.seed, self.process_shard[0]]).generate_state(1)[0]))
            # every process runs the same number of synchronized steps
            self._steps_cap = global_steps_min(len(self.train_loader))
        elif self.mesh is not None:
            from ..parallel.mesh import data_generator, make_dp_train_step
            self._train_step = make_dp_train_step(self.model, self.cfg,
                                                  self.optimizer, self.mesh)
            self._step_gen = data_generator(self.cfg.seed, self.mesh,
                                            self.device)
        else:
            self._train_step = make_train_step(self.model, self.cfg,
                                               self.optimizer)
        self._eval_step = make_eval_step(self.model, self.cfg,
                                         mesh=self.mesh)
        self._embed_step = make_embed_step(self.model, self.cfg,
                                           mesh=self.mesh)
        return self.optimizer

    def _batch(self, batch: Batch) -> dict:
        return batch_to_device(batch, self.device)

    def _text_targets(self, batch: Batch) -> torch.Tensor:
        return project_text(self.projector,
                            torch.from_numpy(batch.text).to(self.device))

    # ------------------------------------------------------------------
    def _epoch_cap(self) -> float:
        """The reference caps single-site epochs at 6 iterations in quirks
        mode (train_modaltune.py:196-197); pan-cancer never does."""
        return 6 if self.cfg.reference_quirks else \
            (self.cfg.steps_per_epoch_cap or np.inf)

    def train_one_epoch(self) -> float:
        total, n = 0.0, 0
        cap = self._epoch_cap()
        if self._steps_cap is not None:
            cap = min(cap, self._steps_cap)
        batches = iter(self.train_loader)
        try:
            while True:
                t0 = time.perf_counter()
                with span("mt.train.next"):
                    batch = next(batches, None)
                t1 = time.perf_counter()
                if batch is None or n >= cap:
                    break
                self.loader_ms.append((t1 - t0) * 1e3)
                with span("mt.train.h2d"):
                    inputs = self._batch(batch)
                with span("mt.train.text"):
                    targets = self._text_targets(batch)
                with span("mt.train.step"):
                    loss = self._train_step(inputs, targets, self._step_gen)
                with span("mt.train.loss_read"):
                    total += float(loss)
                self.step_ms.append((time.perf_counter() - t1) * 1e3)
                n += 1
        finally:
            batches.close()     # a cut epoch stops the prefetch thread now
        return total / max(n, 1)

    def extract_embeddings(self, loader, task0_only: bool = False):
        """-> (embeddings (N, T, D) fp32, metadata rows). The in-loop
        readout uses task-0 embeddings only, like
        ``LogisticRegression_train`` (train_modaltune.py:329-376)."""
        embs, ids = [], []
        by_case = {m["case_id"]: m for m in loader.dataset.metadata()}
        for batch in loader:
            out = self._embed_step(self._batch(batch))
            real = len(batch.case_ids) - batch.pad_rows
            embs.append(out.float().cpu().numpy()[:real])
            ids.extend(batch.case_ids[:real])
        # the empty placeholder carries the real (T, D) trailing shape, which
        # the processes' gather needs when a split has fewer cases than
        # processes
        out_dim = self.model.cfg.adapter.output_dim
        x = np.concatenate(embs) if embs else \
            np.zeros((0, self.cfg.num_tasks, out_dim), np.float32)
        if self.process_shard is not None:
            # every process's shard, back in the dataset's case order, so
            # the head fits and deploy files equal a single-process run's
            from ..parallel.multihost import allgather_embeddings
            x, ids = allgather_embeddings(x, ids)
            x, ids = _case_order(x, ids, loader.dataset)
        meta = [by_case[c] for c in ids]
        if task0_only:
            x = x[:, :1]
        return x, meta

    def fit_readout_heads(self):
        """Fit LogReg + CoxPH on train task-0 embeddings."""
        x, meta = self.extract_embeddings(self.eval_loaders["train"])
        x0 = x[:, 0]
        y = np.array([m.get("primary_class", -1) for m in meta], int)
        self._lr_head = fit_logreg(x0, y)
        t = np.array([m.get("durations", np.nan) for m in meta], float)
        e = np.array([m.get("vital_status", 0) for m in meta], int)
        self._cph = CoxPH(penalizer=0.1).fit(x0, t, e)

    def _gather_eval(self, x0, ids, loss_num: float, loss_den: int,
                     dataset):
        """The whole split's eval outputs under multi-process DDP (the
        reference's rank-0 ``gather_distributed_outputs``,
        base_trainer.py:379-421): every process's embeddings and case ids
        (uneven counts absorbed) in the dataset's case order and the loss
        sums over processes, so every process, and a single-process run on
        the same data, scores the same metrics. Passthrough otherwise."""
        if self.process_shard is None or self.process_shard[1] <= 1:
            return x0, ids, loss_num, loss_den
        from ..parallel.multihost import allgather_embeddings, process_sum
        x0, ids = allgather_embeddings(x0, list(ids))
        sums = process_sum(np.asarray([loss_num, float(loss_den)]))
        x0, ids = _case_order(x0, ids, dataset)
        return x0, ids, float(sums[0]), int(round(float(sums[1])))

    def _eval_outputs(self, stage: str):
        """Run the eval step over a split -> (x0 (N, D) task-0
        embeddings, metadata rows, mean loss), the whole split's under
        multi-process DDP (:meth:`_gather_eval`)."""
        loader = self.eval_loaders[stage]
        by_case = {m["case_id"]: m for m in loader.dataset.metadata()}
        loss_num, loss_den, x0, ids = 0.0, 0, [], []
        for batch in loader:
            real = len(batch.case_ids) - batch.pad_rows
            row_valid = torch.zeros(len(batch.case_ids), device=self.device)
            row_valid[:real] = 1.0
            logits, loss = self._eval_step(self._batch(batch),
                                           self._text_targets(batch),
                                           row_valid)
            # per-batch losses already exclude padded rows; weight by
            # real count so uneven final batches don't skew the mean
            loss_num += float(loss) * real
            loss_den += real
            x0.append(logits[:real, 0].float().cpu().numpy())
            ids.extend(batch.case_ids[:real])
        out_dim = self.model.cfg.adapter.output_dim
        x0 = np.concatenate(x0) if x0 else np.zeros((0, out_dim),
                                                    np.float32)
        x0, ids, loss_num, loss_den = self._gather_eval(
            x0, ids, loss_num, loss_den, loader.dataset)
        meta = [by_case[c] for c in ids]
        return x0, meta, loss_num / max(loss_den, 1)

    def evaluate(self, stage: str) -> Dict[str, float]:
        """Loss + readout metrics on a split (``evaluate``,
        train_modaltune.py:388-458)."""
        x0, meta, mean_loss = self._eval_outputs(stage)
        y = np.array([m.get("primary_class", -1) for m in meta], int)
        t = np.array([m.get("durations", np.nan) for m in meta], float)
        e = np.array([m.get("vital_status", 0) for m in meta], int)

        out = {f"{stage}_cls_loss": mean_loss}
        if self._lr_head is not None:
            xf, yf = filter_labelset(x0, y)
            if len(yf):
                m = classification_metrics(
                    yf, self._lr_head.predict(xf),
                    y_probs=self._lr_head.predict_proba(xf))
                cm = m.pop("confusion_matrix", None)
                roc = m.pop("roc_curve", None)
                out.update({f"{stage}_cls_{k}": v for k, v in m.items()})
                if cm is not None and self.is_main:
                    with open(self.out_dir / f"confusion_{stage}.json",
                              "w") as f:
                        json.dump(cm, f)
                if roc and self.is_main:
                    with open(self.out_dir / f"roc_{stage}.json", "w") as f:
                        json.dump(roc, f)
        if self._cph is not None:
            out[f"{stage}_c_index"] = self._cph.score(x0, t, e)
        return out

    # ------------------------------------------------------------------
    def save_weights(self, name: str) -> None:
        if self.is_main:
            torch.save(self.model.state_dict(), self.out_dir / name)

    def _from_main(self, read):
        """``read()`` on rank 0, sent to every rank of a multi-process run
        (the files are rank 0's: another rank may see no such file, or a
        stale one)."""
        if self.world == 1:
            return read()
        from ..parallel.collectives import broadcast_object
        return broadcast_object(read() if self.rank == 0 else None)

    def load_weights(self, path: str, strict: bool = True) -> None:
        """Load weights written by :meth:`save_weights` (``.pt``) or by the
        JAX trainer (``.npz``, renamed by ``utils.convert``'s rules); with
        ``strict`` their names and shapes must be the model's exactly —
        the deploy-time ``load_state_dict`` strictness
        (``train_modaltune.py:546-548``), guarding against a model built
        from drifted flags. In a multi-process run every rank loads rank
        0's file."""
        def read():
            if str(path).endswith(".npz"):
                return {k: torch.from_numpy(np.asarray(v, np.float32))
                        for k, v in port_names(load_params_npz(path)).items()}
            return torch.load(path, map_location="cpu", weights_only=True)
        new = self._from_main(read)
        if strict:
            check_weights({k: tuple(v.shape) for k, v in
                           self.model.state_dict().items()},
                          {k: tuple(v.shape) for k, v in new.items()}, path)
        self.model.load_state_dict(new, strict=strict)

    def _trainable(self) -> Dict[str, nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def save_checkpoint(self, name: str = "ckpt",
                        resume_epoch: Optional[int] = None) -> None:
        """Full-state checkpoint (trainable tensors + optimizer) for resume,
        ``out_dir/<name>.pt``.

        ``resume_epoch`` records the epoch training should *continue
        from* (run() passes epoch+1 after finishing an epoch)."""
        if not self.is_main:
            return
        opt = self.optimizer
        epoch = self.current_epoch if resume_epoch is None else resume_epoch
        torch.save(dict(trainable={n: p.detach() for n, p in
                                   self._trainable().items()},
                        adamw=opt.adamw.state_dict(),
                        micro_steps=opt.micro_steps, updates=opt.updates,
                        epoch=epoch, best=self.best_metric),
                   self.out_dir / f"{name}.pt")

    def restore_checkpoint(self, name: str = "ckpt") -> bool:
        path = self.out_dir / f"{name}.pt"
        ck = self._from_main(lambda: torch.load(
            path, map_location="cpu", weights_only=True)
            if path.exists() else None)
        if ck is None:
            return False
        params = self._trainable()
        check_weights({n: tuple(p.shape) for n, p in params.items()},
                      {n: tuple(t.shape) for n, t in ck["trainable"].items()},
                      str(path))
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(ck["trainable"][n])
        self.optimizer.adamw.load_state_dict(ck["adamw"])
        self.optimizer.micro_steps = int(ck["micro_steps"])
        self.optimizer.updates = int(ck["updates"])
        self.current_epoch = int(ck["epoch"])
        self.best_metric = float(ck["best"])
        return True

    # ------------------------------------------------------------------
    def run(self, params: Dict[str, torch.Tensor],
            frozen_dtype: Optional[torch.dtype] = None) -> float:
        """Full training run -> best val key metric (balanced accuracy,
        like ``base_trainer.py:423-543``). With ``cfg.save_interval`` set,
        writes a full-state checkpoint every N epochs and auto-resumes
        from it at start."""
        self.init_state(params, frozen_dtype=frozen_dtype)
        if self.cfg.save_interval and self.restore_checkpoint():
            print(f"Resumed from checkpoint at epoch {self.current_epoch} "
                  f"(best={self.best_metric:.4f})")
        for epoch in range(self.current_epoch, self.cfg.num_epochs):
            self.current_epoch = epoch
            t0 = time.time()
            train_loss = self.train_one_epoch()
            row = {"epoch": epoch, "train_loss": train_loss,
                   "epoch_sec": round(time.time() - t0, 1)}
            if epoch % self.cfg.eval_interval == 0 and "val" in \
                    self.eval_loaders:
                self.fit_readout_heads()
                row.update(self.evaluate("val"))
                key = row.get("val_cls_bal_acc", -1.0)
                if key > self.best_metric:
                    self.best_metric = key
                    self.save_weights("best_model_weights.pt")
            self.logger.log(row, step=epoch)
            if self.cfg.save_interval and \
                    (epoch + 1) % self.cfg.save_interval == 0:
                self.save_checkpoint(resume_epoch=epoch + 1)
        # test with best weights (rank 0's, on every rank), heads refit on
        # train
        best = self.out_dir / "best_model_weights.pt"
        if self._from_main(best.exists):
            self.load_weights(str(best))
        if "test" in self.eval_loaders:
            self.fit_readout_heads()
            test_row = self.evaluate("test")
            self.logger.log(test_row, step=self.cfg.num_epochs)
        self.logger.dump_summary()
        return self.best_metric

    def deploy(self, weights_path: Optional[str] = None,
               penalizer: float = 0.1) -> Dict[str, dict]:
        """Embedding export + per-task LogReg/CoxPH readout
        (``deploy_mil``, train_modaltune.py:520-554). Saves embeddings
        and label frames under ``out_dir/data`` like ``get_features``."""
        if weights_path:
            self.load_weights(weights_path)
        data_dir = self.out_dir / "data"
        if self.is_main:
            data_dir.mkdir(parents=True, exist_ok=True)
        splits = {}
        for name in ("train", "val", "test"):
            if name not in self.eval_loaders:
                continue
            # every process holds the whole split; rank 0 writes it
            x, meta = self.extract_embeddings(self.eval_loaders[name])
            splits[name] = (x, meta)
            if self.is_main:
                np.save(data_dir / f"x_feats_{name}.npy", x)
                with open(data_dir / f"meta_{name}.json", "w") as f:
                    json.dump(meta, f, default=str)
        results = perform_testing(splits["train"][0], splits["train"][1],
                                  splits["test"][0], splits["test"][1],
                                  penalizer=penalizer)
        if self.is_main:
            with open(self.out_dir / "deploy_results.json", "w") as f:
                json.dump(results, f, indent=2)
        return results


def _case_order(x: np.ndarray, ids: List[str], dataset):
    """``x`` and ``ids`` in the order of ``dataset.case_ids``."""
    pos = {c: i for i, c in enumerate(dataset.case_ids)}
    perm = np.argsort(np.asarray([pos[c] for c in ids], np.int64),
                      kind="stable")
    return x[perm], [ids[i] for i in perm]


def run_kfold(make_trainer, params_fn, n_folds: int = 5) -> List[float]:
    """K-fold harness (``base_trainer.py:545-571``): caller provides a
    factory producing a trainer per fold and an init-params fn."""
    metrics = []
    for fold in range(n_folds):
        trainer = make_trainer(fold)
        metrics.append(trainer.run(params_fn(fold)))
    return metrics
