"""Supervised trainer for the genomics-only baseline.

Counterpart of ``modaltune_tpu/train/gene_trainer.py``: cross-entropy
(classifier) or the discrete-time survival NLL (survival) over the packed
pathway blocks, with the epoch loop and best-model selection of
``utils/base_trainer.py``: val balanced accuracy or c-index picks
``best_model_weights.pt`` (the model's ``state_dict``), which is reloaded
for the test split. It runs on the device of the model's parameters; the
dropout bits come from a generator on that device seeded ``cfg.seed``.
The optimizer is ``train.state.TrainOptimizer`` (AdamW, warmup then
cosine) over ``len(loader)`` steps an epoch, on every parameter.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..configs import TrainConfig
from ..data.datasets import Batch, BucketedLoader, device_put
from ..eval.readout import classification_metrics, concordance_index
from ..models.layers import dropout_generator
from ..utils.logging import MetricsLogger
from .losses import cross_entropy_loss, survival_nll_loss
from .state import TrainOptimizer

BEST = "best_model_weights.pt"


def duration_bins(durations: np.ndarray, events: np.ndarray,
                  n_bins: int) -> np.ndarray:
    """Quantile bin edges over *uncensored* train durations (the
    standard discretization for the cumprod-hazard survival head).
    Returns the interior edges (n_bins - 1,)."""
    obs = durations[events.astype(bool)]
    if obs.size == 0:
        obs = durations
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(obs, qs)


def to_bins(durations: np.ndarray, edges: np.ndarray) -> np.ndarray:
    return np.searchsorted(edges, durations, side="left").astype(np.int32)


class GeneBaselineTrainer:
    """Epoch loop + best-val selection for a supervised baseline model.

    Generic over the model's inputs through ``_model_inputs``: the
    genomics baseline feeds the packed gene blocks;
    :class:`~.mil_trainer.MilBaselineTrainer` feeds the bag and its mask
    (and the genes for "(cat)")."""

    # whether the train loader copies each batch to a CUDA device ahead of
    # its step (the bag is of no use to the gene model)
    device_prefetch = False

    def __init__(self, model: nn.Module, cfg: TrainConfig, datasets: Dict,
                 out_dir: str, batch_size: int = 8, buckets=None):
        assert model.mode in ("classifier", "survival"), model.mode
        self.model = model
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.datasets = datasets
        self.out_dir = Path(out_dir)
        self.logger = MetricsLogger(str(self.out_dir))
        loader_kw = {} if buckets is None else {"buckets": buckets}
        self.loaders = {
            k: BucketedLoader(datasets[k], batch_size=batch_size,
                              shuffle=(k == "train"), seed=cfg.seed,
                              device_prefetch=(k == "train" and
                                               self.device_prefetch and
                                               self.device.type == "cuda"),
                              **loader_kw)
            for k in ("train", "val", "test") if k in datasets}
        self.best_metric = float("-inf")
        self.optimizer: Optional[TrainOptimizer] = None
        self._edges: Optional[np.ndarray] = None
        if model.mode == "survival":
            meta = datasets["train"].metadata()
            t = np.array([m["durations"] for m in meta], float)
            e = np.array([m["vital_status"] for m in meta], int)
            self._edges = duration_bins(t, e, model.n_classes)
        # host clock of every train step, ms (it ends when the loss
        # reaches the host, after the update)
        self.step_ms = []

    # ------------------------------------------------------------------
    def _put(self, a) -> Optional[torch.Tensor]:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, non_blocking=True)
        return device_put(a, self.device)

    def _targets(self, batch: Batch):
        if self.model.mode == "classifier":
            return self._put(batch.label), None
        return (self._put(to_bins(batch.duration, self._edges)),
                self._put(batch.event))

    def _model_inputs(self, batch: Batch) -> tuple:
        """Positional device inputs of the model; a subclass overrides it
        for models that take more than the gene blocks."""
        return (self._put(batch.genes),)

    def _loss(self, out, y, events) -> torch.Tensor:
        if self.model.mode == "classifier":
            return cross_entropy_loss(out, y)
        hazards, s, _ = out
        return survival_nll_loss(hazards, s, y, events)

    def init_state(self, params: Dict[str, torch.Tensor]) -> TrainOptimizer:
        """Load ``params`` (a full ``state_dict``) and build the optimizer
        over every parameter, and the dropout generator."""
        self.model.load_state_dict(params)
        self.optimizer = TrainOptimizer(
            self.cfg, self.model.parameters(),
            steps_per_epoch=max(1, len(self.loaders["train"])))
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        return self.optimizer

    def train_step(self, inputs: tuple, y: torch.Tensor,
                   events: Optional[torch.Tensor]) -> torch.Tensor:
        """One step in training mode (dropout on) -> the loss, detached."""
        self.model.train()
        with dropout_generator(self._gen):
            loss = self._loss(self.model(*inputs), y, events)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # ------------------------------------------------------------------
    def train_one_epoch(self) -> float:
        total, n = 0.0, 0
        batches = iter(self.loaders["train"])
        try:
            for batch in batches:
                t0 = time.perf_counter()
                y, events = self._targets(batch)
                loss = self.train_step(self._model_inputs(batch), y, events)
                total += float(loss)
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                n += 1
        finally:
            batches.close()
        return total / max(n, 1)

    @torch.no_grad()
    def evaluate(self, stage: str) -> Dict[str, float]:
        self.model.eval()
        ys, preds, probs, risks, ts, es = [], [], [], [], [], []
        for batch in self.loaders[stage]:
            out = self.model(*self._model_inputs(batch))
            if self.model.mode == "classifier":
                logits = out.float()
                preds.append(logits.argmax(-1).cpu().numpy())
                probs.append(torch.softmax(logits, -1).cpu().numpy())
                ys.append(batch.label)
            else:
                _, s, _ = out
                # risk = -sum(S): lower expected survival = higher risk
                risks.append(-s.float().sum(-1).cpu().numpy())
                ts.append(batch.duration)
                es.append(batch.event)
        if self.model.mode == "classifier":
            y = np.concatenate(ys)
            p = np.concatenate(preds)
            pr = np.concatenate(probs)
            keep = y >= 0
            m = classification_metrics(y[keep], p[keep], y_probs=pr[keep])
            m.pop("confusion_matrix", None)
            m.pop("roc_curve", None)
            return {f"{stage}_{k}": v for k, v in m.items()}
        c = concordance_index(np.concatenate(ts), np.concatenate(risks),
                              np.concatenate(es))
        return {f"{stage}_c_index": float(c)}

    # ------------------------------------------------------------------
    def run(self, params: Dict[str, torch.Tensor]) -> float:
        self.init_state(params)
        key = "val_bal_acc" if self.model.mode == "classifier" \
            else "val_c_index"
        best = self.out_dir / BEST
        for epoch in range(self.cfg.num_epochs):
            t0 = time.time()
            train_loss = self.train_one_epoch()
            row = {"epoch": epoch, "train_loss": train_loss,
                   "epoch_sec": round(time.time() - t0, 1)}
            if "val" in self.loaders and \
                    epoch % self.cfg.eval_interval == 0:
                row.update(self.evaluate("val"))
                if row.get(key, -1.0) > self.best_metric:
                    self.best_metric = row[key]
                    torch.save(self.model.state_dict(), best)
            self.logger.log(row, step=epoch)
        if best.exists():
            self.model.load_state_dict(
                torch.load(best, map_location=self.device, weights_only=True))
        if "test" in self.loaders:
            self.logger.log(self.evaluate("test"),
                            step=self.cfg.num_epochs)
        self.logger.dump_summary()
        return self.best_metric
