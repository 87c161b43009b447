"""Pan-cancer trainer: joint multi-task training over 4 cancer sites.

Counterpart of ``modaltune_tpu/train/pancancer_trainer.py``, on the port's
:class:`~.trainer.ModalTuneTrainer`: the same KD objective over the merged
pan-cancer split, but evaluation fits **per-site** LogReg + CoxPH heads
indexed by ``SITE_LABEL[project_id]`` plus a 4-way cancer-site classifier
(``train_modaltune_pancancer.py``: ``train_one_epoch`` :50-134,
``LogisticRegression_train`` :136-232, ``evaluate`` :234-365). Unlike the
single-site trainer, a pan-cancer epoch has **no** 6-iteration cap, even
with ``reference_quirks`` (the optimizer's schedule still counts 6 steps
an epoch there, as the JAX trainer's does). Under a mesh or multi-process
DDP the base trainer's eval contract holds: the padded wrap rows stay out
of the loss and of every site's pool, and every process scores the whole
split; rank 0 writes the files.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ..eval.pancancer import perform_testing_pancancer
from ..eval.readout import (CoxPH, classification_metrics, filter_labelset,
                            fit_logreg)
from ..utils.constants import NUM_SITES, SITE_LABEL
from .trainer import ModalTuneTrainer


def site_of(meta: dict) -> int:
    return SITE_LABEL.get(str(meta.get("project_id", "")), -1)


def _meta_arrays(meta):
    """-> (site, primary_class, durations, vital_status) arrays."""
    sites = np.array([site_of(m) for m in meta])
    y = np.array([m.get("primary_class", -1) for m in meta], int)
    t = np.array([m.get("durations", np.nan) for m in meta], float)
    e = np.array([m.get("vital_status", 0) for m in meta], int)
    return sites, y, t, e


class PanCancerTrainer(ModalTuneTrainer):
    """Per-site readout heads + site classifier on top of the shared
    multi-task KD training loop."""

    def __init__(self, *args, num_sites: int = NUM_SITES, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_sites = num_sites
        self._site_lr: List = [None] * num_sites
        self._site_cph: List = [None] * num_sites
        self._site_classifier = None

    def _epoch_cap(self) -> float:
        # pan-cancer has no iteration cap (train_modaltune_pancancer.py:50)
        return self.cfg.steps_per_epoch_cap or np.inf

    def fit_readout_heads(self):
        """Per-site LogReg/CoxPH on train task-0 embeddings + the 4-way
        site classifier (``LogisticRegression_train``)."""
        x, meta = self.extract_embeddings(self.eval_loaders["train"])
        x0 = x[:, 0]
        sites, y, t, e = _meta_arrays(meta)
        for s in range(self.num_sites):
            sel = sites == s
            if sel.sum() == 0:
                continue
            if len(np.unique(y[sel][y[sel] >= 0])) > 1:
                self._site_lr[s] = fit_logreg(x0[sel], y[sel])
            if np.isfinite(t[sel]).sum() > 5 and e[sel].sum() > 1:
                self._site_cph[s] = CoxPH(penalizer=0.1).fit(
                    x0[sel], t[sel], e[sel])
        valid = sites >= 0
        if len(np.unique(sites[valid])) > 1:
            self._site_classifier = fit_logreg(x0[valid], sites[valid])

    def evaluate(self, stage: str) -> Dict[str, float]:
        x0, meta, mean_loss = self._eval_outputs(stage)
        sites, y, t, e = _meta_arrays(meta)
        out = {f"{stage}_cls_loss": mean_loss}
        bal_accs, cidx = [], []
        for s in range(self.num_sites):
            sel = sites == s
            if sel.sum() == 0:
                continue
            if self._site_lr[s] is not None:
                xf, yf = filter_labelset(x0[sel], y[sel])
                if len(yf):
                    m = classification_metrics(yf,
                                               self._site_lr[s].predict(xf))
                    out[f"{stage}_site{s}_bal_acc"] = m["bal_acc"]
                    bal_accs.append(m["bal_acc"])
            if self._site_cph[s] is not None:
                c = self._site_cph[s].score(x0[sel], t[sel], e[sel])
                out[f"{stage}_site{s}_c_index"] = c
                cidx.append(c)
        if bal_accs:
            # the site-averaged key metric (compute_metrics averages over
            # sites, train_modaltune_pancancer.py:428-445)
            out[f"{stage}_cls_bal_acc"] = float(np.mean(bal_accs))
        if cidx:
            out[f"{stage}_c_index"] = float(np.mean(cidx))
        if self._site_classifier is not None:
            valid = sites >= 0
            m = classification_metrics(
                sites[valid], self._site_classifier.predict(x0[valid]))
            out[f"{stage}_cancer_site_acc"] = m["acc"]
        return out

    def deploy(self, weights_path: Optional[str] = None,
               penalizer: float = 0.1) -> Dict:
        """Pan-cancer deployment readout (``deploy_mil`` ->
        ``perform_testing_pancancer``), written to
        ``deploy_results_pancancer.json``."""
        if weights_path:
            self.load_weights(weights_path)
        splits = {name: self.extract_embeddings(self.eval_loaders[name])
                  for name in ("train", "test")}
        results = perform_testing_pancancer(
            splits["train"][0], splits["train"][1],
            splits["test"][0], splits["test"][1], penalizer=penalizer)
        if self.is_main:
            with open(self.out_dir / "deploy_results_pancancer.json",
                      "w") as f:
                json.dump(results, f, indent=2)
        return results
