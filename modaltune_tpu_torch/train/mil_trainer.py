"""Supervised trainer for the ABMIL / TransMIL baselines.

Counterpart of ``modaltune_tpu/train/mil_trainer.py``: the genomics
baseline's epoch loop (``train/gene_trainer.py``) with the bag and its
mask (and the genes for the "(cat)" fusion variants) as the model's
inputs, over the same bucketed, masked batches the adapter models train
on. On a CUDA device the train loader copies each batch to the card ahead
of its step.
"""

from __future__ import annotations

from ..data.datasets import Batch
from .gene_trainer import GeneBaselineTrainer


class MilBaselineTrainer(GeneBaselineTrainer):
    """Epoch loop + best-val selection for AbmilModel / TransMilModel in
    classifier or survival mode."""

    device_prefetch = True

    def _model_inputs(self, batch: Batch) -> tuple:
        ins = (self._put(batch.bag), self._put(batch.mask))
        if getattr(self.model, "use_genes", False):
            ins = ins + (self._put(batch.genes),)
        return ins
