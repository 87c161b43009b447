"""Aggregator registry: the reference's public model names -> model class.

Counterpart of ``modaltune_tpu/models/registry.py``: the ModalTune models
and the supervised baselines (``gene_mixer_group``, ``abmil``,
``transmil``).
"""

from __future__ import annotations

import torch

from .gene import GeneOnlyModel
from .mil import AbmilModel, TransMilModel
from .modaltune import ModalTuneModel
from .titan import TitanModalTuneModel

AGGREGATORS = {
    "longnetvit_gene_adapter": ModalTuneModel,
    "longnetvit_gene_clinical_adapter": ModalTuneModel,
    "titan_gene_adapter": TitanModalTuneModel,
    "titan_gene_clinical_adapter": TitanModalTuneModel,
    "gene_mixer_group": GeneOnlyModel,
    "abmil": AbmilModel,
    "transmil": TransMilModel,
}


def create_aggregator(name: str, device=None, **kwargs):
    """Build the model ``name`` with its parameters on ``device``:
    ``None`` is the current CUDA device (an error where there is none),
    ``"cpu"`` the host, as the tests ask. The parameters are
    uninitialised until ``init_weights(model, g)`` draws them, from a CPU
    generator whatever the device."""
    if name not in AGGREGATORS:
        raise ValueError(f"Unknown aggregator '{name}'. Available: "
                         f"{sorted(AGGREGATORS)}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_aggregator builds on the GPU unless "
                               "given device='cpu', and no CUDA device is "
                               "available")
        device = "cuda"
    with torch.device(device):
        return AGGREGATORS[name](**kwargs)
