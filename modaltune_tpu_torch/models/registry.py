"""Aggregator registry: the reference's public model names -> model class.

Counterpart of ``modaltune_tpu/models/registry.py`` for the models the
port has so far.
"""

from __future__ import annotations

from .modaltune import ModalTuneModel

AGGREGATORS = {
    "longnetvit_gene_adapter": ModalTuneModel,
    "longnetvit_gene_clinical_adapter": ModalTuneModel,
}


def create_aggregator(name: str, **kwargs):
    if name not in AGGREGATORS:
        raise ValueError(f"Unknown aggregator '{name}'. Available: "
                         f"{sorted(AGGREGATORS)}")
    return AGGREGATORS[name](**kwargs)
