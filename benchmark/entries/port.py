"""The port's side of a cell: the model, the dataset of the cohort's cases
and the precision, built through the port's public entry points."""

from __future__ import annotations

import dataclasses
from typing import List

from ..traffic.cohort import Case


def frozen_dtype(config: dict):
    import torch
    return {"bf16": torch.bfloat16, "fp32": None}[config["precision"]]


def build_model(config: dict, device):
    """The configuration's model on ``device``, its parameters unset. Its
    LongNet encoder, where it has one, must be the configuration file's."""
    from modaltune_tpu_torch import create_aggregator
    from modaltune_tpu_torch.configs import model_config_from_dict
    cfg = model_config_from_dict(config["model"])
    if "longnet" in config:
        built = dataclasses.asdict(cfg.backbone.longnet())
        for k, v in config["longnet"].items():
            got = list(built[k]) if isinstance(built[k], tuple) else built[k]
            if got != v:
                raise ValueError(f"the port's LongNet {k} is {got}, the "
                                 f"configuration file's {v}")
    genes = config["genes"]
    model = create_aggregator(config["aggregator"], device=device, cfg=cfg,
                              n_gene_groups=genes["n_pathways"],
                              max_group_len=genes["max_pathway"])
    return model, cfg


def build_projector(weights: dict, device):
    from modaltune_tpu_torch import TextProjector
    import torch
    with torch.device(device):
        proj = TextProjector()
    proj.load_state_dict(weights)
    return proj.requires_grad_(False)


class CohortDataset:
    """The cohort as the dataset interface the port's loader reads
    (``len``, ``get``, ``metadata``, ``case_ids``)."""

    def __init__(self, cases: List[Case]):
        from modaltune_tpu_torch.data.datasets import Example
        self._examples = [Example(
            bag=c.bag, coords=c.coords, genes=c.genes, text=c.text,
            clinical=None, label=c.label, duration=c.duration, event=c.event,
            case_id=c.case_id) for c in cases]
        self.case_ids = [c.case_id for c in cases]

    def __len__(self):
        return len(self._examples)

    def metadata(self):
        return [dict(case_id=e.case_id, primary_class=e.label,
                     durations=e.duration, vital_status=e.event)
                for e in self._examples]

    def get(self, index, rng):
        return self._examples[index]
