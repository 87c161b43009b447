"""What the benchmark makes from ``--seed`` and hands to both sides: the
seeds of each part, and the weights."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Seeds:
    data: int       # the cohort
    weights: int    # the model's and the text projector's weights
    train: int      # the trainer's: epoch order and dropout bits

    @classmethod
    def of(cls, seed: int, train: int) -> "Seeds":
        """31-bit seeds of the data and the weights from any whole number,
        however large; the trainer's seed is the workload's, the same for
        every run, so that every run trains in the same order."""
        if seed < 0:
            raise ValueError("--seed must not be negative")
        words = np.random.SeedSequence(seed).generate_state(2)
        return cls(*(int(w) & 0x7FFFFFFF for w in words), train)


def make_weights(spec: dict, seed: int, device, frozen_dtype=None) -> dict:
    """``{"model": {name: tensor}, "projector": {...}}`` from one normal
    draw on ``device``, each tensor N(mean, std) of its spec entry. The
    frozen backbone's weights are rounded to ``frozen_dtype``, the type
    they are served in, when one is given."""
    total = sum(int(np.prod(s)) for part in spec.values()
                for _, s, _, _ in part)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for part, entries in spec.items():
        out[part] = {}
        for name, shape, mean, std in entries:
            n = int(np.prod(shape))
            t = z[off:off + n].view(shape) * std + mean
            off += n
            if frozen_dtype is not None and part == "model" and \
                    name.startswith("backbone."):
                t = t.to(frozen_dtype)
            out[part][name] = t
    return out
