"""Nested parameter dicts <-> flat ``"a/b/c" -> array`` dicts: the port's
copy of ``flatten_params`` / ``unflatten_params`` of the JAX package's
``utils/params_io.py``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def flatten_params(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree
