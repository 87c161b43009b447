"""Nested parameter dicts <-> flat ``"a/b/c" -> array`` dicts, and the
``.npz`` files the JAX package writes its parameters to: the port's copy of
``flatten_params``, ``unflatten_params``, ``save_params_npz`` and
``load_params_npz`` of the JAX package's ``utils/params_io.py``.

npz cannot store bfloat16 (it pickles to object arrays); bf16 leaves are
saved as float32 with a dtype manifest. numpy has no bfloat16 without
``ml_dtypes``, which the port does not need: :func:`load_params_npz` returns
those leaves as the float32 values they were saved as, which hold every
bf16 value exactly."""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

_DTYPE_KEY = "__dtypes__"


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


def save_params_npz(path: str, tree: dict) -> None:
    flat = flatten_params(tree)
    dtypes = {}
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if v.dtype.name not in ("float64", "float32", "float16", "int32",
                                "int64", "bool", "uint32", "uint8"):
            dtypes[k] = v.dtype.name
            v = v.astype(np.float32)
        out[k] = v
    out[_DTYPE_KEY] = np.frombuffer(
        json.dumps(dtypes).encode(), dtype=np.uint8)
    np.savez(path, **out)


def load_params_npz(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files
                                 if k != _DTYPE_KEY})
