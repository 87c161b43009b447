"""Carry the JAX package's model parameters into the port.

``params_from_jax(tree, model)`` takes the parameter tree of
``modaltune_tpu.models.ModalTuneModel``, ``TitanModalTuneModel`` or one of
the baselines (``GeneOnlyModel``, ``AbmilModel``, ``TransMilModel``;
nested dicts of numpy arrays, as ``jax.device_get(params)`` gives them) and
returns a ``state_dict`` for the port's model of the same name, so that
the two compute the same function. The names line up by rule:

* ``backbone/encoder/span_k/<leaf>`` holds the layers of span k stacked on
  a leading axis; the spans tile the encoder in order, so span k's layer
  j is ``backbone.encoder.layers.{offset_k + j}``;
* ``interactions_i``, ``extra_extractor_j``, ``prompt_sa_i`` and
  ``mix{i}_<part>`` become ``interactions.i``, ``extra_extractors.j``,
  ``prompt_sa.{i-1}`` and ``mix.i.<part>``;
* the TITAN backbone's ``blocks_N``, ``mlp_fc{1,2}`` and
  ``patch_embed_fc{1,2}`` become ``blocks.N``, ``mlp.fc{1,2}`` and
  ``patch_embed.fc{1,2}``, the original checkpoint's names (no span
  stacking there);
* a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), a Conv
  ``kernel`` (kh, kw, in / groups, out) becomes ``weight`` (out,
  in / groups, kh, kw) (TransMIL's PPEG; a plain ``.T`` would swap kh and
  kw), a LayerNorm ``scale`` becomes ``weight``; raw parameters (the gene
  mixer's ``snn1_kernel``, ``mix0_token/w1``, ``compress_kernel``, the
  heads' ``classifier_kernel``, TransMIL's ``res_conv``, ...) are carried
  as they are.

It raises on a JAX key that maps to no port parameter, on a port
parameter that no JAX key sets, and on a shape that differs; with
``subtree="backbone"`` it converts the backbone alone (the CLI's
``--backbone_weights``). ``port_names`` is the renaming alone.

``projector_from_jax(tree)`` does the same for the frozen random text
projector of the KD loss (``modaltune_tpu.train.TextProjector``), so that
both packages distil towards the same targets.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .params_io import flatten_params

_INDEXED = re.compile(r"(interactions|extra_extractor|prompt_sa)_(\d+)$")
_MIXER = re.compile(r"mix(\d+)_(token_norm|token|chan_norm|chan)$")
_SPAN = re.compile(r"span_(\d+)$")
_TITAN_BLOCK = re.compile(r"blocks_(\d+)$")
_TITAN_FC = re.compile(r"(mlp|patch_embed)_(fc\d)$")


def _port_parts(parts):
    out = []
    for p in parts:
        m = _INDEXED.match(p)
        mm = _MIXER.match(p)
        tb, tf = _TITAN_BLOCK.match(p), _TITAN_FC.match(p)
        if tb:
            out += ["blocks", tb.group(1)]
        elif tf:
            out += [tf.group(1), tf.group(2)]
        elif m:
            name, i = m.group(1), int(m.group(2))
            out += {"interactions": ["interactions", str(i)],
                    "extra_extractor": ["extra_extractors", str(i)],
                    "prompt_sa": ["prompt_sa", str(i - 1)]}[name]
        elif mm:
            out += ["mix", mm.group(1), mm.group(2)]
        else:
            out.append(p)
    return out


def _leaf(parts, arr: np.ndarray):
    """Rename a leaf the JAX way -> the torch way, transposing kernels."""
    if parts[-1] == "kernel" and np.ndim(arr) == 4:     # Conv, HWIO
        return parts[:-1] + ["weight"], np.transpose(arr, (3, 2, 0, 1))
    if parts[-1] == "kernel":
        return parts[:-1] + ["weight"], arr.T
    if parts[-1] == "scale":
        return parts[:-1] + ["weight"], arr
    return parts, arr


def port_names(tree: dict) -> Dict[str, np.ndarray]:
    """JAX parameter tree -> ``{port parameter name: array}`` by
    the rules above, unchecked against any model."""
    flat = flatten_params(tree)
    spans = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[:2] == ["backbone", "encoder"] and _SPAN.match(parts[2]):
            spans[int(_SPAN.match(parts[2]).group(1))] = arr.shape[0]
    offsets, n = {}, 0
    for k in sorted(spans):
        offsets[k], n = n, n + spans[k]

    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[:2] == ["backbone", "encoder"] and _SPAN.match(parts[2]):
            off = offsets[int(_SPAN.match(parts[2]).group(1))]
            for j in range(arr.shape[0]):
                name, val = _leaf(["backbone", "encoder", "layers",
                                   str(off + j)] + _port_parts(parts[3:]),
                                  arr[j])
                out[".".join(name)] = val
        else:
            name, val = _leaf(_port_parts(parts), arr)
            out[".".join(name)] = val
    return out


def params_from_jax(tree: dict, model: nn.Module,
                    subtree: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> the port model's ``state_dict``.

    With ``subtree`` (``"backbone"``), ``tree`` holds that one top-level
    key and the result sets exactly the model's parameters under it."""
    out = port_names(tree)
    want = model.state_dict()
    if subtree is not None:
        want = {k: v for k, v in want.items()
                if k.split(".")[0] == subtree}
    unused = sorted(set(out) - set(want))
    unset = sorted(set(want) - set(out))
    if unused or unset:
        raise KeyError(f"JAX keys with no port parameter: {unused}; "
                       f"port parameters no JAX key sets: {unset}")
    sd = {}
    for name, val in out.items():
        if tuple(val.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: JAX shape {tuple(val.shape)} != port "
                             f"shape {tuple(want[name].shape)}")
        sd[name] = torch.tensor(np.asarray(val, np.float32))
    return sd


def projector_from_jax(tree: dict):
    """JAX ``TextProjector`` parameters -> the port's frozen
    :class:`~modaltune_tpu_torch.train.TextProjector` holding them."""
    from ..train.losses import TextProjector
    in_dim, out_dim = np.asarray(tree["conv1"]["kernel"]).shape
    projector = TextProjector(in_dim, out_dim)
    projector.load_state_dict(params_from_jax(tree, projector))
    return projector.requires_grad_(False).eval()
