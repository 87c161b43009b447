#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``modaltune_tpu_torch/csrc``, holds
each against its plain PyTorch version at the shapes of the model steps
(the forward kernels K1f, K2f, K3f, K4f, K5f and the statistics of K1f and
K3f; the backward kernels K1b, K2b, K3b, K4b, K5b; K1f and K1b also with a
``q_token_range``, a sequence-parallel shard's rows; K1f, K3f, K1b and K3b
in both of their tensor-core families, bf16 on wgmma and fp32 on 3xTF32,
the forward core and the mix also each alone), times
each beside its plain version and, where one PyTorch call computes the
same function, beside that call (``scaled_dot_product_attention``; timed
here, used nowhere in the port), and computes the least time the card
could take for the same work. Then it drives thirty-one paths end to end at
full published width with random weights from a seeded generator, each with
every launch count set to 0 just before and read just after. Every train
step runs the LongNet layers rematerialized under the configuration's
default policy, ``"flash"`` (``models/longnet.py``): the backward runs
each layer's FFN again (K5f twice a fused-route step) but no attention
kernel. The paths:

* ModalTune-GigaPath (12-layer / 768-d / 16-head LongNet backbone, Modal
  Adapter, gene mixer over 331 pathways, 3 task tokens): the embed step on
  three synthetic 10,239-patch slides, and a few train steps (KD loss,
  AdamW on the adapter, bf16 compute, dropout on) on one;
* the same train step with the frozen backbone in fp32 and no autocast,
  the CLI's ``--bf16 0`` (K1f and K1b on their 3xTF32 family, K2 on the
  CUDA cores), and the same on the fused route (K3f and K3b on 3xTF32, K5
  on its generic fp32 kernels, held to their plain versions), each timed
  beside the bf16 step;
* the same model on its other kernel route (``mega_attention=False``: the
  per-branch attention kernels K3 in place of K1; ``fused_gelu_ln=True``:
  the fused GELU -> LayerNorm K5 in place of two ops), the same two steps
  on the same slides and weights, its embeddings held to the first
  route's;
* the same again on the per-branch route (``fused_attention=False``, the
  CLI's ``--fused_attention 0``: each of a layer's five dilated branches
  on the flash kernels K2f and K2b, their wgmma family at D = 48), its
  embeddings held to the first route's, its gradients to the plain
  path's as every train path's, and each K2 launch of its bf16 grad
  step to the plain version on that launch's inputs;
* ModalTune-TITAN (6-block / 768-d / 12-head ViT with 2-D ALiBi attention
  and a 128-query attentional pooler, the same adapter over
  interactions ((0,1),(2,3),(4,5)) with concatenated tokens): the embed
  step on three synthetic slides grid-scattered into the 16,383-cell
  bucket, and a few train steps on one;
* the port's train CLI (``modaltune_tpu_torch.tools.train.run_one_seed``)
  on ModalTune-GigaPath, on the reference's file formats written at full
  width (``.pt`` and ``.mtbc`` feature bags, split JSONs, text ``.pt``,
  gene and pathway CSVs): two epochs with the in-loop readout, test with
  the best weights, a checkpoint every epoch, deploy;
* the same CLI with ``--pancancer 1 --reference_quirks 1`` on four TCGA
  projects' files at the 2,047 bucket: full epochs, the per-site readout
  and the 4-way site classifier, the pan-cancer deploy;
* data parallelism: ModalTune-GigaPath's ``make_dp_train_step`` on a data
  mesh over a world of one NCCL process, against the single-device step;
* sequence parallelism: a ModalTune-GigaPath grad step at 10,239 on two
  processes that share the card over gloo, each running the backbone on
  its half of the tokens (K1f and K1b with its ``q_token_range``), against
  the single-process step;
* ModalTune-GigaPath with the LoRA encoder variant (``lora_adapter``,
  LoRA B nonzero): the embed step on one slide and a few train steps,
  every branch of every layer on K2's wgmma family, each K2 launch of its
  bf16 grad step held to the plain version;
* dataset preparation: a synthetic TCGA site through
  ``data/pipeline.py`` (labels, splits, clinical features, prompts, text
  embeddings, the gene CSV) and ``data/extract.py`` (tile extraction with
  stand-in encoders on the card), then the train CLI on the files it
  wrote; and a TITAN extraction whose slide encoder is the port's
  TitanViT (K4f);
* the flagship, ModalTune-GigaPath at the reference's own geometry (the
  25,599 bucket that ``--threshold 25000`` fills): the default route's
  train step under remat off, ``"flash"`` and ``"full"`` (one grad step
  of each held bit for bit to remat off), its embed step, the fused
  route's train step with and without remat and its embed step, B = 2
  under ``"flash"``, the train step at 10,239 and 2,047 with remat off
  beside ``"flash"``, and the train CLI at ``--threshold 25000`` with the default
  buckets on bags of 24,000-30,000 tiles;
* the reference's whole training schedule (14 epochs, ten of warmup,
  ``kd_loss_scale`` 10) through ``ModalTuneTrainer.run`` on a learnable
  cohort at the 2,047 bucket, four times from the same weights, data and
  dropout bits: on the kernels and on the plain versions, with a bf16 and
  with an fp32 backbone; the kernel paths' epoch losses and test readouts
  held to the plain fp32 path's.

Then it trains the supervised baselines through the CLI (ABMIL, TransMIL
"(cat)" survival, the gene-only model; they run no kernel of the port, so
they are not a path of the kernels line), holds one batch of each on the
card against the CPU, and times one TransMIL train step of four bags at
the 25,599 bucket. It holds the LoRA encoder's gradients to the plain
path's, the MoE FFN (top-1 and top-2, on the card against the CPU, its
expert-parallel exchange over NCCL and over two gloo ranks), xPos and the
T5 bias, and profiles two train steps with ``utils.profiling.trace``,
holding ``tools/trace_report``'s device total to the profiler's. It holds
K1f and K1b at the flagship's (3, 25600, 16, 48) to their plain versions.

Every phase prints its results on lines of its own; any failure raises
and the script exits non-zero. The last line is one JSON object
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches on those paths, error, time, plain version's time,
bound and library call's time.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _last_line(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()][-1]


@contextlib.contextmanager
def gc_timer():
    """Within the block, the milliseconds Python's garbage collector ran
    (``ms``), its collections and those of generation 2, as a dict that
    grows while the block runs."""
    res = {"ms": 0.0, "collections": 0, "gen2": 0}
    start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
            return
        res["ms"] += (time.perf_counter() - start[0]) * 1e3
        res["collections"] += 1
        res["gen2"] += info["generation"] == 2
    gc.callbacks.append(on_gc)
    try:
        yield res
    finally:
        gc.callbacks.remove(on_gc)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` calls, each timed
    with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 10, warmup: int = 2):
    """Mean device time of one ``fn()`` call: the summed duration of the
    kernels, copies and sets that ``iters`` calls ran on the card, from
    ``torch.profiler``, over ``iters``; ``None`` where the profiler
    recorded no device event (:func:`device_times`). Unlike
    :func:`time_ms` it leaves out the host's time to enqueue them, which a
    call of a few tens of microseconds on the card does not hide."""
    return device_times(fn, iters, warmup)[0]


# device_times calls, and those of them timed by CUDA events because the
# profiler handed back no device event
DEVICE_TIMES = {"calls": 0, "by_events": 0}


def device_times(fn, iters: int = 10, warmup: int = 2):
    """``(ms, {kernel name: ms})``: :func:`device_ms` and its split by the
    name of what ran, each per call. Now and then a profiler run hands
    back no device event at all, at any shape: it is profiled again, up
    to three times, and if none of the three holds a device event the
    ``iters`` calls are timed by CUDA events instead (the host's enqueue
    time included), that time is printed and counted in
    :data:`DEVICE_TIMES`, and the reading is ``(None, None)``: not a card
    time (printed "not measured", null in the kernels line)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    DEVICE_TIMES["calls"] += 1
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if dev:
            break
    else:
        DEVICE_TIMES["by_events"] += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        print(f"device time: the profiler recorded no device event in three "
              f"runs; {iters} calls timed by CUDA events instead, {ms:.4f} "
              f"ms a call (host enqueue included; not a card time)",
              flush=True)
        return None, None
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / iters / 1e3
    return sum(by_name.values()), by_name


def fmt_ms(ms) -> str:
    """``ms`` to four places, or "not measured" for ``None``."""
    return "not measured" if ms is None else f"{ms:.4f}"


def fmt_ratio(a, b) -> str:
    """``a / b`` to three places, or "not measured" where either is
    ``None`` (a card time the profiler did not record)."""
    return "not measured" if a is None or b is None else f"{a / b:.3f}"


def timed_once(fn):
    """``(fn(), milliseconds)`` of one call, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# NVIDIA H100 SXM, dense rates of the data sheet: bf16 tensor cores, TF32
# tensor cores, fp32 outside the tensor cores (elementwise work has no
# other unit), HBM3.
PEAK_FLOPS = 989e12
PEAK_FLOPS_TF32 = 495e12
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS):
    """The least time the card could take: ``(ms, "operations" or
    "bytes")``, the larger of flops over the peak rate for their type (the
    bf16 tensor cores unless given) and bytes (each input read once, each
    output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def attention_bound(pairs: float, d: int, tensors, backward: bool):
    """Bound of an attention kernel over ``pairs`` (query, unmasked key)
    pairs of head dimension ``d``: two products forward (q.k, p.v), five
    backward (q.k, dout.v, dS.k, dS^T.q, P^T.dout), 2 flop per
    multiply-add; ``tensors`` are its inputs and outputs."""
    return bound_ms((10 if backward else 4) * pairs * d, tensor_bytes(tensors))


def tf32x3_bounds(pairs: float, d: int, tensors, backward: bool = True):
    """An fp32 attention's bounds over ``pairs`` at head dimension ``d``
    (backward: five products, forward: two): ``(ms, by)`` of its products
    at fp32 accuracy on the TF32 tensor cores (three TF32 products each,
    3xTF32, at :data:`PEAK_FLOPS_TF32`), and ``(ms, by)`` of them on the
    CUDA cores (:data:`PEAK_FLOPS_FP32`), beside it."""
    flops = (10 if backward else 4) * pairs * d
    nbytes = tensor_bytes(tensors)
    return (bound_ms(3 * flops, nbytes, PEAK_FLOPS_TF32),
            bound_ms(flops, nbytes, PEAK_FLOPS_FP32))


# name -> (module of the wrapper, its launch counter)
COUNTERS = {
    "K1f": ("modaltune_tpu_torch.ops.dilated_mega", "LAUNCHES"),
    "K1b": ("modaltune_tpu_torch.ops.dilated_mega", "BWD_LAUNCHES"),
    "K2f": ("modaltune_tpu_torch.ops.flash_attention", "LAUNCHES"),
    "K2b": ("modaltune_tpu_torch.ops.flash_attention", "BWD_LAUNCHES"),
    "K3f": ("modaltune_tpu_torch.ops.dilated_fused", "LAUNCHES"),
    "K3b": ("modaltune_tpu_torch.ops.dilated_fused", "BWD_LAUNCHES"),
    "K4f": ("modaltune_tpu_torch.ops.alibi_flash", "LAUNCHES"),
    "K4b": ("modaltune_tpu_torch.ops.alibi_flash", "BWD_LAUNCHES"),
    "K5f": ("modaltune_tpu_torch.ops.gelu_ln", "LAUNCHES"),
    "K5b": ("modaltune_tpu_torch.ops.gelu_ln", "BWD_LAUNCHES"),
}


# K5's launches by route and backward variant (``ops/gelu_ln.py``): of the
# K5f and K5b launches, those of the row-resident kernels, and the K5b
# launches without dgamma and dbeta.
K5_ROUTES = ("ROWS_LAUNCHES", "BWD_ROWS_LAUNCHES", "BWD_DX_ONLY_LAUNCHES")


def reset_counts() -> None:
    """Set every kernel's launch count to 0, K5's by route and K2's, K1's
    and K3's by family too."""
    for module, attr in COUNTERS.values():
        setattr(importlib.import_module(module), attr, 0)
    gl = importlib.import_module(COUNTERS["K5f"][0])
    for attr in K5_ROUTES:
        setattr(gl, attr, 0)
    fa = importlib.import_module(COUNTERS["K2f"][0])
    for counts in (fa.FAMILY_LAUNCHES, fa.BWD_FAMILY_LAUNCHES,
                   *dilated_family_counts().values()):
        counts.update(dict.fromkeys(counts, 0))


def dilated_family_counts() -> dict:
    """K1f's, K3f's, K1b's and K3b's launch counts by family
    (``ops/dilated_fused.py``'s FAMILIES), the wrappers' own dicts."""
    return {k: getattr(importlib.import_module(COUNTERS[k][0]),
                       "BWD_FAMILY_LAUNCHES" if k.endswith("b")
                       else "FAMILY_LAUNCHES")
            for k in ("K1f", "K3f", "K1b", "K3b")}


def check_dilated_families(tag: str, launches: dict, dtype) -> dict:
    """On a path's run: every K1f, K3f, K1b and K3b launch took the family
    of the backbone's dtype at D = 48 (``wgmma`` at bf16, ``tf32x3`` at
    fp32), forward and backward. Returns the launches by family."""
    df = importlib.import_module(COUNTERS["K3b"][0])
    want = df.family(48, dtype)
    got = {k: dict(c) for k, c in dilated_family_counts().items()}
    check(all(got[k][want] == launches[k] == sum(got[k].values())
              for k in got),
          f"{tag}: K1 and K3 launches by family {got}, want all "
          f"{ {k: launches[k] for k in got} } on {want}")
    if any(launches[k] for k in got):
        print(f"{tag}: K1f, K3f, K1b and K3b by family {got}: all on "
              f"{want}", flush=True)
    return got


def check_k2_families(tag: str, launches: dict, d48: int,
                      again: int = 0, fp32: bool = False) -> dict:
    """On a path's run: its ``d48`` K2 calls at D = 48 (each launching K2f,
    and K2b where ``launches`` counts one; ``again`` more K2f that the
    backward's recompute runs) all ran the wgmma family, the rest the
    short-side family, and no K2 ran on the CUDA cores; with ``fp32`` (an
    fp32 backbone, no autocast: K2's fp32 family is the CUDA cores) every
    K2 ran on the CUDA cores. Returns the launches by family, forward and
    backward."""
    fa = importlib.import_module(COUNTERS["K2f"][0])
    fwd, bwd = dict(fa.FAMILY_LAUNCHES), dict(fa.BWD_FAMILY_LAUNCHES)
    if fp32:
        check(fwd["cuda_cores"] == launches["K2f"] == sum(fwd.values()) and
              bwd["cuda_cores"] == launches["K2b"] == sum(bwd.values()),
              f"{tag}: K2 launches by family {fwd} forward, {bwd} "
              f"backward; want all on the CUDA cores (fp32)")
        return dict(fwd=fwd, bwd=bwd)
    d48_b = d48 if launches["K2b"] else 0
    d48 += again
    check(fwd["wgmma"] == d48 and bwd["wgmma"] == d48_b and
          fwd["cuda_cores"] == 0 and bwd["cuda_cores"] == 0 and
          sum(fwd.values()) == launches["K2f"] and
          sum(bwd.values()) == launches["K2b"],
          f"{tag}: K2 launches by family {fwd} forward, {bwd} backward; "
          f"want {d48} and {d48_b} on wgmma (D = 48), none on the CUDA "
          f"cores")
    if d48:
        print(f"{tag}: K2f by family {fwd}, K2b {bwd}: every D = 48 call "
              f"on wgmma, none on the CUDA cores", flush=True)
    return dict(fwd=fwd, bwd=bwd)


def check_k5_routes(tag: str, launches: dict, fp32: bool = False) -> None:
    """On a path's run: every K5f and K5b launch took the row-resident
    kernels (with ``fp32``, an fp32 backbone, the generic ones: the
    row-resident kernels are bf16's), and every K5b launch the variant
    without dgamma and dbeta (the train steps freeze the backbone)."""
    gl = importlib.import_module(COUNTERS["K5f"][0])
    rows_f, rows_b, dx_only = (getattr(gl, a) for a in K5_ROUTES)
    want = (0, 0) if fp32 else (launches["K5f"], launches["K5b"])
    check((rows_f, rows_b, dx_only) == (*want, launches["K5b"]),
          f"{tag}: K5 launches {launches['K5f']} forward, {launches['K5b']} "
          f"backward, of which row-resident {rows_f} and {rows_b}, without "
          f"dgamma/dbeta {dx_only}")
    if launches["K5f"]:
        print(f"{tag}: K5f {launches['K5f']} and K5b {launches['K5b']} "
              f"launches, all on the "
              f"{'generic (fp32)' if fp32 else 'row-resident'} kernels; K5b "
              f"without dgamma/dbeta {dx_only}", flush=True)


def read_counts() -> dict:
    return {name: getattr(importlib.import_module(module), attr)
            for name, (module, attr) in COUNTERS.items()}


def k2_branch_calls(model) -> int:
    """K2 calls of one forward of ``model`` at D = 48: on the per-branch
    route (``fused_attention`` off) and in the LoRA attention
    (``lora_adapter``) one per branch of every LongNet layer, else
    none."""
    bb = model.backbone
    if not hasattr(bb, "encoder"):
        return 0
    c = bb.encoder.cfg
    if c.fused_attention and not c.lora_adapter:
        return 0
    return len(bb.encoder.layers) * len(c.segment_lengths)


def calls_per_forward(model) -> dict:
    """Kernel calls of one forward of ``model``: per LongNet layer one K1
    (``mega_attention``) or one K3 or, on the per-branch route, one K2 per
    branch (:func:`k2_branch_calls`), and one K5 where the FFN runs the
    fused GELU -> LayerNorm; K4 once per TITAN block; K2 once per adapter
    attention besides (Injector and Extractor of every interaction, the
    extra extractors, the prompt self-attentions)."""
    bb = model.backbone
    layers = list(bb.encoder.layers) if hasattr(bb, "encoder") else []
    branch = k2_branch_calls(model)
    mega = bool(layers) and bb.encoder.cfg.mega_attention
    return {
        "K1": len(layers) if mega and not branch else 0,
        "K2": (sum(2 + len(blk.extra_extractors)
                   for blk in model.interactions) + len(model.prompt_sa)
               + branch),
        "K3": len(layers) if not mega and not branch else 0,
        "K4": len(bb.blocks) if hasattr(bb, "blocks") else 0,
        "K5": sum(1 for layer in layers if layer.ffn.fused_gelu_ln),
    }


def recomputed_per_step(model) -> dict:
    """Forward kernel calls that a train step's backward runs again, by
    the rematerialization of the LongNet layers (``LongNetConfig.remat``,
    ``models/longnet.py``): under every policy the FFN past fc1 (one K5 a
    layer on the fused route); under ``"full"`` the attention too (K1, K3
    or the per-branch route's K2s). The attention's own forward kernel
    never runs again under ``"flash"`` and ``"flash_ffn"``."""
    bb = model.backbone
    if not hasattr(bb, "encoder") or not bb.encoder.cfg.remat:
        return {}
    per = calls_per_forward(model)
    again = {"K5": per["K5"]}
    if bb.encoder.layers[0].split is None:
        again.update(K1=per["K1"], K3=per["K3"], K2=k2_branch_calls(model))
    return again


# ---------------------------------------------------------------------------
# K2: flash attention with key bias
# ---------------------------------------------------------------------------

# (name, BH, Lq, Lk, D, fraction of keys masked, a bh with every key masked)
# B = 1 slide x 3 tasks x 12 adapter heads at inner width 192 -> D = 16;
# the d48_r* shapes are the five branches of the per-branch dilated
# attention (``--fused_attention 0``) of a GigaPath layer at 10,240 tokens
# (3 task rows x 16 heads, D = 48; segments from
# ``configs.optimal_segment_lengths()`` at ratios 1, 2, 4, 8, 16; the first
# has ten 1,024-token segments a row, its last one all padding at 9,000
# valid tokens); the last two are the TITAN adapter's cross-attentions over
# the 16,383-cell bucket.
BRANCH_SHAPES = [
    ("d48_r1", 480, 1024, 1024, 48, 0.12, True),
    ("d48_r2", 96, 2896, 2896, 48, 0.12, False),
    ("d48_r4", 48, 2560, 2560, 48, 0.12, False),
    ("d48_r8", 48, 1280, 1280, 48, 0.12, False),
    ("d48_r16", 48, 640, 640, 48, 0.12, False),
]
K2_SHAPES = [
    ("injector", 36, 10239, 65, 16, 0.0, False),
    ("extractor", 36, 65, 10239, 16, 1239 / 10239, True),
    ("prompt_sa", 36, 65, 65, 16, 0.0, False),
    *BRANCH_SHAPES,
    ("titan_injector", 36, 16383, 65, 16, 0.0, False),
    ("titan_extractor", 36, 65, 16383, 16, 1800 / 16383, True),
]


def k2_pairs(bh, lq, lk, bias):
    """(query, unmasked key) pairs of a K2 call."""
    if bias is None:
        return float(bh * lq * lk)
    return float(lq * int((bias > -5e8).sum()))


def sdpa_key_bias(q, k, v, bias):
    """The library call beside K2f: one
    ``scaled_dot_product_attention`` with the key bias as its mask. It
    returns ``out`` without the lse."""
    import torch.nn.functional as F
    mask = None if bias is None else bias[None, :, None, :].to(q.dtype)
    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          attn_mask=mask)[0]


def k2_inputs(bh, lq, lk, d, masked, dead, dtype, device, seed):
    import torch
    from modaltune_tpu_torch.ops import NEG_INF
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(bh, n, d, generator=g).to(device, dtype)
               for n in (lq, lk, lk))
    bias = None
    if masked or dead:
        valid = torch.ones(bh, lk, dtype=torch.bool)
        valid[:, lk - int(round(masked * lk)):] = False
        if dead:
            valid[0] = False
        bias = torch.where(valid, 0.0, NEG_INF).to(device)
    return q, k, v, bias


def compare(got, want, tol_rel, what):
    """Check that ``got`` is finite and max |got - want| <= tol_rel *
    max(1, max |want|); returns the max abs error."""
    import torch
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    check(err <= tol_rel * scale,
          f"{what}: max|err| {err:.3e} > {tol_rel:.1e} x {scale:.3g}")
    return err


# Limits of :func:`grad_readings`, (rel-L2, row), by dtype. bf16: the
# result rounded to bf16 alone reads (1.7e-3, 3.9e-3), and the tensor-core
# kernels round P and dS to bf16 besides; fp32: the sums run in another
# order than the plain version's.
GRAD_LIMITS = {"float32": (1e-5, 5e-5), "bfloat16": (1e-2, 2e-2)}
# lse's max|err| for each K2 launch of the per-branch route's grad step
# (:func:`k2_call_readings`): :func:`phase_k2`'s fp32 limit, since the
# kernel and the plain version both compute lse in fp32 from the same bf16
# values
K2_LSE_LIMIT = 1e-4


def grad_readings(got, want, dout):
    """Two readings of a gradient tensor that do not hang on its largest
    element (the cls key's dk and dv are a hundred times a typical one):
    ``rel``, ||got - want|| / ||want||, and ``row``, the largest over rows
    (the last axis) of max|err| / max|want| of that row, a row smaller
    than the tensor's RMS taken against that RMS. A gradient is linear in
    ``dout``: where ``want`` is an exact 0 plus rounding noise (a cls-only
    batch row's dq and dk), the floors 1e-3 ||dout|| and 1e-3 max|dout|
    stand in for the norm and the row scale."""
    import torch
    got, want, dout = got.float(), want.float(), dout.float()
    err = got - want
    rel = err.norm() / torch.maximum(want.norm(), 1e-3 * dout.norm())
    rms = want.pow(2).mean().sqrt()
    scale = want.abs().amax(dim=-1).clamp_min(
        torch.maximum(rms, 1e-3 * dout.abs().max()))
    return rel.item(), (err.abs().amax(dim=-1) / scale).max().item()


def check_grads(names, got, want, dout, dtype_name, what):
    """Hold every gradient to :data:`GRAD_LIMITS`; returns the worst
    (rel, row) of them."""
    rel_lim, row_lim = GRAD_LIMITS[dtype_name]
    worst_rel = worst_row = 0.0
    for gn, gt, wt in zip(names, got, want):
        rel, row = grad_readings(gt, wt, dout)
        check(rel <= rel_lim and row <= row_lim,
              f"{what} {gn}: rel-L2 {rel:.3e} (limit {rel_lim:.0e}), "
              f"row-scaled max|err| {row:.3e} (limit {row_lim:.0e})")
        worst_rel, worst_row = max(worst_rel, rel), max(worst_row, row)
    return worst_rel, worst_row


def check_out(got, want, dtype_name, what):
    """Hold an attention output to :data:`GRAD_LIMITS` by the readings of
    :func:`grad_readings`, which scale the error by the values compared:
    over thousands of keys a typical |out| is about 0.01, where the bound
    of :func:`compare`, scaled by max(1, max|want|), is as large as the
    values themselves. Returns (rel, row)."""
    return check_grads(("out",), (got,), (want,), want, dtype_name, what)


def phase_k2(device, shapes=K2_SHAPES, iters=20):
    """Kernel vs plain version at every shape, fp32 and bf16, the bf16
    output also by :func:`check_out`; times in bf16, where a rerun must
    give the same bits, and in fp32 at :data:`FP32_K2_SHAPES`
    (:func:`k2_fp32_times`). Each shape names the kernel family that ran in
    bf16 (fp32 runs the CUDA-core kernels). Returns {name: result dict}."""
    import torch
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    results = {}
    for i, (name, bh, lq, lk, d, masked, dead) in enumerate(shapes):
        res = {"family": fa.card_family(lq, lk, d, torch.bfloat16)}
        for dtype, out_tol, lse_tol in ((torch.float32, 2e-4, 1e-4),
                                        (torch.bfloat16, 1.6e-2, 1e-2)):
            q, k, v, bias = k2_inputs(bh, lq, lk, d, masked, dead, dtype,
                                      device, seed=100 + i)
            got_o, got_l = fa.flash_attention(q, k, v, bias)
            # the plain version runs in fp32 on the same (rounded) values
            want_o, want_l = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), bias)
            torch.cuda.synchronize()
            tag = f"K2 {name} {str(dtype)[6:]}"
            err_o = compare(got_o, want_o, out_tol, f"{tag} out")
            err_l = (got_l - want_l).abs().max().item()
            check(err_l <= lse_tol, f"{tag} lse: max|err| {err_l:.3e}")
            if dead:
                check(bool((got_o[0] == 0).all()) and
                      bool((got_l[0] == fa.NEG_INF).all()),
                      f"{tag}: a fully masked row is not 0 / NEG_INF")
            res[str(dtype)[6:]] = dict(out_err=err_o, lse_err=err_l)
            if dtype == torch.float32 and name in FP32_K2_SHAPES:
                res["fp32"] = k2_fp32_times(
                    lambda: fa.flash_attention(q, k, v, bias),
                    lambda: fa.flash_attention_reference(q, k, v, bias),
                    lambda: sdpa_key_bias(q, k, v, bias), iters,
                    4 * k2_pairs(bh, lq, lk, bias) * d,
                    (q, k, v, bias, got_o, got_l))
            if dtype == torch.bfloat16:
                res["out_rel"], res["out_row"] = check_out(
                    got_o, want_o, "bfloat16", f"{tag} out")
                again = fa.flash_attention(q, k, v, bias)
                check(torch.equal(again[0], got_o) and
                      torch.equal(again[1], got_l),
                      f"{tag}: a rerun gives other bits")
                res["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, bias),
                                    iters)
                res["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_reference(q, k, v, bias), iters)
                res["library_ms"] = time_ms(
                    lambda: sdpa_key_bias(q, k, v, bias), iters)
                res["device_ms"] = device_ms(
                    lambda: fa.flash_attention(q, k, v, bias))
                res["library_device_ms"] = device_ms(
                    lambda: sdpa_key_bias(q, k, v, bias))
                res["bound_ms"], res["bound_by"] = attention_bound(
                    k2_pairs(bh, lq, lk, bias), d,
                    (q, k, v, bias, got_o, got_l), backward=False)
        print(f"K2 {name} BH={bh} Lq={lq} Lk={lk} D={d}: "
              f"fp32 out {res['float32']['out_err']:.3e} "
              f"lse {res['float32']['lse_err']:.3e} | "
              f"bf16 ({res['family']}) out {res['bfloat16']['out_err']:.3e} "
              f"(rel-L2 {res['out_rel']:.3e}, row-scaled "
              f"{res['out_row']:.3e}) lse {res['bfloat16']['lse_err']:.3e}, "
              f"rerun bit-equal | "
              f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
              f"library (SDPA, no lse) {res['library_ms']:.4f} ms, "
              f"kernel / library {res['ms'] / res['library_ms']:.3f}; on the "
              f"card alone (profiler) kernel {fmt_ms(res['device_ms'])} ms, "
              f"library {fmt_ms(res['library_device_ms'])} ms, kernel / library "
              f"{fmt_ratio(res['device_ms'], res['library_device_ms'])}; bound "
              f"{res['bound_ms']:.5f} ms ({res['bound_by']})", flush=True)
        if "fp32" in res:
            print(fmt_k2_fp32(f"K2 {name} BH={bh} Lq={lq} Lk={lk} D={d}",
                              res["fp32"]), flush=True)
        results[name] = res
    return results


# The shapes of an fp32 backbone's K2 calls that are timed in fp32 (the
# CUDA-core family: the adapter's Injector and Extractor at 10,239)
FP32_K2_SHAPES = ("injector", "extractor")


def k2_fp32_times(kernel, plain, library, iters, flops, tensors):
    """An fp32 K2 call's times: the kernel's, the plain version's and the
    library call's (``library``, at fp32 with TF32 off, as ``main`` sets
    it) on both clocks, and the bound on the CUDA cores (``flops`` at
    :data:`PEAK_FLOPS_FP32`) or by the bytes of ``tensors``."""
    r = dict(family="cuda_cores", ms=time_ms(kernel, iters),
             device_ms=device_ms(kernel, iters=3, warmup=1),
             plain_ms=time_ms(plain, iters),
             library_ms=time_ms(library, iters),
             library_device_ms=device_ms(library, iters=3, warmup=1))
    r["bound_ms"], r["bound_by"] = bound_ms(flops, tensor_bytes(tensors),
                                            PEAK_FLOPS_FP32)
    return r


def fmt_k2_fp32(tag, r) -> str:
    return (f"{tag} fp32 ({r['family']}): kernel {r['ms']:.4f} ms (card "
            f"{fmt_ms(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, library "
            f"(fp32, TF32 off) {r['library_ms']:.4f} ms (card "
            f"{fmt_ms(r['library_device_ms'])}), kernel / library "
            f"{r['ms'] / r['library_ms']:.3f} (card "
            f"{fmt_ratio(r['device_ms'], r['library_device_ms'])}); bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}, fp32 at "
            f"{PEAK_FLOPS_FP32 / 1e12:.0f} TFLOP/s)")


def phase_k2b(device, shapes=K2_SHAPES, iters=20):
    """The K2 backward kernels against their plain version at every shape,
    fp32 and bf16 (the plain version in fp32 on the same values); times in
    bf16, where a rerun must give the same bits and the gradients from the
    kernel's own out and lse are held to the same limits, so that a fault
    of the forward reaches them too, and in fp32 at
    :data:`FP32_K2_SHAPES` (:func:`k2_fp32_times`, the library call
    autograd through SDPA); the bf16 family as in :func:`phase_k2`.
    Returns {name: result dict}."""
    import torch
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    results = {}
    for i, (name, bh, lq, lk, d, masked, dead) in enumerate(shapes):
        res = {"family": fa.card_family(lq, lk, d, torch.bfloat16)}
        scale = d ** -0.5
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            q, k, v, bias = k2_inputs(bh, lq, lk, d, masked, dead, dtype,
                                      device, seed=200 + i)
            g = torch.Generator(device="cpu").manual_seed(300 + i)
            dout = torch.randn(bh, lq, d, generator=g).to(device, dtype)
            out, lse = fa.flash_attention_reference(q, k, v, bias)
            out = out.to(dtype)
            got = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse,
                                                   dout, scale)
            want = fa.flash_attention_backward_reference(
                q.float(), k.float(), v.float(), bias, out.float(), lse,
                dout.float())
            torch.cuda.synchronize()
            tag = f"K2b {name} {str(dtype)[6:]}"
            # (max|err|, its bound tol * max(1, max|want|)) of the worst grad
            res[str(dtype)[6:]], res[str(dtype)[6:] + "_bound"] = max(
                (compare(gt, wt, tol, f"{tag} {gn}"),
                 tol * max(1.0, wt.abs().max().item()))
                for gn, gt, wt in zip(("dq", "dk", "dv"), got, want))
            res[str(dtype)[6:] + "_rel"], res[str(dtype)[6:] + "_row"] = \
                check_grads(("dq", "dk", "dv"), got, want, dout,
                            str(dtype)[6:], tag)
            if dead:
                check(all(bool((gt[0] == 0).all()) for gt in got),
                      f"{tag}: a bh with every key masked has non-zero "
                      f"gradients")
            if dtype == torch.float32 and name in FP32_K2_SHAPES:
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                lib_out = sdpa_key_bias(*leaves, bias)
                res["fp32"] = k2_fp32_times(
                    lambda: fa.flash_attention_backward_cuda(
                        q, k, v, bias, out, lse, dout, scale),
                    lambda: fa.flash_attention_backward_reference(
                        q, k, v, bias, out, lse, dout),
                    lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                retain_graph=True),
                    iters, 10 * k2_pairs(bh, lq, lk, bias) * d,
                    (q, k, v, bias, out, lse, dout, *got))
                del lib_out, leaves
            if dtype == torch.bfloat16:
                again = fa.flash_attention_backward_cuda(q, k, v, bias, out,
                                                         lse, dout, scale)
                check(all(torch.equal(a, b) for a, b in zip(again, got)),
                      f"{tag}: a rerun gives other bits")
                own = fa.flash_attention_backward_cuda(
                    q, k, v, bias, *fa.flash_attention_cuda(q, k, v, bias,
                                                            scale),
                    dout, scale)
                res["own_rel"], res["own_row"] = check_grads(
                    ("dq", "dk", "dv"), own, want, dout, "bfloat16",
                    f"{tag} from the kernel's out and lse")
                res["ms"] = time_ms(lambda: fa.flash_attention_backward_cuda(
                    q, k, v, bias, out, lse, dout, scale), iters)
                res["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_backward_reference(
                        q, k, v, bias, out, lse, dout), iters)
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                lib_out = sdpa_key_bias(*leaves, bias)

                def library():
                    return torch.autograd.grad(lib_out, leaves, dout,
                                               retain_graph=True)
                res["library_ms"] = time_ms(library, iters)
                res["device_ms"] = device_ms(
                    lambda: fa.flash_attention_backward_cuda(
                        q, k, v, bias, out, lse, dout, scale))
                res["library_device_ms"] = device_ms(library)
                del lib_out, leaves
                res["bound_ms"], res["bound_by"] = attention_bound(
                    k2_pairs(bh, lq, lk, bias), d,
                    (q, k, v, bias, out, lse, dout, *got), backward=True)
        print(f"K2b {name} BH={bh} Lq={lq} Lk={lk} D={d}: "
              f"fp32 dq/dk/dv {res['float32']:.3e} (bound "
              f"{res['float32_bound']:.2e}), rel-L2 "
              f"{res['float32_rel']:.3e}, row-scaled {res['float32_row']:.3e} "
              f"| bf16 ({res['family']}) {res['bfloat16']:.3e} (bound "
              f"{res['bfloat16_bound']:.2e}), rel-L2 "
              f"{res['bfloat16_rel']:.3e}, row-scaled "
              f"{res['bfloat16_row']:.3e}, rerun bit-equal, from the "
              f"kernel's own out and lse rel-L2 {res['own_rel']:.3e}, "
              f"row-scaled {res['own_row']:.3e} | "
              f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
              f"library (autograd through SDPA) {res['library_ms']:.4f} ms, "
              f"kernel / library {res['ms'] / res['library_ms']:.3f}; on the "
              f"card alone (profiler) kernel {fmt_ms(res['device_ms'])} ms, "
              f"library {fmt_ms(res['library_device_ms'])} ms, kernel / library "
              f"{fmt_ratio(res['device_ms'], res['library_device_ms'])}; "
              f"bound {res['bound_ms']:.5f} ms ({res['bound_by']})",
              flush=True)
        if "fp32" in res:
            print(fmt_k2_fp32(f"K2b {name} BH={bh} Lq={lq} Lk={lk} D={d}",
                              res["fp32"]), flush=True)
        results[name] = res
    return results


# ---------------------------------------------------------------------------
# K1: multi-branch dilated attention
# ---------------------------------------------------------------------------

def dilated_pairs(length, n_valid, segments, ratios, heads,
                  q_range=None) -> float:
    """(query, unmasked key) pairs of one batch row of a K1 call, summed
    over its heads: in branch (w, r) a query meets the keys of its segment
    (of length min(w, L)) in its residue class mod r, for the heads of that
    class's group; keys past ``n_valid`` are masked and need no work. With
    ``q_range=(p0, p1)`` only the queries at positions in [p0, p1)."""
    p0, p1 = q_range or (0, length)
    total = 0
    for w, r in zip(segments, ratios):
        sl = min(w, length)
        per_group = -(-heads // r)
        for s0 in range(0, length, sl):
            s1 = min(s0 + sl, length)
            for g in range(r):
                n_heads = max(0, min(per_group, heads - g * per_group))
                n_q = sum(1 for p in range(s0 + g, s1, r) if p0 <= p < p1)
                n_k = len(range(s0 + g, min(s1, n_valid), r))
                total += n_heads * n_q * n_k
    return float(total)


def k1_inputs(shape, n_valid, device, dtype, seed, n_tensors=3):
    """Seeded (B, L, H, D) tensors and the (B, L) mask of ``n_valid``."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    tensors = [torch.randn(shape, generator=g).to(device, dtype)
               for _ in range(n_tensors)]
    mask = torch.zeros(shape[:2], dtype=torch.bool)
    mask[:, :n_valid] = True
    return tensors, mask.to(device)


def mix_share(by_name):
    """The mix kernel's device ms in a :func:`device_times` split, ``None``
    where the split was not measured."""
    if by_name is None:
        return None
    return sum(ms for name, ms in by_name.items() if "fused_mix" in name)


def by_rows(fn, tensors, mask, rows):
    """``fn(*tensors, mask)``, or with ``rows`` the same a batch row at a
    time, concatenated along dim 0 (each tensor of a tuple on its own):
    the plain versions at the flagship's shape, whose fp32 scores do not
    fit three rows at once."""
    import torch
    if not rows:
        return fn(*tensors, mask)
    parts = [fn(*(t[i:i + 1] for t in tensors), mask[i:i + 1])
             for i in range(mask.shape[0])]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def core_mix_readings(q, k, v, mask, segments, ratios, scale, pairs, iters):
    """The tensor-core family's forward core and the mix, which K1f and K3f
    share, each launched alone (``fused_forward_part_cuda``) and timed on
    both clocks beside its bound: the core's products (three TF32 products
    each at fp32, :func:`tf32x3_bounds`; the bf16 tensor cores at bf16) and
    the mix's bytes. The events clock of each kernel alone is what the
    profiler's split of the whole call cannot give; a card time the
    profiler did not record is ``None``."""
    import torch
    df = importlib.import_module(COUNTERS["K3f"][0])
    kw = dict(q=q, k=k, v=v, mask=mask, segment_lengths=segments,
              dilated_ratios=ratios, scale=scale)
    pieces = df.fused_forward_part_cuda("core", **kw)
    mixed, stats = df.fused_forward_part_cuda("mix", pieces=pieces, **kw)

    def core():
        return df.fused_forward_part_cuda("core", **kw)

    def mix():
        return df.fused_forward_part_cuda("mix", pieces=pieces, **kw)
    r = dict(core_ms=time_ms(core, iters),
             core_device_ms=device_ms(core, iters=3, warmup=1),
             mix_alone_ms=time_ms(mix, iters),
             mix_alone_device_ms=device_ms(mix, iters=3, warmup=1))
    core_tensors = (q, k, v, mask, *pieces)
    if q.dtype == torch.float32:
        r["core_bound_ms"], r["core_bound_by"] = tf32x3_bounds(
            pairs, q.shape[-1], core_tensors, backward=False)[0]
    else:
        r["core_bound_ms"], r["core_bound_by"] = attention_bound(
            pairs, q.shape[-1], core_tensors, backward=False)
    r["mix_bound_ms"], r["mix_bound_by"] = bound_ms(
        0.0, tensor_bytes((*pieces, mixed, stats)))
    return r


def fmt_parts(r) -> str:
    """The core and the mix alone, from :func:`core_mix_readings`."""
    return (f"core alone {r['core_ms']:.4f} ms (card "
            f"{fmt_ms(r['core_device_ms'])}; bound {r['core_bound_ms']:.5f}, "
            f"{r['core_bound_by']}), mix alone {r['mix_alone_ms']:.4f} ms "
            f"(card {fmt_ms(r['mix_alone_device_ms'])}; bound "
            f"{r['mix_bound_ms']:.5f}, "
            f"{r['mix_bound_by']})")


def cuda_cores_fwd(key, device, shape, n_valid, segments, ratios, iters):
    """K1f (``key="K1f"``, with stats) or K3f (``"K3f"``) on the CUDA-core
    family, which serves every head size but 48, in fp32 at ``shape``: the
    family the C entry point chose, one launch counted on it, the output
    against ``dilated_attention`` by the max-scaled bound (2e-4) and
    :func:`check_out`'s fp32 limits, the stats (K1f's planes, K3f's
    ``(m, Z)``) against ``dilated_attention_stats`` (within 1e-3, NEG_INF
    exactly where the plain version has it), a rerun bit-equal, times on
    both clocks, the plain version's, and the bound on the CUDA cores
    (:data:`PEAK_FLOPS_FP32`) with the 3xTF32 one beside it. Printed."""
    import torch
    from modaltune_tpu_torch.ops.dilated import (dilated_attention,
                                                 dilated_attention_stats)
    dm = importlib.import_module(COUNTERS["K1f"][0])
    df = importlib.import_module(COUNTERS["K3f"][0])
    b, length, h, d = shape
    scale = d ** -0.5
    n = len(segments)
    (q, k, v), mask = k1_inputs(shape, n_valid, device, torch.float32,
                                seed=11)
    valid = mask[:, :, None, None]
    kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)
    tag = f"{key} float32 D={d}"
    counts = dilated_family_counts()[key]
    if key == "K1f":
        def kernel():
            return dm.mega_dilated_attention_cuda(
                q, k, v, mask, segments, ratios, scale, with_stats=True)
    else:
        def kernel():
            return df.fused_dilated_attention_cuda(q, k, v, mask, segments,
                                                   ratios, scale)
    r = dict(family=df.card_family(d, torch.float32))
    check(r["family"] == df.family(d, torch.float32) == "cuda_cores",
          f"{tag}: family {r['family']}, want cuda_cores")
    before = dict(counts)
    got = kernel()
    check(counts["cuda_cores"] == before["cuda_cores"] + 1 and
          sum(counts.values()) == sum(before.values()) + 1,
          f"{tag}: launches by family {before} -> {counts}")
    out = got[0]
    if key == "K1f":
        stats = got[1]
        want_st = dilated_attention_stats(q, k, v, **kw)
    else:
        stats = got[3].reshape(2, b * h, length).transpose(0, 1)
        want_st = dilated_attention_stats(q, k, v, **kw)[:, n:]
    want = dilated_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()),
          f"{tag}: non-finite output (padded rows included)")
    r["out_err"] = compare(out * valid, want * valid, 2e-4, f"{tag} out")
    r["rel"], r["row"] = check_out(out * valid, want * valid, "float32",
                                   f"{tag} out")
    r["stats_err"] = (stats - want_st).abs().max().item()
    check(r["stats_err"] <= 1e-3 and bool(((stats == -1e9) ==
                                            (want_st == -1e9)).all()),
          f"{tag} stats: max|err| {r['stats_err']:.3e}")
    del want, want_st, stats
    check(all(torch.equal(x, y) for x, y in zip(kernel(), got)),
          f"{tag}: a rerun gives other bits")
    pairs = b * dilated_pairs(length, n_valid, segments, ratios, h)
    r["ms"] = time_ms(kernel, iters)
    r["device_ms"] = device_ms(kernel, iters=3, warmup=1)
    r["plain_ms"] = time_ms(lambda: dilated_attention(q, k, v, **kw), iters)
    (r["tf32x3_bound_ms"], _), (r["bound_ms"], r["bound_by"]) = \
        tf32x3_bounds(pairs, d, (q, k, v, mask, *got), backward=False)
    print(f"{key} float32 B={b} L={length} H={h} D={d} valid={n_valid} "
          f"({r['family']}): out {r['out_err']:.3e}, rel-L2 {r['rel']:.3e}, "
          f"row-scaled {r['row']:.3e}, stats {r['stats_err']:.3e}, rerun "
          f"bit-equal | kernel {r['ms']:.4f} ms (card "
          f"{fmt_ms(r['device_ms'])}) | plain {r['plain_ms']:.4f} ms, bound "
          f"on the CUDA cores at {PEAK_FLOPS_FP32 / 1e12:.0f} TFLOP/s "
          f"{r['bound_ms']:.5f} ms ({r['bound_by']}; at 3xTF32 "
          f"{r['tf32x3_bound_ms']:.5f}), {r['ms'] / r['bound_ms']:.2f}x it, "
          f"no library call", flush=True)
    del got
    torch.cuda.empty_cache()
    return r


def phase_k1(device, shape=(3, 10240, 16, 48), n_valid=9000,
             segments=None, ratios=None, iters=20, plain_rows=False,
             cuda_cores_shape=(3, 10240, 16, 64)):
    """K1f against the plain version at the GigaPath steps' shape, fp32 and
    bf16, on the valid rows: the output by the max-scaled bound and by
    :func:`check_out` (``GRAD_LIMITS`` of the dtype: at fp32 rel-L2
    <= 1e-5); with stats its plane against ``dilated_attention_stats``
    (within 1e-3, NEG_INF exactly where the plain version has it). In each
    dtype the family the C entry points chose (``wgmma`` at bf16,
    ``tf32x3`` at fp32), a rerun of either variant bit-equal, and times on
    both clocks without and with stats, the mix kernel's among them, the
    forward core and the mix each alone (:func:`core_mix_readings`), the
    plain version's, and the bound (at fp32: at 3xTF32, and on the CUDA
    cores beside it). The bf16 readings also stand at the top level. With
    ``plain_rows`` the plain versions run a batch row at a time
    (:func:`by_rows`). With ``cuda_cores_shape`` also the CUDA-core family
    at that shape (D != 48), :func:`cuda_cores_fwd`, under
    ``"cuda_cores"``."""
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    df = importlib.import_module("modaltune_tpu_torch.ops.dilated_fused")
    from modaltune_tpu_torch.ops.dilated import (dilated_attention,
                                                 dilated_attention_stats)
    if segments is None:
        ln = SlideEncoderConfig().longnet()
        segments, ratios = ln.segment_lengths, ln.dilated_ratios
    b, length, h, d = shape
    scale = d ** -0.5
    res = {}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 1.6e-2)):
        dtn = str(dtype)[6:]
        (q, k, v), mask = k1_inputs(shape, n_valid, device, dtype, seed=7)
        valid = mask[:, :, None, None]
        kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)
        qf, kf, vf = q.float(), k.float(), v.float()

        def plain(fn, tensors):
            return by_rows(lambda *t: fn(*t[:-1], **dict(kw, mask=t[-1])),
                           tensors, mask, plain_rows)

        def inference():
            return dm.mega_dilated_attention(q, k, v, **kw)

        def with_stats():
            return dm.mega_dilated_attention_cuda(
                q, k, v, mask, segments, ratios, scale, with_stats=True)
        tag = f"K1 {dtn}"
        r = dict(family=df.card_family(d, dtype))
        check(r["family"] == df.family(d, dtype) != "cuda_cores",
              f"{tag}: family {r['family']}, want {df.family(d, dtype)}")
        got = inference()
        want = plain(dilated_attention, (qf, kf, vf))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              f"{tag}: non-finite output (padded rows included)")
        r["out_err"] = compare(got.float() * valid, want * valid, tol,
                               f"{tag} out")
        r["rel"], r["row"] = check_out(got.float() * valid, want * valid,
                                       dtn, f"{tag} out")
        del want
        _, stats = with_stats()
        want_st = plain(dilated_attention_stats, (qf, kf, vf))
        torch.cuda.synchronize()
        r["stats_err"] = (stats - want_st).abs().max().item()
        check(r["stats_err"] <= 1e-3 and bool(((stats == -1e9) ==
                                                (want_st == -1e9)).all()),
              f"{tag} stats: max|err| {r['stats_err']:.3e}")
        del want_st
        check(torch.equal(inference(), got),
              f"{tag}: a rerun gives other bits")
        again = with_stats()
        check(torch.equal(again[0], got) and torch.equal(again[1], stats),
              f"{tag} with stats: a rerun gives other bits")
        del again
        pairs = b * dilated_pairs(length, n_valid, segments, ratios, h)
        r["ms"] = time_ms(inference, iters)
        r["device_ms"], split = device_times(inference, iters=3, warmup=1)
        r["mix_device_ms"] = mix_share(split)
        r["stats_ms"] = time_ms(with_stats, iters)
        r["stats_device_ms"], split = device_times(with_stats, iters=3,
                                                   warmup=1)
        r["stats_mix_device_ms"] = mix_share(split)
        r["plain_ms"] = time_ms(lambda: plain(dilated_attention, (q, k, v)),
                                iters)
        r.update(core_mix_readings(q, k, v, mask, segments, ratios, scale,
                                   pairs, iters))
        if dtype == torch.float32:
            (r["bound_ms"], r["bound_by"]), (r["cuda_cores_bound_ms"], _) = \
                tf32x3_bounds(pairs, d, (q, k, v, mask, got), backward=False)
            r["stats_bound_ms"] = tf32x3_bounds(
                pairs, d, (q, k, v, mask, got, stats), backward=False)[0][0]
        else:
            r["bound_ms"], r["bound_by"] = attention_bound(
                pairs, d, (q, k, v, mask, got), backward=False)
            r["stats_bound_ms"], _ = attention_bound(
                pairs, d, (q, k, v, mask, got, stats), backward=False)
        res[dtn] = r
        del stats, got
        torch.cuda.empty_cache()
    res.update({key: res["bfloat16"][key] for key in (
        "family", "ms", "device_ms", "mix_device_ms", "stats_ms",
        "stats_device_ms", "stats_mix_device_ms", "plain_ms", "bound_ms",
        "bound_by", "stats_bound_ms")})
    for dtn, r in ((n, res[n]) for n in ("float32", "bfloat16")):
        print(f"K1f {dtn} B={b} L={length} H={h} D={d} valid={n_valid} "
              f"segments={tuple(segments)} ratios={tuple(ratios)} "
              f"({r['family']}): out {r['out_err']:.3e}, rel-L2 "
              f"{r['rel']:.3e}, row-scaled {r['row']:.3e}, stats "
              f"{r['stats_err']:.3e}, reruns bit-equal | kernel "
              f"{r['ms']:.4f} ms (card {fmt_ms(r['device_ms'])}, mix "
              f"{fmt_ms(r['mix_device_ms'])}), with stats "
              f"{r['stats_ms']:.4f} ms (card {fmt_ms(r['stats_device_ms'])}, "
              f"mix {fmt_ms(r['stats_mix_device_ms'])}) | {fmt_parts(r)} | "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}; with stats {r['stats_bound_ms']:.5f})"
              + (f", on the CUDA cores at "
                 f"{PEAK_FLOPS_FP32 / 1e12:.0f} TFLOP/s "
                 f"{r['cuda_cores_bound_ms']:.5f}"
                 if "cuda_cores_bound_ms" in r else "")
              + f", {r['ms'] / r['bound_ms']:.2f}x it, no library call",
              flush=True)
    if cuda_cores_shape:
        res["cuda_cores"] = cuda_cores_fwd("K1f", device, cuda_cores_shape,
                                           n_valid, segments, ratios, iters)
    return res


def plain_backward_times(q, k, v, dmix, mask, kw, rows, plain_iters):
    """``(ms, card ms)`` of autograd through the plain ``dilated_attention``
    on ``q``, ``k``, ``v`` (their dtype), summed over ``rows`` (batch-row
    slices); the card's ``None`` if the profiler missed any slice."""
    import torch
    from modaltune_tpu_torch.ops.dilated import dilated_attention
    ms = card = 0.0
    for c in rows:
        leaves = [x[c].detach().requires_grad_() for x in (q, k, v)]
        plain_out = dilated_attention(*leaves, **dict(kw, mask=mask[c]))

        def plain():
            return torch.autograd.grad(plain_out, leaves, dmix[c],
                                       retain_graph=True)
        ms += time_ms(plain, plain_iters, warmup=1)
        one = device_ms(plain, iters=1, warmup=0)
        card = None if card is None or one is None else card + one
        del plain_out, leaves
    return ms, card


def fp32_family_readings(kernel, got, pairs, d, tensors, iters, plain=None):
    """The fp32 backward's readings (K1b, K3b at fp32): a rerun bit-equal to
    ``got``, its family, times on both clocks (CUDA events; the profiler's
    sum) and the card's split by kernel, its bound at 3xTF32 and on the
    CUDA cores (:func:`tf32x3_bounds`); with ``plain`` (a function of no
    arguments) the plain backward's times too."""
    import torch
    df = importlib.import_module(COUNTERS["K3b"][0])
    check(all(torch.equal(a, b_) for a, b_ in zip(kernel(), got)),
          "fp32: a rerun gives other bits")
    r = dict(family=df.card_family(d, torch.float32),
             ms=time_ms(kernel, iters))
    r["device_ms"], split = device_times(kernel, iters=3, warmup=1)
    r["split"] = split and {name.split("(")[0]: round(ms, 4)
                            for name, ms in split.items()}
    (r["bound_ms"], r["bound_by"]), (r["cuda_cores_bound_ms"], _) = \
        tf32x3_bounds(pairs, d, tensors)
    if plain is not None:
        r["plain_ms"], r["plain_device_ms"] = plain()
    return r


def fmt_fp32(tag, r) -> str:
    """One line of :func:`fp32_family_readings`."""
    plain = (f", plain backward {r['plain_ms']:.4f} ms (card "
             f"{fmt_ms(r['plain_device_ms'])})" if "plain_ms" in r else "")
    return (f"{tag} fp32 ({r['family']}): kernel {r['ms']:.4f} ms (card "
            f"{fmt_ms(r['device_ms'])}; by kernel {r['split']}){plain}, bound at "
            f"3xTF32 {r['bound_ms']:.5f} ms ({r['bound_by']}, "
            f"{PEAK_FLOPS_TF32 / 1e12:.0f} TFLOP/s TF32; on the CUDA cores "
            f"at {PEAK_FLOPS_FP32 / 1e12:.0f} TFLOP/s "
            f"{r['cuda_cores_bound_ms']:.5f} ms), "
            f"{r['ms'] / r['bound_ms']:.2f}x it, rerun bit-equal")


def phase_k1b(device, shape=(3, 10240, 16, 48), n_valid=9000,
              segments=None, ratios=None, iters=10, plain_iters=3,
              plain_rows=False):
    """K1f's statistics and the K1 backward kernel against the plain
    version (its statistics, and autograd through it) at the train step's
    shape, fp32 and bf16, on the valid rows, by the max-scaled bound and by
    :func:`check_grads`; in bf16 a rerun bit-equal, the family the C entry
    points chose, times on both clocks; in fp32 the same
    (:func:`fp32_family_readings`: the 3xTF32 family at D = 48, its split
    by kernel, its bound at 3xTF32 and on the CUDA cores, the plain fp32
    backward's time). The plain side keeps every branch's
    fp32 probabilities for its backward, 6.9 GB at this shape (35.9 M
    query-key pairs per (batch, head) x 48 x 4 bytes), about 15 GB at its
    peak: it fits at B = 3. With ``plain_rows`` the plain side runs a batch
    row at a time (:func:`by_rows`), its time the sum of the rows'."""
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    from modaltune_tpu_torch.ops.dilated import (dilated_attention,
                                                 dilated_attention_stats)
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    df = importlib.import_module("modaltune_tpu_torch.ops.dilated_fused")
    if segments is None:
        ln = SlideEncoderConfig().longnet()
        segments, ratios = ln.segment_lengths, ln.dilated_ratios
    b, length, h, d = shape
    scale = d ** -0.5
    res = {"family": df.card_family(d, torch.bfloat16)}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
        (q, k, v, dmix), mask = k1_inputs(shape, n_valid, device, dtype,
                                          seed=9, n_tensors=4)
        valid = mask[:, :, None, None]
        kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)
        dmix = dmix * valid
        out, stats = dm.mega_dilated_attention_cuda(
            q, k, v, mask, segments, ratios, scale, with_stats=True)

        def kernel():
            return dm.mega_dilated_attention_backward_cuda(
                q, k, v, mask, dmix, stats, segments, ratios, scale)
        got = kernel()
        torch.cuda.synchronize()
        tag = f"K1b {str(dtype)[6:]}"
        rows = ([slice(i, i + 1) for i in range(b)] if plain_rows
                else [slice(None)])
        want_st = by_rows(
            lambda *t: dilated_attention_stats(*t[:-1],
                                               **dict(kw, mask=t[-1])),
            (q.float(), k.float(), v.float()), mask, plain_rows)
        st_err = (stats - want_st).abs().max().item()
        check(st_err <= 1e-3 and bool(((stats == -1e9) ==
                                       (want_st == -1e9)).all()),
              f"K1f stats {str(dtype)[6:]}: max|err| {st_err:.3e}")
        del want_st
        want = [[], [], []]
        for c in rows:
            leaves = [x[c].detach().float().requires_grad_()
                      for x in (q, k, v)]
            torch.autograd.backward(
                dilated_attention(*leaves, **dict(kw, mask=mask[c])),
                dmix[c].float())
            for w_, x in zip(want, leaves):
                w_.append(x.grad)
            del leaves
        want = [torch.cat(w_) * valid for w_ in want]
        torch.cuda.synchronize()
        got_valid = [gt * valid for gt in got]
        err = max(compare(gt, wt, tol, f"{tag} {gn}")
                  for gn, gt, wt in zip(("dq", "dk", "dv"), got_valid, want))
        rel, row = check_grads(("dq", "dk", "dv"), got_valid, want, dmix,
                               str(dtype)[6:], tag)
        res[str(dtype)[6:]] = dict(grad_err=err, stats_err=st_err, rel=rel,
                                   row=row)
        del want, got_valid
        pairs = b * dilated_pairs(length, n_valid, segments, ratios, h)
        if dtype == torch.float32:
            res["fp32"] = fp32_family_readings(
                kernel, got, pairs, d, (q, k, v, mask, dmix, stats, *got),
                iters, lambda: plain_backward_times(q, k, v, dmix, mask, kw,
                                                    rows, plain_iters))
        if dtype == torch.bfloat16:
            check(all(torch.equal(a, b_) for a, b_ in zip(kernel(), got)),
                  f"{tag}: a rerun gives other bits")
            res["ms"] = time_ms(kernel, iters)
            res["device_ms"] = device_ms(kernel, iters=3, warmup=1)
            res["fwd_stats_ms"] = time_ms(
                lambda: dm.mega_dilated_attention_cuda(
                    q, k, v, mask, segments, ratios, scale, with_stats=True),
                iters)
            res["plain_ms"], res["plain_device_ms"] = plain_backward_times(
                q, k, v, dmix, mask, kw, rows, plain_iters)
            res["bound_ms"], res["bound_by"] = attention_bound(
                pairs, d, (q, k, v, mask, dmix, stats, *got), backward=True)
        torch.cuda.empty_cache()
    f32, bf = res["float32"], res["bfloat16"]
    print(f"K1b B={b} L={length} H={h} D={d} valid={n_valid}: "
          f"stats fp32 {f32['stats_err']:.3e} bf16 {bf['stats_err']:.3e} | "
          f"dq/dk/dv fp32 {f32['grad_err']:.3e}, rel-L2 {f32['rel']:.3e}, "
          f"row-scaled {f32['row']:.3e} | bf16 ({res['family']}) "
          f"{bf['grad_err']:.3e}, rel-L2 {bf['rel']:.3e}, row-scaled "
          f"{bf['row']:.3e}, rerun bit-equal | K1b kernel {res['ms']:.4f} "
          f"ms (card {fmt_ms(res['device_ms'])}), plain backward "
          f"{res['plain_ms']:.4f} ms (card {fmt_ms(res['plain_device_ms'])}), "
          f"bound {res['bound_ms']:.5f} ms ({res['bound_by']}), no library "
          f"call | K1f with stats {res['fwd_stats_ms']:.4f} ms", flush=True)
    print(fmt_fp32(f"K1b B={b} L={length}", res["fp32"]), flush=True)
    return res


def phase_k1_qrange(device, shape=(3, 10240, 16, 48), n_valid=9000,
                    shards=(2, 4), segments=None, ratios=None, iters=10):
    """K1f and K1b with a ``q_token_range``, the rows of one shard of a
    sequence-parallel group, at K1's shape in fp32 and bf16, the sequence
    cut into ``n`` equal shards for each n of ``shards``:

    * every shard's K1f rows, concatenated, against the full K1f (by the
      max-scaled bound at 1e-5, and bit-equal: in both tensor-core
      families a range runs the same tiles' core and the same mix) and
      against the plain version with the range (:func:`check_out`, the
      valid rows); rows outside the range exactly 0, and with stats the
      range's planes and output the full call's bits;
    * K1b with each shard's range: dq exactly 0 outside it, the shards' dq
      rows and the sum of their dk, dv against the full K1b by
      :func:`check_grads`;
    * in bf16 one middle shard's time against the full call, K1f and K1b,
      on both clocks, beside the bound at the range's share of the pairs;
      in fp32 the same of K1b (the 3xTF32 family at D = 48), its split by
      kernel, its bound at 3xTF32 and on the CUDA cores."""
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    from modaltune_tpu_torch.ops.dilated import dilated_attention
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    df = importlib.import_module("modaltune_tpu_torch.ops.dilated_fused")
    if segments is None:
        ln = SlideEncoderConfig().longnet()
        segments, ratios = ln.segment_lengths, ln.dilated_ratios
    b, length, h, d = shape
    scale = d ** -0.5
    res = {"fwd_err": 0.0, "bwd_err": 0.0, "plain_rel": 0.0,
           "bwd_rel": 0.0, "by_n": {}, "fp32_by_n": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dtn = str(dtype)[6:]
        (q, k, v, dmix), mask = k1_inputs(shape, n_valid, device, dtype,
                                          seed=11, n_tensors=4)
        valid = mask[:, :, None, None]
        dmix = dmix * valid
        kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)
        full = dm.mega_dilated_attention(q, k, v, **kw)
        f_out, f_st = dm.mega_dilated_attention_cuda(
            q, k, v, mask, segments, ratios, scale, with_stats=True)
        f_grads = dm.mega_dilated_attention_backward_cuda(
            q, k, v, mask, dmix, f_st, segments, ratios, scale)
        plain = dilated_attention(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        for n in shards:
            tag = f"K1 q_token_range {dtn} n={n}"
            sl = length // n
            rows, dq_rows = [], []
            dk_sum = torch.zeros(shape, dtype=torch.float32, device=device)
            dv_sum = torch.zeros_like(dk_sum)
            for i in range(n):
                rng = (i * sl, (i + 1) * sl)
                part = dm.mega_dilated_attention(q, k, v, q_token_range=rng,
                                                 **kw)
                out, st = dm.mega_dilated_attention_cuda(
                    q, k, v, mask, segments, ratios, scale, with_stats=True,
                    q_token_range=rng)
                # one core and one mix with or without stats: the same bits
                check(torch.equal(out, part), f"{tag}: with stats, other "
                      f"output rows")
                outside = torch.ones(length, dtype=torch.bool, device=device)
                outside[rng[0]:rng[1]] = False
                check(not bool(part[:, outside].any()),
                      f"{tag} shard {i}: rows outside the range not 0")
                check(torch.equal(st[..., rng[0]:rng[1]],
                                  f_st[..., rng[0]:rng[1]]),
                      f"{tag} shard {i}: stats of the range differ")
                dq, dk, dv = dm.mega_dilated_attention_backward_cuda(
                    q, k, v, mask, dmix, st, segments, ratios, scale,
                    q_token_range=rng)
                check(not bool(dq[:, outside].any()),
                      f"{tag} shard {i}: dq outside the range not 0")
                rows.append(part[:, rng[0]:rng[1]])
                dq_rows.append(dq[:, rng[0]:rng[1]])
                dk_sum += dk.float()
                dv_sum += dv.float()
                del out, st, dq, dk, dv, part
            got = torch.cat(rows, dim=1)
            err = compare(got.float(), full.float(), 1e-5, f"{tag} vs full")
            check(torch.equal(got, full),
                  f"{tag}: shards' rows differ from the full K1f's bits")
            rel, row = check_out(got.float() * valid, plain * valid, dtn,
                                 f"{tag} vs plain")
            grels = check_grads(
                ("dq", "dk", "dv"),
                (torch.cat(dq_rows, dim=1) * valid, dk_sum * valid,
                 dv_sum * valid),
                [g.float() * valid for g in f_grads], dmix, dtn,
                f"{tag} K1b vs full K1b")
            bwd_err = max((torch.cat(dq_rows, dim=1).float() - f_grads[0]
                           .float()).abs().max().item(),
                          (dk_sum - f_grads[1].float()).abs().max().item(),
                          (dv_sum - f_grads[2].float()).abs().max().item())
            res["fwd_err"] = max(res["fwd_err"], err)
            res["bwd_err"] = max(res["bwd_err"], bwd_err)
            res["plain_rel"] = max(res["plain_rel"], rel)
            res["bwd_rel"] = max(res["bwd_rel"], grels[0])
            print(f"{tag}: rows vs full K1f max|err| {err:.3e} (bit-equal), "
                  f"vs plain rel-L2 {rel:.3e} row-scaled {row:.3e}; K1b "
                  f"shards "
                  f"vs full rel-L2 {grels[0]:.3e} row-scaled {grels[1]:.3e}, "
                  f"max|err| {bwd_err:.3e}; outside rows and dq 0",
                  flush=True)
            del rows, dq_rows, dk_sum, dv_sum, got
            if dtype == torch.float32:   # K1b's middle shard, 3xTF32
                i = n // 2
                rng = (i * sl, (i + 1) * sl)
                _, st = dm.mega_dilated_attention_cuda(
                    q, k, v, mask, segments, ratios, scale, with_stats=True,
                    q_token_range=rng)

                def bwd32(st=st, rng=rng):
                    return dm.mega_dilated_attention_backward_cuda(
                        q, k, v, mask, dmix, st, segments, ratios, scale,
                        q_token_range=rng)
                q_rows = q[:, rng[0]:rng[1]]
                r = dict(family=df.card_family(d, dtype),
                         bwd_ms=time_ms(bwd32, iters))
                r["bwd_device_ms"], split = device_times(bwd32, iters=3,
                                                         warmup=1)
                r["split"] = split and {name.split("(")[0]: round(ms, 4)
                                        for name, ms in split.items()}
                (r["bwd_bound_ms"], r["bwd_bound_by"]), \
                    (r["cuda_cores_bound_ms"], _) = tf32x3_bounds(
                        b * dilated_pairs(length, n_valid, segments, ratios,
                                          h, q_range=rng), d,
                        (q_rows, k, v, mask, dmix[:, rng[0]:rng[1]], st,
                         q_rows, k, v))
                res["fp32_by_n"][n] = r
                del st
            if dtype == torch.bfloat16:
                i = n // 2
                rng = (i * sl, (i + 1) * sl)
                _, st = dm.mega_dilated_attention_cuda(
                    q, k, v, mask, segments, ratios, scale, with_stats=True,
                    q_token_range=rng)

                def fwd(rng=rng):
                    return dm.mega_dilated_attention(q, k, v,
                                                     q_token_range=rng, **kw)

                def bwd(st=st, rng=rng):
                    return dm.mega_dilated_attention_backward_cuda(
                        q, k, v, mask, dmix, st, segments, ratios, scale,
                        q_token_range=rng)
                pairs = b * dilated_pairs(length, n_valid, segments, ratios,
                                          h, q_range=rng)
                q_rows = q[:, rng[0]:rng[1]]
                r = dict(ms=time_ms(fwd, iters),
                         device_ms=device_ms(fwd, iters=3, warmup=1),
                         bwd_ms=time_ms(bwd, iters),
                         bwd_device_ms=device_ms(bwd, iters=3, warmup=1),
                         pairs_share=pairs / (b * dilated_pairs(
                             length, n_valid, segments, ratios, h)))
                r["bound_ms"], r["bound_by"] = attention_bound(
                    pairs, d, (q_rows, k, v, mask, full), backward=False)
                r["bwd_bound_ms"], r["bwd_bound_by"] = attention_bound(
                    pairs, d, (q_rows, k, v, mask, dmix[:, rng[0]:rng[1]],
                               st, q_rows, k, v), backward=True)
                res["by_n"][n] = r
                del st
        if dtype == torch.float32:
            res["fp32_full_bwd_ms"] = time_ms(
                lambda: dm.mega_dilated_attention_backward_cuda(
                    q, k, v, mask, dmix, f_st, segments, ratios, scale),
                iters)
        if dtype == torch.bfloat16:
            res["full_ms"] = time_ms(
                lambda: dm.mega_dilated_attention(q, k, v, **kw), iters)
            res["full_device_ms"] = device_ms(
                lambda: dm.mega_dilated_attention(q, k, v, **kw), iters=3,
                warmup=1)
            res["full_bwd_ms"] = time_ms(
                lambda: dm.mega_dilated_attention_backward_cuda(
                    q, k, v, mask, dmix, f_st, segments, ratios, scale),
                iters)
        del full, f_out, f_st, f_grads, plain
        torch.cuda.empty_cache()
    for n, r in res["by_n"].items():
        print(f"K1 q_token_range bf16 one shard of {n} (middle): K1f "
              f"{r['ms']:.4f} ms (card {fmt_ms(r['device_ms'])}) against the full "
              f"call's {res['full_ms']:.4f} ms (card {fmt_ms(res['full_device_ms'])}"
              f"), ratio {r['ms'] / res['full_ms']:.3f}; K1b {r['bwd_ms']:.4f} "
              f"ms (card {fmt_ms(r['bwd_device_ms'])}) against "
              f"{res['full_bwd_ms']:.4f} ms, ratio "
              f"{r['bwd_ms'] / res['full_bwd_ms']:.3f}; the range's share of "
              f"the pairs {r['pairs_share']:.4f}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), backward {r['bwd_bound_ms']:.5f} ms "
              f"({r['bwd_bound_by']})", flush=True)
    for n, r in res["fp32_by_n"].items():
        print(f"K1 q_token_range fp32 ({r['family']}) one shard of {n} "
              f"(middle): K1b {r['bwd_ms']:.4f} ms (card "
              f"{fmt_ms(r['bwd_device_ms'])}; by kernel {r['split']}) against the "
              f"full call's {res['fp32_full_bwd_ms']:.4f} ms, ratio "
              f"{r['bwd_ms'] / res['fp32_full_bwd_ms']:.3f}; bound at 3xTF32 "
              f"{r['bwd_bound_ms']:.5f} ms ({r['bwd_bound_by']}; on the CUDA "
              f"cores {r['cuda_cores_bound_ms']:.5f} ms)", flush=True)
    return res


# ---------------------------------------------------------------------------
# K3: per-branch dilated attention and the mix (K1's function, other kernels)
# ---------------------------------------------------------------------------

def phase_k3(device, shape=(3, 10240, 16, 48), n_valid=9000,
             segments=None, ratios=None, iters=10, plain_rows=False,
             cuda_cores_shape=(3, 10240, 16, 64)):
    """K3f at K1's shape, fp32 and bf16: the mixed output against
    ``dilated_attention`` (by the max-scaled bound and by
    :func:`check_out`, ``GRAD_LIMITS`` of the dtype), ``(m, Z)`` against
    ``dilated_attention_stats``, every branch's compact ``(out_b, lse_b)``
    against the plain branch, and the mix against the plain mix of the
    kernel's own compact pieces. In each dtype the family (``wgmma`` at
    bf16, ``tf32x3`` at fp32), a rerun bit-equal, times on both clocks (the
    mix kernel's among them), the forward core and the mix each alone
    (:func:`core_mix_readings`), K1f's on the same inputs, the plain
    version's, and the bound (at fp32: at 3xTF32, and on the CUDA cores
    beside it). The bf16 readings also stand at the top level. With
    ``plain_rows`` the plain versions run a batch row at a time
    (:func:`by_rows`). With ``cuda_cores_shape`` also the CUDA-core family
    at that shape (D != 48), :func:`cuda_cores_fwd`, under
    ``"cuda_cores"``."""
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    from modaltune_tpu_torch.ops.dilated import (dilated_attention,
                                                 dilated_attention_stats)
    df = importlib.import_module("modaltune_tpu_torch.ops.dilated_fused")
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    if segments is None:
        ln = SlideEncoderConfig().longnet()
        segments, ratios = ln.segment_lengths, ln.dilated_ratios
    b, length, h, d = shape
    scale = d ** -0.5
    n = len(segments)
    res = {}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 1.6e-2)):
        dtn = str(dtype)[6:]
        (q, k, v), mask = k1_inputs(shape, n_valid, device, dtype, seed=7)
        valid = mask[:, :, None, None]
        kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)

        def kernel():
            return df.fused_dilated_attention_cuda(q, k, v, mask, segments,
                                                   ratios, scale)

        def plain(fn, tensors):
            return by_rows(lambda *t: fn(*t[:-1], **dict(kw, mask=t[-1])),
                           tensors, mask, plain_rows)
        tag = f"K3 {dtn}"
        r = dict(family=df.card_family(d, dtype))
        check(r["family"] == df.family(d, dtype) != "cuda_cores",
              f"{tag}: family {r['family']}, want {df.family(d, dtype)}")
        mixed, out_c, lse_c, stats = kernel()
        qf, kf, vf = q.float(), k.float(), v.float()
        want = plain(dilated_attention, (qf, kf, vf))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(mixed.float()).all()),
              f"{tag}: non-finite output (padded rows included)")
        r["out_err"] = compare(mixed.float() * valid, want * valid, tol,
                               f"{tag} out")
        r["rel"], r["row"] = check_out(mixed.float() * valid, want * valid,
                                       dtn, f"{tag} out")
        del want
        want_st = plain(dilated_attention_stats, (qf, kf, vf))[:, n:]
        got_st = stats.reshape(2, b * h, length).transpose(0, 1)
        r["stats_err"] = (got_st - want_st).abs().max().item()
        check(r["stats_err"] <= 1e-3 and bool(((got_st == -1e9) ==
                                                (want_st == -1e9)).all()),
              f"{tag} (m, Z): max|err| {r['stats_err']:.3e}")
        del want_st
        outs = df.split_branches(out_c, length, segments, ratios)
        lses = df.split_branches(lse_c, length, segments, ratios)
        r["piece_err"] = r["lse_err"] = r["piece_rel"] = r["piece_row"] = 0.0
        for i, (w, ra) in enumerate(zip(segments, ratios)):
            want_o, want_l = by_rows(
                lambda *t: df.fused_branch_reference(*t, int(w), int(ra),
                                                     scale),
                (qf, kf, vf), mask, plain_rows)
            r["piece_err"] = max(r["piece_err"], compare(
                outs[i], want_o, tol, f"{tag} branch {i} compact out"))
            rel, row = check_out(outs[i].float(), want_o, dtn,
                                 f"{tag} branch {i} compact out")
            r["piece_rel"] = max(r["piece_rel"], rel)
            r["piece_row"] = max(r["piece_row"], row)
            e = (lses[i] - want_l).abs().max().item()
            check(e <= 1e-3 and bool(((lses[i] == -1e9) ==
                                      (want_l == -1e9)).all()),
                  f"{tag} branch {i} compact lse: max|err| {e:.3e}")
            r["lse_err"] = max(r["lse_err"], e)
            del want_o, want_l
        want_mix, _, _ = df.fused_mix_reference(outs, lses, length, segments,
                                                ratios)
        r["mix_err"] = compare(mixed, want_mix, tol, f"{tag} mix kernel")
        del want_mix
        check(all(torch.equal(x, y) for x, y in
                  zip(kernel(), (mixed, out_c, lse_c, stats))),
              f"{tag}: a rerun gives other bits")
        pairs = b * dilated_pairs(length, n_valid, segments, ratios, h)
        r["ms"] = time_ms(kernel, iters)
        r["device_ms"], split = device_times(kernel, iters=3, warmup=1)
        r["mix_device_ms"] = mix_share(split)
        r["k1f_ms"] = time_ms(lambda: dm.mega_dilated_attention_cuda(
            q, k, v, mask, segments, ratios, scale), iters)
        r["plain_ms"] = time_ms(
            lambda: plain(dilated_attention, (q, k, v)), iters)
        r.update(core_mix_readings(q, k, v, mask, segments, ratios, scale,
                                   pairs, iters))
        tensors = (q, k, v, mask, mixed, out_c, lse_c, stats)
        if dtype == torch.float32:
            (r["bound_ms"], r["bound_by"]), (r["cuda_cores_bound_ms"], _) = \
                tf32x3_bounds(pairs, d, tensors, backward=False)
        else:
            r["bound_ms"], r["bound_by"] = attention_bound(
                pairs, d, tensors, backward=False)
        res[dtn] = r
        del mixed, out_c, lse_c, stats, outs, lses
        torch.cuda.empty_cache()
    res.update({key: res["bfloat16"][key] for key in (
        "family", "ms", "device_ms", "mix_device_ms", "k1f_ms", "plain_ms",
        "bound_ms", "bound_by")})
    for dtn, r in ((n, res[n]) for n in ("float32", "bfloat16")):
        print(f"K3f {dtn} B={b} L={length} H={h} D={d} valid={n_valid}, "
              f"{df.total_rows(length, segments, ratios)} compact rows per "
              f"head ({r['family']}): out {r['out_err']:.3e}, rel-L2 "
              f"{r['rel']:.3e}, row-scaled {r['row']:.3e}, compact out "
              f"{r['piece_err']:.3e}, rel-L2 {r['piece_rel']:.3e}, "
              f"row-scaled {r['piece_row']:.3e}, lse {r['lse_err']:.3e}, "
              f"(m, Z) {r['stats_err']:.3e}, mix {r['mix_err']:.3e}, rerun "
              f"bit-equal | kernel {r['ms']:.4f} ms (card "
              f"{fmt_ms(r['device_ms'])}, mix {fmt_ms(r['mix_device_ms'])}) | "
              f"{fmt_parts(r)} | plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
              + (f", on the CUDA cores {r['cuda_cores_bound_ms']:.5f}"
                 if "cuda_cores_bound_ms" in r else "")
              + f", {r['ms'] / r['bound_ms']:.2f}x it, no library call | K1f "
              f"on the same inputs {r['k1f_ms']:.4f} ms, K3f / K1f "
              f"{r['ms'] / r['k1f_ms']:.3f}", flush=True)
    if cuda_cores_shape:
        res["cuda_cores"] = cuda_cores_fwd("K3f", device, cuda_cores_shape,
                                           n_valid, segments, ratios, iters)
    return res


def phase_k3b(device, shape=(3, 10240, 16, 48), n_valid=9000,
              segments=None, ratios=None, iters=10, plain_iters=3,
              plain_rows=False):
    """K3b against autograd through the plain version at the train step's
    shape, fp32 and bf16, on the valid rows, by the max-scaled bound and
    by :func:`check_grads`; in bf16 a rerun bit-equal, the family, times
    on both clocks, K1b's on the same inputs beside them; in fp32 the
    readings of :func:`fp32_family_readings` and K1b's time on the same
    inputs. The plain side's
    memory is :func:`phase_k1b`'s; with ``plain_rows`` it runs a batch row
    at a time, its time the sum of the rows'."""
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    from modaltune_tpu_torch.ops.dilated import dilated_attention
    df = importlib.import_module("modaltune_tpu_torch.ops.dilated_fused")
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    if segments is None:
        ln = SlideEncoderConfig().longnet()
        segments, ratios = ln.segment_lengths, ln.dilated_ratios
    b, length, h, d = shape
    scale = d ** -0.5
    res = {"family": df.card_family(d, torch.bfloat16)}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
        (q, k, v, dmix), mask = k1_inputs(shape, n_valid, device, dtype,
                                          seed=9, n_tensors=4)
        valid = mask[:, :, None, None]
        dmix = dmix * valid
        kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)
        _, _, lse_c, stats = df.fused_dilated_attention_cuda(
            q, k, v, mask, segments, ratios, scale)

        def kernel():
            return df.fused_dilated_attention_backward_cuda(
                q, k, v, mask, dmix, lse_c, stats, segments, ratios, scale)
        got = kernel()
        torch.cuda.synchronize()
        tag = f"K3b {str(dtype)[6:]}"
        rows = ([slice(i, i + 1) for i in range(b)] if plain_rows
                else [slice(None)])
        want = [[], [], []]
        for c in rows:
            leaves = [x[c].detach().float().requires_grad_()
                      for x in (q, k, v)]
            torch.autograd.backward(
                dilated_attention(*leaves, **dict(kw, mask=mask[c])),
                dmix[c].float())
            for w_, x in zip(want, leaves):
                w_.append(x.grad)
            del leaves
        want = [torch.cat(w_) * valid for w_ in want]
        torch.cuda.synchronize()
        got_valid = [gt * valid for gt in got]
        err = max(compare(gt, wt, tol, f"{tag} {gn}")
                  for gn, gt, wt in zip(("dq", "dk", "dv"), got_valid, want))
        rel, row = check_grads(("dq", "dk", "dv"), got_valid, want, dmix,
                               str(dtype)[6:], tag)
        res[str(dtype)[6:]] = dict(grad_err=err, rel=rel, row=row)
        del want, got_valid
        if dtype == torch.float32:
            res["fp32"] = fp32_family_readings(
                kernel, got,
                b * dilated_pairs(length, n_valid, segments, ratios, h), d,
                (q, k, v, mask, dmix, lse_c, stats, *got), iters,
                lambda: plain_backward_times(q, k, v, dmix, mask, kw, rows,
                                             plain_iters))
            _, k1_stats = dm.mega_dilated_attention_cuda(
                q, k, v, mask, segments, ratios, scale, with_stats=True)
            res["fp32"]["k1b_ms"] = time_ms(
                lambda: dm.mega_dilated_attention_backward_cuda(
                    q, k, v, mask, dmix, k1_stats, segments, ratios, scale),
                iters)
            del k1_stats
        if dtype == torch.bfloat16:
            check(all(torch.equal(a, b_) for a, b_ in zip(kernel(), got)),
                  f"{tag}: a rerun gives other bits")
            res["ms"] = time_ms(kernel, iters)
            res["device_ms"] = device_ms(kernel, iters=3, warmup=1)
            res["bound_ms"], res["bound_by"] = attention_bound(
                b * dilated_pairs(length, n_valid, segments, ratios, h), d,
                (q, k, v, mask, dmix, lse_c, stats, *got), backward=True)
            res["saved_bytes"] = tensor_bytes((lse_c, stats))
            del lse_c, stats, got
            _, k1_stats = dm.mega_dilated_attention_cuda(
                q, k, v, mask, segments, ratios, scale, with_stats=True)
            res["k1b_ms"] = time_ms(
                lambda: dm.mega_dilated_attention_backward_cuda(
                    q, k, v, mask, dmix, k1_stats, segments, ratios, scale),
                iters)
            res["k1_saved_bytes"] = tensor_bytes((k1_stats,))
            del k1_stats
            res["plain_ms"], res["plain_device_ms"] = plain_backward_times(
                q, k, v, dmix, mask, kw, rows, plain_iters)
        torch.cuda.empty_cache()
    f32, bf = res["float32"], res["bfloat16"]
    print(f"K3b B={b} L={length} H={h} D={d} valid={n_valid}: dq/dk/dv fp32 "
          f"{f32['grad_err']:.3e}, rel-L2 {f32['rel']:.3e}, row-scaled "
          f"{f32['row']:.3e} | bf16 ({res['family']}) {bf['grad_err']:.3e}, "
          f"rel-L2 {bf['rel']:.3e}, row-scaled {bf['row']:.3e}, rerun "
          f"bit-equal | kernel {res['ms']:.4f} ms (card "
          f"{fmt_ms(res['device_ms'])}), plain backward {res['plain_ms']:.4f} ms "
          f"(card {fmt_ms(res['plain_device_ms'])}), bound {res['bound_ms']:.5f} "
          f"ms ({res['bound_by']}), no library call | K1b on the same inputs {res['k1b_ms']:.4f} ms | saved for "
          f"the backward besides q, k, v: {res['saved_bytes'] / 1e6:.1f} MB "
          f"(K1: {res['k1_saved_bytes'] / 1e6:.1f} MB)", flush=True)
    print(fmt_fp32(f"K3b B={b} L={length}", res["fp32"]) + f" | K1b fp32 on "
          f"the same inputs {res['fp32']['k1b_ms']:.4f} ms", flush=True)
    return res


# ---------------------------------------------------------------------------
# K5: fused exact GELU -> LayerNorm
# ---------------------------------------------------------------------------

def k5_inputs(shape, device, dtype, seed):
    """x and dy ``shape``, gamma and beta (F,), all in ``dtype`` (the
    frozen backbone holds its LayerNorm parameters in the compute dtype)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 1.5).to(device, dtype)
    dy = torch.randn(shape, generator=g).to(device, dtype)
    scale = (1.0 + 0.2 * torch.randn(shape[-1], generator=g)).to(device, dtype)
    bias = (0.1 * torch.randn(shape[-1], generator=g)).to(device, dtype)
    return x, dy, scale, bias


def unfused_gelu_ln(x, scale, bias, eps):
    """The chain the model runs on its default route: ``gelu_exact``, then
    ``layer_norm``."""
    import torch.nn.functional as F
    from modaltune_tpu_torch.ops import gelu_exact
    return F.layer_norm(gelu_exact(x), x.shape[-1:], scale, bias, eps)


def phase_k5(device, shape=(30720, 3072), eps=1e-5, iters=20):
    """K5f against its plain version at the FFN's shape (3 tasks x 10,240
    tokens, ffn 3072), fp32 (the generic kernel) and bf16 (the row-resident
    kernel, which it must take; its output also by :func:`check_out`,
    since over 94 M outputs max|y| is several times a typical one); times
    in bf16 beside the unfused chain
    (``plain_ms``) and the plain version. No single PyTorch call computes
    GELU -> LayerNorm, so there is no library time."""
    import torch
    gl = importlib.import_module("modaltune_tpu_torch.ops.gelu_ln")
    res = {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1.6e-2)):
        x, _, scale, bias = k5_inputs(shape, device, dtype, seed=11)
        rows_before = gl.ROWS_LAUNCHES
        got = gl.gelu_ln_cuda(x, scale, bias, eps)
        want = gl.gelu_ln_reference(x, scale, bias, eps)
        torch.cuda.synchronize()
        tag = f"K5 {str(dtype)[6:]}"
        res[str(dtype)[6:] + "_route"] = (
            "rows" if gl.ROWS_LAUNCHES > rows_before else "generic")
        res[str(dtype)[6:]] = compare(got, want, tol, f"{tag} out")
        res[str(dtype)[6:] + "_vs_unfused"] = (
            got.float() - unfused_gelu_ln(x, scale, bias, eps).float()
        ).abs().max().item()
        if dtype == torch.bfloat16:
            res["out_rel"], res["out_row"] = check_out(
                got, want, "bfloat16", f"{tag} out")
        del want
        if dtype == torch.bfloat16:
            check(torch.equal(gl.gelu_ln_cuda(x, scale, bias, eps), got),
                  f"{tag}: two runs differ")
            res["ms"] = time_ms(lambda: gl.gelu_ln_cuda(x, scale, bias, eps),
                                iters)
            res["device_ms"] = device_ms(
                lambda: gl.gelu_ln_cuda(x, scale, bias, eps))
            res["plain_ms"] = time_ms(
                lambda: unfused_gelu_ln(x, scale, bias, eps), iters)
            res["reference_ms"] = time_ms(
                lambda: gl.gelu_ln_reference(x, scale, bias, eps), iters)
            # erf, two products and the statistics: ~30 fp32 flop an element
            res["bound_ms"], res["bound_by"] = bound_ms(
                30.0 * x.numel(), tensor_bytes((x, scale, bias, got)),
                PEAK_FLOPS_FP32)
        del got
        torch.cuda.empty_cache()
    check(res["bfloat16_route"] == "rows",
          "K5 bf16 at the FFN's shape did not take the row-resident kernel")
    res["family"] = "rows"
    print(f"K5 x={tuple(shape)}: fp32 ({res['float32_route']}) out "
          f"{res['float32']:.3e} (from the unfused chain "
          f"{res['float32_vs_unfused']:.3e}) | bf16 ({res['bfloat16_route']}) "
          f"out {res['bfloat16']:.3e}, rel-L2 {res['out_rel']:.3e}, "
          f"row-scaled {res['out_row']:.3e} (from the unfused chain "
          f"{res['bfloat16_vs_unfused']:.3e}), rerun bit-equal | kernel "
          f"{res['ms']:.4f} ms (card {fmt_ms(res['device_ms'])}), unfused chain "
          f"{res['plain_ms']:.4f} ms, plain version {res['reference_ms']:.4f} "
          f"ms, bound {res['bound_ms']:.5f} ms ({res['bound_by']}), no "
          f"library call", flush=True)
    return res


def phase_k5b(device, shape=(30720, 3072), eps=1e-5, iters=20):
    """K5b against its plain version at the FFN's shape, fp32 (the generic
    kernels) and bf16 (the row-resident ones, which it must take), in both
    variants: with dgamma and dbeta, dx, dgamma and dbeta each by
    :func:`check_grads` (dgamma and dbeta against the plain version's fp32
    sums); without them (the train step's variant), dx the same bits; two
    runs of each bit-identical. Times in bf16, each variant beside its
    bound and autograd through the unfused chain, and the plain version:
    ``ms``, ``plain_ms`` (x, gamma and beta leaves) and ``bound_ms`` are
    the variant with dgamma and dbeta, the function the TPU kernel
    computes; ``dx_only_*`` the train step's variant (``dx_only_plain_ms``:
    x alone a leaf, as in the train step)."""
    import torch
    gl = importlib.import_module("modaltune_tpu_torch.ops.gelu_ln")
    names = ("dx", "dgamma", "dbeta")
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dy, scale, bias = k5_inputs(shape, device, dtype, seed=12)
        rows_before = gl.BWD_ROWS_LAUNCHES
        got = gl.gelu_ln_backward_cuda(x, scale, dy, eps)
        dx_only = gl.gelu_ln_backward_cuda(x, scale, dy, eps,
                                           param_grads=False)
        dx, _, _ = gl.gelu_ln_backward_reference(x, scale, dy, eps)
        _, dg, db = gl.gelu_ln_backward_reference(x, scale.float(), dy, eps)
        torch.cuda.synchronize()
        dt = str(dtype)[6:]
        tag = f"K5b {dt}"
        res[dt + "_route"] = ("rows" if gl.BWD_ROWS_LAUNCHES - rows_before == 2
                              else "generic")
        for gn, gt in zip(names, got):
            check(bool(torch.isfinite(gt.float()).all()),
                  f"{tag} {gn}: non-finite values")
        res[dt] = max(
            (gt.float() - wt.float()).abs().max().item()
            for gt, wt in zip(got, (dx, dg, db)))
        res[dt + "_rel"], res[dt + "_row"] = \
            check_grads(names, got, (dx, dg, db), dy, dt, tag)
        check(dx_only[1] is None and dx_only[2] is None
              and torch.equal(dx_only[0], got[0]),
              f"{tag}: the variant without dgamma/dbeta gives another dx")
        again = gl.gelu_ln_backward_cuda(x, scale, dy, eps)
        check(all(torch.equal(a, g) for a, g in zip(again, got)),
              f"{tag}: two runs differ")
        check(torch.equal(gl.gelu_ln_backward_cuda(
            x, scale, dy, eps, param_grads=False)[0], dx_only[0]),
              f"{tag}: two runs of the variant without dgamma/dbeta differ")
        del dx, dg, db, again
        if dtype == torch.bfloat16:
            res["ms"] = time_ms(
                lambda: gl.gelu_ln_backward_cuda(x, scale, dy, eps), iters)
            res["dx_only_ms"] = time_ms(lambda: gl.gelu_ln_backward_cuda(
                x, scale, dy, eps, param_grads=False), iters)
            res["device_ms"] = device_ms(
                lambda: gl.gelu_ln_backward_cuda(x, scale, dy, eps))
            res["dx_only_device_ms"] = device_ms(
                lambda: gl.gelu_ln_backward_cuda(x, scale, dy, eps,
                                                 param_grads=False))
            res["reference_ms"] = time_ms(
                lambda: gl.gelu_ln_backward_reference(x, scale, dy, eps),
                iters)
            # erf, exp and the two row sums: ~60 fp32 flop an element
            res["bound_ms"], res["bound_by"] = bound_ms(
                60.0 * x.numel(), tensor_bytes((x, scale, dy, *got)),
                PEAK_FLOPS_FP32)
            res["dx_only_bound_ms"], res["dx_only_bound_by"] = bound_ms(
                60.0 * x.numel(), tensor_bytes((x, scale, dy, dx_only[0])),
                PEAK_FLOPS_FP32)
            del got, dx_only
            for key, grads in (("plain_ms", (True, True, True)),
                               ("dx_only_plain_ms", (True, False, False))):
                leaves = [t.detach().requires_grad_(r)
                          for t, r in zip((x, scale, bias), grads)]
                out = unfused_gelu_ln(*leaves, eps)
                wrt = [t for t in leaves if t.requires_grad]
                res[key] = time_ms(lambda: torch.autograd.grad(
                    out, wrt, dy, retain_graph=True), iters)
                del out, leaves, wrt
        torch.cuda.empty_cache()
    check(res["bfloat16_route"] == "rows",
          "K5b bf16 at the FFN's shape did not take the row-resident kernels")
    res["family"] = "rows"
    print(f"K5b x={tuple(shape)}: dx/dgamma/dbeta fp32 "
          f"({res['float32_route']}) max|err| {res['float32']:.3e}, rel-L2 "
          f"{res['float32_rel']:.3e}, row-scaled {res['float32_row']:.3e} | "
          f"bf16 ({res['bfloat16_route']}) {res['bfloat16']:.3e}, rel-L2 "
          f"{res['bfloat16_rel']:.3e}, row-scaled {res['bfloat16_row']:.3e}; "
          f"dx of both variants the same bits, two runs of each bit-identical",
          flush=True)
    print(f"K5b x={tuple(shape)} bf16: with dgamma/dbeta {res['ms']:.4f} ms "
          f"(card {fmt_ms(res['device_ms'])}; bound {res['bound_ms']:.5f} ms, "
          f"{res['bound_by']}; autograd through the unfused chain "
          f"{res['plain_ms']:.4f} ms) | without them (the train step's) "
          f"{res['dx_only_ms']:.4f} ms (card {fmt_ms(res['dx_only_device_ms'])}; "
          f"bound {res['dx_only_bound_ms']:.5f} ms, "
          f"{res['dx_only_bound_by']}; unfused chain, x alone "
          f"{res['dx_only_plain_ms']:.4f} ms) | plain version "
          f"{res['reference_ms']:.4f} ms, no library call", flush=True)
    return res


# ---------------------------------------------------------------------------
# K4: flash attention with the 2-D ALiBi bias (TITAN)
# ---------------------------------------------------------------------------

# (B, H, N, D, head chunk): 1 slide x 3 tasks, TITAN's 12 heads of 64, the
# cls token + the 4,095- and 16,383-cell buckets. The plain version keeps
# (B, H, N, N) fp32 scores: whole at 4,096 (2.4 GB a tensor), and at
# 16,384 on slices of one batch row and `head chunk` heads (heads are
# independent), whose times add up to the plain version's.
K4_SHAPES = [
    ("n4096", 3, 12, 4096, 64, 12),
    ("n16384", 3, 12, 16384, 64, 2),
]


def k4_inputs(b, h, n, d, dtype, device, seed, masked=0.12, holes=False):
    """q/k/v/dout (B, H, N, D); coords3 with the cls row first and cells
    of a 225 x 225 grid; the last ``masked`` share of the keys masked, and
    batch row 0 with every key masked but the cls token; dout weighs the
    valid query rows only. ``holes``: besides, runs of masked keys inside
    the valid range (background cells are not only a tail): every seventh
    stretch of 96 keys, so whole 64-key tiles die between live ones and
    their neighbours are masked in part, in another phase per batch row."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, n, d, generator=g) for _ in range(4))
    coords3 = torch.zeros(b, n, 3)
    coords3[:, 1:, :2] = torch.randint(0, 225, (b, n - 1, 2),
                                       generator=g).float()
    coords3[:, 0, 2] = 1.0
    key_mask = torch.ones(b, n, dtype=torch.bool)
    key_mask[:, n - int(round(masked * n)):] = False
    if holes:
        run = torch.arange(n) // 96
        for i in range(b):
            key_mask[i, (run % 7 == (3 + i) % 7) & (run > 0)] = False
    key_mask[0, 1:] = False
    dout = dout * key_mask[:, None, :, None]
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)])
    return (*(t.to(device, dtype) for t in (q, k, v, dout)),
            coords3.to(device), slopes.to(device), key_mask.to(device))


def k4_slices(b, h, chunk):
    """(batch row, head range) slices that the plain version fits in."""
    return [(slice(i, i + 1), slice(j, j + chunk))
            for i in range(b) for j in range(0, h, chunk)]


def dense_alibi_bias(coords3, slopes, key_mask, dtype):
    """The (B, H, N, N) additive mask the library call needs (ALiBi term
    plus NEG_INF on masked keys), built one (row, head) plane at a time."""
    import torch
    from modaltune_tpu_torch.ops.alibi_flash import (NEG_INF,
                                                     alibi_scores_bias)
    b, n = key_mask.shape
    out = torch.empty((b, slopes.numel(), n, n), dtype=dtype,
                      device=coords3.device)
    for i in range(b):
        for j in range(slopes.numel()):
            plane = alibi_scores_bias(coords3[i:i + 1], slopes[j:j + 1])[0, 0]
            out[i, j] = torch.where(key_mask[i][None, :], plane, NEG_INF)
    return out


def k4_forward_errors(af, tensors, chunk, out_tol, lse_tol, tag):
    """K4f on ``tensors`` (as ``k4_inputs`` returns them) against the plain
    version, slice by slice; fails over a tolerance. Returns (largest out
    error, largest lse error, the kernel's out, its lse)."""
    import torch
    q, k, v, _, coords3, slopes, key_mask = tensors
    b, h, _, d = q.shape
    got_o, got_l = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                                 key_mask, d ** -0.5)
    torch.cuda.synchronize()
    err_o = err_l = 0.0
    for bs, hs in k4_slices(b, h, chunk):
        want_o, want_l = af.alibi_attention_reference(
            q[bs, hs].float(), k[bs, hs].float(), v[bs, hs].float(),
            coords3[bs], slopes[hs], key_mask[bs])
        err_o = max(err_o, compare(got_o[bs, hs], want_o, out_tol,
                                   f"{tag} out {bs} {hs}"))
        e = (got_l[bs, hs] - want_l).abs().max().item()
        check(e <= lse_tol, f"{tag} lse {bs} {hs}: max|err| {e:.3e}")
        err_l = max(err_l, e)
        del want_o, want_l
    # batch row 0 keeps the cls key alone: every row's out is v[cls]
    check(bool(torch.allclose(
        got_o[0].float(), v[0, :, :1].float().expand_as(got_o[0]),
        atol=1e-6)), f"{tag}: a cls-only row is not v[cls]")
    return err_o, err_l, got_o, got_l


def phase_k4(device, shapes=K4_SHAPES, iters=10):
    """K4f against its plain version, fp32 and bf16 (the plain version in
    fp32 on the same values), whole or slice by slice, in bf16 also on a
    mask with dead key tiles between live ones, and two runs bit-equal;
    times in bf16 of the kernel, the plain version and one
    ``scaled_dot_product_attention`` call with the dense bias built
    beforehand (its build is not timed; it returns no lse). Returns
    {name: result dict}."""
    import torch
    import torch.nn.functional as F
    af = importlib.import_module("modaltune_tpu_torch.ops.alibi_flash")
    results = {}
    for i, (name, b, h, n, d, chunk) in enumerate(shapes):
        res = {}
        scale = d ** -0.5
        for dtype, out_tol, lse_tol in ((torch.float32, 2e-4, 1e-4),
                                        (torch.bfloat16, 1.6e-2, 1e-2)):
            tensors = k4_inputs(b, h, n, d, dtype, device, seed=400 + i)
            q, k, v, _, coords3, slopes, key_mask = tensors
            tag = f"K4 {name} {str(dtype)[6:]}"
            err_o, err_l, got_o, got_l = k4_forward_errors(
                af, tensors, chunk, out_tol, lse_tol, tag)
            res[str(dtype)[6:]] = dict(out_err=err_o, lse_err=err_l)
            if dtype == torch.bfloat16:
                again = af.alibi_flash_attention_cuda(
                    q, k, v, coords3, slopes, key_mask, scale)
                check(torch.equal(again[0], got_o)
                      and torch.equal(again[1], got_l),
                      f"{tag}: two runs are not bit-equal")
                del again
                # the plain version's time on the bf16 tensors the kernel
                # gets: the sum over its slices, the first one warmed up
                def plain(bs, hs):
                    return af.alibi_attention_reference(
                        q[bs, hs], k[bs, hs], v[bs, hs], coords3[bs],
                        slopes[hs], key_mask[bs])
                plain(*k4_slices(b, h, chunk)[0])
                res["plain_ms"] = sum(
                    timed_once(lambda: plain(bs, hs))[1]
                    for bs, hs in k4_slices(b, h, chunk))
                res["ms"] = time_ms(lambda: af.alibi_flash_attention_cuda(
                    q, k, v, coords3, slopes, key_mask, scale), iters,
                    warmup=1)
                res["bound_ms"], res["bound_by"] = attention_bound(
                    float(h * n * int(key_mask.sum())), d,
                    (q, k, v, coords3, slopes, key_mask, got_o, got_l),
                    backward=False)
                del got_o, got_l
                torch.cuda.empty_cache()
                dense = dense_alibi_bias(coords3, slopes, key_mask, dtype)
                res["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=dense), iters, warmup=1)
                del dense
                # dead key tiles between live ones
                holes = k4_inputs(b, h, n, d, dtype, device, seed=450 + i,
                                  holes=True)
                res["holes"] = dict(zip(("out_err", "lse_err"),
                                        k4_forward_errors(
                    af, holes, chunk, out_tol, lse_tol, f"{tag} holes")[:2]))
                res["holes"]["live_tiles"] = af.live_key_tiles(
                    af.padded_key_mask(holes[6], b, n, device)).sum(
                        dim=-1).tolist()
                del holes
            torch.cuda.empty_cache()
        print(f"K4 {name} B={b} H={h} N={n} D={d} (plain version in "
              f"{len(k4_slices(b, h, chunk))} slice(s)): "
              f"fp32 out {res['float32']['out_err']:.3e} "
              f"lse {res['float32']['lse_err']:.3e} | "
              f"bf16 out {res['bfloat16']['out_err']:.3e} "
              f"lse {res['bfloat16']['lse_err']:.3e}, two runs bit-equal | "
              f"bf16 with dead tiles between live ones (live 64-key tiles "
              f"per batch row {res['holes']['live_tiles']} of "
              f"{-(-n // 64)}) out {res['holes']['out_err']:.3e} lse "
              f"{res['holes']['lse_err']:.3e} | "
              f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
              f"library (SDPA with a dense bias, no lse) "
              f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.5f} ms "
              f"({res['bound_by']})", flush=True)
        print(f"K4 {name}: kernel / library = "
              f"{res['ms'] / res['library_ms']:.3f}", flush=True)
        results[name] = res
    return results


def k4_backward_errors(af, tensors, chunk, tol, dtype_name, tag,
                       time_plain=False):
    """K4b on ``tensors`` (as ``k4_inputs`` returns them) from K4f's out and
    lse against the plain version, slice by slice; fails over a limit.
    Returns a dict of the readings, the kernel's gradients, out and lse."""
    import torch
    q, k, v, dout, coords3, slopes, key_mask = tensors
    b, h, _, d = q.shape
    scale = d ** -0.5
    out, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes,
                                             key_mask, scale)
    got = af.alibi_flash_attention_backward_cuda(
        q, k, v, coords3, slopes, key_mask, out, lse, dout, scale)
    torch.cuda.synchronize()
    err = bound = plain_ms = rel = row = 0.0
    for n_done, (bs, hs) in enumerate(k4_slices(b, h, chunk)):
        def plain(cast=torch.Tensor.float):
            return af.alibi_attention_backward_reference(
                cast(q[bs, hs]), cast(k[bs, hs]), cast(v[bs, hs]),
                coords3[bs], slopes[hs], key_mask[bs],
                cast(out[bs, hs]), lse[bs, hs], cast(dout[bs, hs]))
        want = plain()
        for gn, gt, wt in zip(("dq", "dk", "dv"), got, want):
            e = compare(gt[bs, hs], wt, tol, f"{tag} {gn} {bs} {hs}")
            if e > err:     # the worst gradient and its bound
                err, bound = e, tol * max(1.0, wt.abs().max().item())
        # per slice and per tensor, against the slice's own norms
        rel, row = map(max, (rel, row), check_grads(
            ("dq", "dk", "dv"), [gt[bs, hs] for gt in got], want,
            dout[bs, hs], dtype_name, f"{tag} {bs} {hs}"))
        del want
        if time_plain:
            if n_done == 0:
                plain(lambda t: t)
            plain_ms += timed_once(lambda: plain(lambda t: t))[1]
    check(all(bool((gt[0, :, 1:] == 0).all()) for gt in got[1:]),
          f"{tag}: masked keys of the cls-only row have non-zero dk or dv")
    dead = ~key_mask
    check(all(bool((gt.transpose(1, 2)[dead] == 0).all()) for gt in got[1:]),
          f"{tag}: a masked key has non-zero dk or dv")
    return (dict(err=err, bound=bound, rel=rel, row=row, plain_ms=plain_ms),
            got, out, lse)


def phase_k4b(device, shapes=K4_SHAPES, iters=10):
    """K4b against its plain version from the same out and lse (K4f's),
    fp32 and bf16, whole or slice by slice, in bf16 also on a mask with
    dead key tiles between live ones, and two runs bit-equal; times in
    bf16 of the kernel, the plain version and autograd through one
    ``scaled_dot_product_attention`` call with the dense bias. Returns
    {name: result dict}."""
    import torch
    import torch.nn.functional as F
    af = importlib.import_module("modaltune_tpu_torch.ops.alibi_flash")
    results = {}
    for i, (name, b, h, n, d, chunk) in enumerate(shapes):
        res = {}
        scale = d ** -0.5
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            tensors = k4_inputs(b, h, n, d, dtype, device, seed=500 + i)
            q, k, v, dout, coords3, slopes, key_mask = tensors
            dt = str(dtype)[6:]
            tag = f"K4b {name} {dt}"
            r, got, out, lse = k4_backward_errors(
                af, tensors, chunk, tol, dt, tag,
                time_plain=dtype == torch.bfloat16)
            res[dt], res[dt + "_bound"] = r["err"], r["bound"]
            res[dt + "_rel"], res[dt + "_row"] = r["rel"], r["row"]
            if dtype == torch.bfloat16:
                def kernel():
                    return af.alibi_flash_attention_backward_cuda(
                        q, k, v, coords3, slopes, key_mask, out, lse, dout,
                        scale)
                check(all(torch.equal(x, y) for x, y in zip(kernel(), got)),
                      f"{tag}: two runs are not bit-equal")
                res["plain_ms"] = r["plain_ms"]
                res["ms"] = time_ms(kernel, iters, warmup=1)
                res["bound_ms"], res["bound_by"] = attention_bound(
                    float(h * n * int(key_mask.sum())), d,
                    (q, k, v, coords3, slopes, key_mask, out, lse, dout,
                     *got), backward=True)
                del got
                torch.cuda.empty_cache()
                dense = dense_alibi_bias(coords3, slopes, key_mask, dtype)
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves,
                                                         attn_mask=dense)
                res["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, dout, retain_graph=True), iters,
                    warmup=1)
                del dense, leaves, lib_out
                # dead key tiles between live ones
                holes = k4_inputs(b, h, n, d, dtype, device, seed=550 + i,
                                  holes=True)
                res["holes"] = k4_backward_errors(
                    af, holes, chunk, tol, dt, f"{tag} holes")[0]
                del holes
            del tensors, q, k, v, dout, out, lse
            torch.cuda.empty_cache()
        print(f"K4b {name} B={b} H={h} N={n} D={d}: fp32 dq/dk/dv "
              f"{res['float32']:.3e} (bound {res['float32_bound']:.2e}), "
              f"rel-L2 {res['float32_rel']:.3e}, row-scaled "
              f"{res['float32_row']:.3e} | bf16 {res['bfloat16']:.3e} (bound "
              f"{res['bfloat16_bound']:.2e}), rel-L2 "
              f"{res['bfloat16_rel']:.3e}, row-scaled "
              f"{res['bfloat16_row']:.3e}, two runs bit-equal | bf16 with "
              f"dead tiles between live ones rel-L2 "
              f"{res['holes']['rel']:.3e}, row-scaled "
              f"{res['holes']['row']:.3e} | kernel {res['ms']:.4f} ms, "
              f"plain {res['plain_ms']:.4f} ms, library (autograd through "
              f"SDPA with a dense bias) {res['library_ms']:.4f} ms, bound "
              f"{res['bound_ms']:.5f} ms ({res['bound_by']})", flush=True)
        print(f"K4b {name}: kernel / library = "
              f"{res['ms'] / res['library_ms']:.3f}", flush=True)
        results[name] = res
    return results


# ---------------------------------------------------------------------------
# The slice: ModalTune-GigaPath embed step
# ---------------------------------------------------------------------------

# What differs between the two models' paths; everything else is shared.
# ``config`` names the model configuration's factory in the port's
# ``configs`` module; ``grid`` says that bags are grid-scattered first.
GIGAPATH = dict(name="longnetvit_gene_adapter",
                config="gigapath_modaltune_config", grid=False,
                in_chans=1536, bag_range=(9000, 10239), bucket=10239)
GIGAPATH_2047 = dict(bucket=2047, bag_range=(1791, 2047))
# the reference's own geometry: the CLI's --threshold 25000 and default
# buckets put a real cohort's bags in the 25,599 bucket (bench.py:38-41)
GIGAPATH_25599 = dict(bucket=25599, bag_range=(24000, 25599))
# the same model, slides and weights on its other kernel routes
GIGAPATH_FUSED = dict(GIGAPATH, route="fused")
GIGAPATH_BRANCH = dict(GIGAPATH, route="branch")
# ModalTune-GigaPath with the LoRA encoder variant (every layer's attention
# per branch on K2, LoRA B nonzero), the same slides
GIGAPATH_LORA = dict(GIGAPATH, route="lora")
# SyntheticSlideDataset draws patch coordinates on a 900 x 900 lattice of
# 256-px tiles, a 225 x 225 grid of TITAN's 1,024-px cells: 17,000-19,500
# patches scatter to about 14,400-16,200 foreground cells, inside the
# 16,383-cell bucket (checked in ``build_batches``).
TITAN = dict(name="titan_gene_adapter", config="TitanModalTuneConfig",
             grid=True, in_chans=768, bag_range=(17000, 19500), bucket=16383)
# the buckets the plain path fits: ~3,400-4,030 and ~1,670-2,010 cells
TITAN_4095 = dict(bucket=4095, bag_range=(3500, 4200))
TITAN_2047 = dict(bucket=2047, bag_range=(1700, 2050))


def synthetic_packer(n_genes=4987, n_groups=331, max_size=100):
    """The gene packer of a synthetic pathway table."""
    from modaltune_tpu_torch.data import GenePacker, synthetic_pathways
    groups = synthetic_pathways(n_genes=n_genes, n_groups=n_groups,
                                max_size=max_size, seed=0)
    return GenePacker.build(groups, [f"g{i}" for i in range(n_genes)])


def model_config(config):
    """The model configuration that the factory ``config`` of the port's
    ``configs`` module makes."""
    return getattr(importlib.import_module("modaltune_tpu_torch.configs"),
                   config)()


def build_batches(name, config, grid, in_chans, bag_range, bucket,
                  n_genes=4987, n_groups=331, max_size=100, n_slides=3,
                  seed=0, route=None, cfg=None, batch_size=1):
    """The host batches of ``n_slides`` synthetic slides padded to
    ``bucket`` (grid-scattered first where ``grid``), ``batch_size`` a
    batch, through the port's data layer; the same on either ``route`` of
    the model. ``cfg`` overrides the factory's configuration, as in
    :func:`build_model`."""
    from modaltune_tpu_torch.data import (BucketedLoader,
                                          SyntheticSlideDataset,
                                          TitanGridDataset)
    ds = SyntheticSlideDataset(
        n_cases=n_slides, in_chans=in_chans, bag_range=bag_range,
        packer=synthetic_packer(n_genes, n_groups, max_size),
        n_genes=n_genes, seed=seed)
    if grid:
        cfg = model_config(config) if cfg is None else cfg
        ds = TitanGridDataset(ds, cfg.backbone.patch_size_lv0)
    # a bag over the bucket would be cut: every slide must fit it whole (a
    # bag over the dataset's threshold comes out cut to it, as the loader
    # cuts it)
    import numpy as np
    lengths = [ds.get(i, np.random.RandomState(0)).bag.shape[0]
               for i in range(n_slides)]
    check(max(lengths) <= bucket,
          f"{name}: bags of {lengths} tokens do not fit the {bucket} bucket")
    return list(BucketedLoader(ds, buckets=(bucket,), batch_size=batch_size,
                               shuffle=False, prefetch=0,
                               device_prefetch=False))


def route_kw(cfg, route):
    """``create_aggregator``'s keywords for a kernel route of the LongNet
    backbone: None is the default (K1, the unfused FFN chain), "fused" the
    per-branch attention kernels (K3) and the fused GELU -> LayerNorm (K5),
    "branch" the per-branch dilated attention with each branch on the K2
    flash kernels (``fused_attention`` off, the CLI's ``--fused_attention
    0``) and the unfused FFN chain, "lora" the LoRA encoder variant
    (``lora_adapter``: per-modality LoRA deltas on q/k/v around the same
    per-branch attention)."""
    if route is None:
        return {}
    check(route in ("fused", "branch", "lora"), f"unknown route {route!r}")
    if route == "branch":
        return dict(longnet=cfg.backbone.longnet(fused_attention=False))
    if route == "lora":
        return dict(longnet=cfg.backbone.longnet(lora_adapter=True))
    return dict(longnet=cfg.backbone.longnet(mega_attention=False),
                fused_gelu_ln=True)


def build_model(device, name, config, n_genes=4987, n_groups=331,
                max_size=100, seed=0, route=None, cfg=None, **_data_kw):
    """The model ``name`` on ``device`` through the public entry points:
    random fp32 weights from ``seed`` (the same on every ``route``),
    Injector gammas non-zero, on the LoRA route the LoRA B matrices too.
    ``cfg`` overrides the factory's configuration (a narrow one, to
    rehearse on the CPU)."""
    import torch
    from modaltune_tpu_torch import create_aggregator, init_weights
    from modaltune_tpu_torch.models import fill_normal_
    packer = synthetic_packer(n_genes, n_groups, max_size)
    cfg = model_config(config) if cfg is None else cfg
    model = create_aggregator(name, device=device, cfg=cfg,
                              n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len,
                              **route_kw(cfg, route))
    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    with torch.no_grad():   # init_values = 0 would make the Injectors no-ops
        for block in model.interactions:
            fill_normal_(block.injector.gamma, 0.1, g)
        lora_b_nonzero(model, g)
    return model


def lora_b_nonzero(model, g, std=0.02) -> int:
    """Every LoRA B matrix of ``model`` drawn from N(0, ``std``) on ``g``
    (they start at zero, which would make the deltas vanish); -> how many."""
    import torch
    from modaltune_tpu_torch.models import fill_normal_
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "_lora_B_" in name:
                fill_normal_(p, std, g)
                n += 1
    return n


def build_slice(device, dtype, **data_kw):
    """Model in ``dtype``, embed step and the slides' batches on
    ``device``; ``data_kw`` goes to :func:`build_model` and
    :func:`build_batches`."""
    from modaltune_tpu_torch import make_embed_step
    from modaltune_tpu_torch.configs import TrainConfig
    from modaltune_tpu_torch.train import batch_to_device
    model = build_model(device, **data_kw).to(dtype=dtype).eval()
    batches = [batch_to_device(b, device) for b in build_batches(**data_kw)]
    return model, make_embed_step(model, TrainConfig()), batches


def plain_kernels():
    """Patch the models' kernel entry points with their plain versions (a
    comparison path of this script only); autograd differentiates them."""
    from modaltune_tpu_torch.ops.alibi_flash import alibi_attention_reference
    from modaltune_tpu_torch.ops.dilated import dilated_attention
    from modaltune_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from modaltune_tpu_torch.ops.gelu_ln import gelu_ln_reference

    def plain_alibi(q, k, v, coords3, slopes, key_mask=None, scale=None):
        return alibi_attention_reference(q, k, v, coords3, slopes, key_mask,
                                         scale)[0]

    return [mock.patch("modaltune_tpu_torch.models.longnet."
                       "mega_dilated_attention", dilated_attention),
            mock.patch("modaltune_tpu_torch.models.longnet."
                       "fused_dilated_attention", dilated_attention),
            mock.patch("modaltune_tpu_torch.models.longnet.gelu_ln",
                       gelu_ln_reference),
            mock.patch("modaltune_tpu_torch.models.layers.flash_attention",
                       flash_attention_reference),
            mock.patch("modaltune_tpu_torch.ops.dilated.flash_attention",
                       flash_attention_reference),
            mock.patch("modaltune_tpu_torch.models.titan."
                       "alibi_flash_attention", plain_alibi)]


def run_plain(fn):
    """``fn()`` with every kernel entry point patched to its plain
    version."""
    patches = plain_kernels()
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in patches:
            p.stop()


def phase_slice(device, dtype, build_kw=None, timing_rounds=3, card="",
                tag="slice", compare_kw=None, agree_with=None):
    """The full-width embed step on the slides of ``build_kw``: shapes,
    finite values and the launch counts of the main path (per LongNet
    layer K1f or, on the fused route, K3f and K5f; K4f once per TITAN
    block; K2f once per adapter attention; no backward kernel); the
    embeddings against the plain path, on slide 0, or where the plain path
    does not fit the bucket on a slide of ``compare_kw``'s bucket and bag
    range; against ``agree_with``, another route's embeddings of the same
    slides from the same weights; ms/slide and peak memory."""
    import torch
    from modaltune_tpu_torch.train import batch_to_device
    build_kw = build_kw or GIGAPATH
    t0 = time.perf_counter()
    model, step, batches = build_slice(device, dtype, **build_kw)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag}: model built in {time.perf_counter() - t0:.1f} s, "
          f"{n_params} parameters, {len(batches)} slides of bucket "
          f"{batches[0]['bag'].shape[1]} with "
          f"{[int(b['mask'].sum()) for b in batches]} valid tokens",
          flush=True)

    # the main path: every launch count starts at 0 just before it
    reset_counts()
    outs = [step(b) for b in batches]
    torch.cuda.synchronize()
    launches = read_counts()
    check_k5_routes(tag, launches)
    k2_families = check_k2_families(
        tag, launches, k2_branch_calls(model) * len(batches))
    families = check_dilated_families(tag, launches, dtype)
    per = calls_per_forward(model)
    for i, out in enumerate(outs):
        check(tuple(out.shape) == (1, 3, model.cfg.adapter.output_dim),
              f"{tag} slide {i}: embedding shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()),
              f"{tag} slide {i}: non-finite embedding")
    want = {f"{k}{d}": n * (d == "f") for k, n in per.items() for d in "fb"}
    check(launches == {k: n * len(batches) for k, n in want.items()},
          f"{tag}: launch counts {launches} != {want} per slide")
    print(f"{tag}: {len(outs)} embeddings {tuple(outs[0].shape)} finite; "
          f"launches per slide "
          f"{', '.join(f'{k}f {n}' for k, n in per.items())} "
          f"(total {launches})", flush=True)

    def agreement(a, b):
        a, b = a.float().flatten(), b.float().flatten()
        return (torch.nn.functional.cosine_similarity(a, b, dim=0).item(),
                ((a - b).norm() / b.norm()).item())

    # the same slides and weights through another route's kernels
    if agree_with is not None:
        readings = [agreement(o, w.to(device))
                    for o, w in zip(outs, agree_with)]
        worst_cos = min(c for c, _ in readings)
        worst_rel = max(r for _, r in readings)
        print(f"{tag}: embeddings against the default route's, worst of "
              f"{len(outs)} slides: cosine {worst_cos:.6f}, rel-L2 "
              f"{worst_rel:.3e}", flush=True)
        check(worst_cos >= 0.999 and worst_rel <= 2e-2,
              f"{tag} vs the default route: cosine {worst_cos:.6f}, rel-L2 "
              f"{worst_rel:.3e}")

    # one slide through the kernels and through the plain versions
    if compare_kw is None:
        batch, got = batches[0], outs[0]
    else:
        (host,) = build_batches(**{**build_kw, **compare_kw}, n_slides=1)
        batch = batch_to_device(host, device)
        got = step(batch)
    plain = run_plain(lambda: step(batch))
    torch.cuda.synchronize()
    cos, rel = agreement(got, plain)
    print(f"{tag}: kernel vs plain embeddings of a slide at bucket "
          f"{batch['bag'].shape[1]}: cosine {cos:.6f}, rel-L2 {rel:.3e}",
          flush=True)
    check(cos >= 0.999 and rel <= 2e-2,
          f"{tag} kernel vs plain embeddings: cosine {cos:.6f}, rel-L2 "
          f"{rel:.3e}")
    del plain, got
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timing_rounds):
        for bt in batches:
            t = time.perf_counter()
            step(bt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: embed step {ms:.2f} ms/slide median of {len(times)} "
          f"({1e3 / ms:.3f} slides/s), peak allocated {peak / 2**30:.3f} GiB"
          f"{'; ' + card if card else ''}", flush=True)
    return dict(launches=launches, cosine=cos, rel_l2=rel, ms=ms,
                peak_bytes=peak, per_slide=per, k2_families=k2_families,
                families=families, outs=[o.detach().cpu() for o in outs])


# Trainable tensors whose gradient is exactly zero in exact arithmetic and
# rounding noise in practice: attention key biases (softmax is shift
# invariant) and the gene mixer's per-token biases (a constant over
# channels, which every later LayerNorm removes).
NULL_GRAD = ("k_proj.bias", "token.b2", "compress_bias")


def build_train(device, seed=0, frozen="bfloat16", **data_kw):
    """The train step's model (frozen backbone in ``frozen``, bf16 unless
    given: the steps then autocast to it; trainable adapter in fp32),
    optimizer, projected text targets and batch on ``device``; ``data_kw``
    goes to :func:`build_model` and :func:`build_batches` (one slide unless
    it names ``n_slides``, in batches of its ``batch_size``)."""
    import torch
    from modaltune_tpu_torch import (TextProjector, freeze_backbone,
                                     init_weights, make_optimizer,
                                     project_text)
    from modaltune_tpu_torch.configs import TrainConfig
    from modaltune_tpu_torch.train import batch_to_device
    model = build_model(device, seed=seed, **data_kw)
    (host,) = build_batches(**{"n_slides": 1, **data_kw}, seed=seed)
    tcfg = TrainConfig()
    opt = make_optimizer(tcfg, freeze_backbone(model, getattr(torch, frozen)),
                         steps_per_epoch=1)
    projector = init_weights(TextProjector(),
                             torch.Generator().manual_seed(seed + 99))
    projector = projector.to(device).requires_grad_(False)
    text = project_text(projector, torch.from_numpy(host.text).to(device))
    return model, tcfg, opt, text, batch_to_device(host, device)


def k2_call_readings(fn, tag):
    """``(fn(), readings)``: every K2f and K2b launch while ``fn()`` runs
    held to its plain version on the same inputs, computed in fp32 on the
    same bf16 values (the plain versions turn autocast off, which the
    train step's forward runs under): out by :func:`check_out`, lse
    within :data:`K2_LSE_LIMIT`, dq, dk and dv by :func:`check_grads`, at
    the bf16 limits. readings: by family, the launches and the worst
    (rel-L2, row-scaled) of out and of the gradients, and lse's largest
    max|err|."""
    fa = importlib.import_module(COUNTERS["K2f"][0])
    fwd, bwd = fa.flash_attention_cuda, fa.flash_attention_backward_cuda
    seen = {}

    def note(q, k, key, r):
        fam = fa.card_family(q.shape[1], k.shape[1], q.shape[2], q.dtype)
        got = seen.setdefault(fam, dict(fwd=0, bwd=0, out=(0.0, 0.0),
                                        grads=(0.0, 0.0), lse=0.0))
        if key == "lse":
            got["lse"] = max(got["lse"], r)
            return
        got[key] = tuple(map(max, got[key], r))
        got["fwd" if key == "out" else "bwd"] += 1

    def fwd_read(q, k, v, bias, scale):
        out, lse = fwd(q, k, v, bias, scale)
        want_o, want_l = fa.flash_attention_reference(
            q.float(), k.float(), v.float(), bias, scale)
        what = f"{tag}: K2f {tuple(q.shape)} x {k.shape[1]} keys"
        note(q, k, "out", check_out(out, want_o, "bfloat16", what))
        err = (lse - want_l).abs().max().item()
        check(err <= K2_LSE_LIMIT, f"{what} lse: max|err| {err:.3e}")
        note(q, k, "lse", err)
        return out, lse

    def bwd_read(q, k, v, bias, out, lse, dout, scale):
        got = bwd(q, k, v, bias, out, lse, dout, scale)
        want = fa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), bias, out.float(), lse,
            dout.float(), scale)
        note(q, k, "grads", check_grads(
            ("dq", "dk", "dv"), got, want, dout, "bfloat16",
            f"{tag}: K2b {tuple(q.shape)} x {k.shape[1]} keys"))
        return got

    with mock.patch.object(fa, "flash_attention_cuda", fwd_read), \
            mock.patch.object(fa, "flash_attention_backward_cuda", bwd_read):
        result = fn()
    w = seen.get("wgmma", {})
    check(w.get("fwd", 0) > 0 and w.get("bwd", 0) > 0,
          f"{tag}: no wgmma K2 launch to hold in the grad step")
    for fam, r in seen.items():
        print(f"{tag}: the bf16 grad step's {fam} K2 launches held to the "
              f"plain version on the same inputs: {r['fwd']} K2f, worst "
              f"out rel-L2 {r['out'][0]:.3e}, "
              f"row-scaled {r['out'][1]:.3e}, lse max|err| {r['lse']:.3e}; "
              f"{r['bwd']} K2b, worst gradient rel-L2 {r['grads'][0]:.3e}, "
              f"row-scaled {r['grads'][1]:.3e}", flush=True)
    return result, seen


def timed_build(device, tag, build_kw):
    """:func:`build_train` of ``build_kw``, its time and sizes printed."""
    import torch
    t0 = time.perf_counter()
    model, tcfg, opt, text, batch = build_train(device, **build_kw)
    torch.cuda.synchronize()
    params = list(model.parameters())
    print(f"{tag}: model built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in params if p.requires_grad)} trainable "
          f"fp32 and {sum(p.numel() for p in params if not p.requires_grad)}"
          f" frozen {str(next(model.backbone.parameters()).dtype)[6:]} "
          f"parameters, {batch['bag'].shape[0]} slide(s) of "
          f"bucket {batch['bag'].shape[1]} with "
          f"{batch['mask'].sum(1).tolist()} valid tokens", flush=True)
    return model, tcfg, opt, text, batch


def drive_train(device, model, tcfg, opt, text, batch, tag, card="",
                steps=3, timed_steps=5):
    """A train step's main path on ``model``: ``steps`` steps with the
    launch counts checked (per LongNet layer K1f and K1b or, on the fused
    route, K3f, K3b, K5f and K5b; K4f and K4b once per TITAN block; K2f and
    K2b once per adapter attention; and the forward kernels that the
    backward's remat runs again, :func:`recomputed_per_step`), loss
    finite, trainable parameters moved, frozen backbone bit-identical;
    then ms/step (median) and peak memory over ``timed_steps`` (and the
    bytes allocated before them: weights, optimizer state, batch), and the
    time Python's garbage collector ran in those steps (``gc_ms``, the
    median a step, :func:`gc_timer`)."""
    import torch
    from modaltune_tpu_torch import make_train_step
    step = make_train_step(model, tcfg, opt)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    gen = torch.Generator(device=device).manual_seed(1)

    # the main path: every launch count starts at 0 just before it
    reset_counts()
    losses = [float(step(batch, text, gen)) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = read_counts()
    again = recomputed_per_step(model)
    frozen_dtype = next(model.backbone.parameters()).dtype
    check_k5_routes(tag, launches, fp32=frozen_dtype == torch.float32)
    k2_families = check_k2_families(tag, launches,
                                    k2_branch_calls(model) * steps,
                                    again.get("K2", 0) * steps,
                                    fp32=frozen_dtype == torch.float32)
    families = check_dilated_families(tag, launches, frozen_dtype)
    per = calls_per_forward(model)
    per_step = {f"{k}{d}": n + (again.get(k, 0) if d == "f" else 0)
                for k, n in per.items() for d in "fb"}
    check(launches == {k: n * steps for k, n in per_step.items()},
          f"{tag} launch counts {launches} != {per_step} per step x {steps}")
    check(all(math.isfinite(x) for x in losses), f"{tag} losses {losses}")
    # every trainable tensor moves, except perhaps the NULL_GRAD ones
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p.detach(), before[n])]
    check(all(n.endswith(NULL_GRAD) for n in still),
          f"{tag}: trainable tensors did not move: {still}")
    n_trainable, moved = len(before), len(before) - len(still)
    check(all(torch.equal(p.detach(), frozen[n])
              for n, p in model.named_parameters() if not p.requires_grad),
          f"{tag}: the frozen backbone changed")
    del frozen, before
    enc = getattr(model.backbone, "encoder", None)
    remat = ("off" if enc is None or not enc.cfg.remat
             else f"{enc.cfg.remat_policy!r}")
    print(f"{tag}: {steps} steps, losses {[round(x, 6) for x in losses]}, "
          f"launches per step {per_step} (remat {remat}; run again in the "
          f"backward {again}); {moved} of {n_trainable} trainable "
          f"tensors moved, backbone bit-identical", flush=True)

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, in_gc = [], []
    with gc_timer() as collector:
        for _ in range(timed_steps):
            before = collector["ms"]
            t = time.perf_counter()
            step(batch, text, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            in_gc.append(collector["ms"] - before)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: step {ms:.2f} ms median of {len(times)} "
          f"({[round(x, 2) for x in times]}), peak allocated "
          f"{peak / 2**30:.3f} GiB; Python's garbage collector "
          f"{statistics.median(in_gc):.2f} ms a step, median "
          f"({[round(x, 2) for x in in_gc]}; {collector['collections']} "
          f"collections, {collector['gen2']} of generation 2)"
          f"{'; ' + card if card else ''}", flush=True)
    return dict(launches=launches, per_step=per_step, ms=ms, peak_bytes=peak,
                base_bytes=base, losses=losses, k2_families=k2_families,
                families=families, times=times,
                gc_ms=statistics.median(in_gc), gc_times=in_gc)


def phase_train(device, steps=3, timed_steps=5, compare_kw=None,
                card="", build_kw=None, tag="train", k2_calls=False):
    """The full-width train step: :func:`drive_train`'s ``steps`` checked
    steps and ``timed_steps`` timed ones; then the step's loss and
    adapter gradients against the plain path at ``compare_kw``'s bucket
    (2,047 unless given), where the plain path's saved scores fit (about
    12 x 0.67 GB for LongNet at 2,047): in bf16 as a whole (gradient
    cosine, loss, and the worst tensor's rel-L2 from the fp32 plain path
    within 2x the bf16 plain path's worst), and in fp32 each gradient
    tensor on its own. With ``k2_calls`` (the per-branch route, whose
    attention is 70 K2 calls a step) every K2 launch of the bf16 grad step
    is also held to its plain version on the same inputs
    (:func:`k2_call_readings`)."""
    import torch
    from modaltune_tpu_torch import make_grad_step
    build_kw = build_kw or GIGAPATH
    compare_kw = compare_kw or GIGAPATH_2047
    compare_bucket = compare_kw["bucket"]
    model, tcfg, opt, text, batch = timed_build(device, tag, build_kw)
    res = drive_train(device, model, tcfg, opt, text, batch, tag, card,
                      steps, timed_steps)
    del model, opt, batch
    torch.cuda.empty_cache()

    # kernel path vs plain path, one grad step each from the same weights
    # and the same dropout bits, at a bucket where the plain path fits: in
    # bf16 as the step trains, and in fp32 (the backbone cast up, so no
    # autocast), where rounding is small enough to hold each tensor alone
    model, tcfg, _, text, batch = build_train(
        device, **{**build_kw, **compare_kw})
    model32 = copy.deepcopy(model)
    model32.backbone.float()
    runs, held = {}, None
    for dt, m in (("bf16", model), ("fp32", model32)):
        for plain in (False, True):
            def grad_step(m=m):
                gen = torch.Generator(device=device).manual_seed(2)
                loss, grads = make_grad_step(m, tcfg)(batch, text, gen)
                torch.cuda.synchronize()
                return float(loss), {n: g.float().flatten()
                                     for n, g in grads.items()}
            if plain:
                runs[dt, plain] = run_plain(grad_step)
            elif dt == "bf16" and k2_calls:
                runs[dt, plain], held = k2_call_readings(grad_step, tag)
            else:
                runs[dt, plain] = grad_step()
    (loss_k, g_k), (loss_p, g_p) = runs["bf16", False], runs["bf16", True]
    (loss_k32, g_k32), (loss_32, g_32) = (runs["fp32", False],
                                          runs["fp32", True])
    cos = torch.nn.functional.cosine_similarity(
        torch.cat(list(g_k.values())), torch.cat([g_p[n] for n in g_k]),
        dim=0).item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    rel32 = abs(loss_k32 - loss_32) / abs(loss_32)
    g_all = max(g.abs().max().item() for g in g_32.values())

    def rel_l2(g, want):
        return ((g - want).norm() / want.norm()).item()

    # fp32, each tensor on its own: rel-L2 of kernel vs plain; the NULL_GRAD
    # tensors, whose gradient is rounding noise, by max|kernel - plain| /
    # g_all. bf16: each tensor's rel-L2 from the fp32 plain path, the
    # kernel path's worst against the bf16 plain path's worst
    err32, null32, e_k, e_p = {}, {}, {}, {}
    for n, g in g_k32.items():
        if n.endswith(NULL_GRAD):
            null32[n] = (g - g_32[n]).abs().max().item() / g_all
            continue
        err32[n] = rel_l2(g, g_32[n])
        e_k[n], e_p[n] = rel_l2(g_k[n], g_32[n]), rel_l2(g_p[n], g_32[n])
    w32, wnull = max(err32, key=err32.get), max(null32, key=null32.get)
    wk, wp = max(e_k, key=e_k.get), max(e_p, key=e_p.get)
    print(f"{tag}: kernel vs plain at bucket {compare_bucket}, bf16: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel:.3e}); adapter gradients "
          f"cosine {cos:.6f}; largest per-tensor rel-L2 from the fp32 plain "
          f"path {e_k[wk]:.3e} ({wk}) vs {e_p[wp]:.3e} plain ({wp})",
          flush=True)
    print(f"{tag}: kernel vs plain at bucket {compare_bucket}, fp32: loss "
          f"rel {rel32:.3e}; largest rel-L2 of a tensor (of {len(err32)}) "
          f"{err32[w32]:.3e} ({w32}); {len(null32)} NULL_GRAD tensors "
          f"{NULL_GRAD}: largest max|kernel - plain| / max|g| "
          f"{null32[wnull]:.3e} ({wnull}), max|g| {g_all:.3e}", flush=True)
    check(cos >= 0.999 and rel <= 1e-2
          and e_k[wk] <= 2 * e_p[wp]
          and rel32 <= 1e-5 and err32[w32] <= 1e-4 and null32[wnull] <= 1e-4,
          f"{tag} kernel vs plain: bf16 gradient cosine {cos:.6f}, loss rel "
          f"{rel:.3e}, worst tensor {e_k[wk]:.3e} vs {e_p[wp]:.3e} plain; "
          f"fp32 loss rel {rel32:.3e}, worst tensor {w32} {err32[w32]:.3e}, "
          f"NULL_GRAD max|err| / max|g| {null32[wnull]:.3e}")
    return dict(res, grad_cosine=cos, loss_rel=rel,
                grad_rel_fp32=err32[w32], worst_tensor=(e_k[wk], e_p[wp]),
                k2_calls=held)


def k5_fp32_readings(device, shape=(30720, 3072), eps=1e-5, iters=10):
    """K5's generic kernels in fp32 (an fp32 backbone's fused FFN) against
    their plain versions at ``shape`` (3 tasks x 10,240 tokens, ffn 3072):
    K5f within :func:`phase_k5`'s fp32 bound, K5b without dgamma/dbeta (the
    train step's variant) by :func:`check_grads`' fp32 limits; both on the
    generic route, and their times on both clocks."""
    import torch
    gl = importlib.import_module(COUNTERS["K5f"][0])
    x, dy, scale, bias = k5_inputs(shape, device, torch.float32, seed=13)
    rows = (gl.ROWS_LAUNCHES, gl.BWD_ROWS_LAUNCHES)

    def fwd():
        return gl.gelu_ln_cuda(x, scale, bias, eps)

    def bwd():
        return gl.gelu_ln_backward_cuda(x, scale, dy, eps,
                                        param_grads=False)[0]
    r = dict(out_err=compare(fwd(), gl.gelu_ln_reference(x, scale, bias,
                                                         eps), 2e-5,
                             "K5f fp32"))
    r["dx_rel"], r["dx_row"] = check_grads(
        ("dx",), (bwd(),), gl.gelu_ln_backward_reference(x, scale, dy,
                                                         eps)[:1],
        dy, "float32", "K5b fp32")
    check((gl.ROWS_LAUNCHES, gl.BWD_ROWS_LAUNCHES) == rows,
          "K5 fp32 took the row-resident kernels")
    for key, fn in (("fwd", fwd), ("bwd", bwd)):
        r[key + "_ms"] = time_ms(fn, iters)
        r[key + "_device_ms"] = device_ms(fn, iters=3, warmup=1)
    print(f"K5 fp32 x={tuple(shape)} (generic): K5f out {r['out_err']:.3e}, "
          f"{r['fwd_ms']:.4f} ms (card {fmt_ms(r['fwd_device_ms'])}); K5b "
          f"without dgamma/dbeta dx rel-L2 {r['dx_rel']:.3e}, row-scaled "
          f"{r['dx_row']:.3e}, {r['bwd_ms']:.4f} ms (card "
          f"{fmt_ms(r['bwd_device_ms'])})", flush=True)
    return r


def phase_train_fp32(device, bf16, card="", build_kw=None,
                     fused_kw=None):
    """The ``--bf16 0`` user's step: the train step at 10,239 under
    ``"flash"`` with the frozen backbone in fp32 (no autocast), on the
    kernels alone, on the default route and on the fused route
    (``mega_attention=False`` with the fused GELU -> LayerNorm):
    :func:`drive_train`'s checked and timed steps (every K1f and K1b, or
    K3f and K3b, on the 3xTF32 family, K2 and K5 on their fp32 kernels,
    the CUDA cores' and the generic ones), the generic K5 kernels held to
    their plain versions at the step's FFN shape (:func:`k5_fp32_readings`);
    each step's ms/step and peak printed beside the bf16 step's (``bf16``,
    :func:`phase_train`'s result). Returns both paths' results."""
    import torch
    out = {}
    for tag, kw, pair in (("fp32 train", build_kw or GIGAPATH, ("K1f", "K1b")),
                          ("fused fp32 train", fused_kw or GIGAPATH_FUSED,
                           ("K3f", "K3b"))):
        model, tcfg, opt, text, batch = timed_build(
            device, tag, dict(kw, frozen="float32"))
        res = drive_train(device, model, tcfg, opt, text, batch, tag, card)
        del model, opt, batch
        torch.cuda.empty_cache()
        check(all(res["families"][key]["tf32x3"] == res["launches"][key] > 0
                  for key in pair),
              f"{tag}: {pair} launches by family {res['families']}, want "
              f"all on the 3xTF32 family")
        if res["launches"]["K5f"]:
            res["k5_fp32"] = k5_fp32_readings(device)
        print(f"{tag}: {res['ms']:.2f} ms/step, peak "
              f"{res['peak_bytes'] / 2**30:.3f} GiB, against the bf16 step's "
              f"{bf16['ms']:.2f} ms/step, "
              f"{bf16['peak_bytes'] / 2**30:.3f} GiB "
              f"({res['ms'] / bf16['ms']:.2f}x); {card}", flush=True)
        out[tag] = res
    return out


# ---------------------------------------------------------------------------
# Data and sequence parallelism (parallel/, ops/dilated_sp.py)
# ---------------------------------------------------------------------------

SEQ_AXES = ("data", "seq")
SP_RANKS = 2


def gigapath_without_dropout(seq_axes=None):
    """ModalTune-GigaPath at full width with every dropout and drop-path
    rate 0 (the sequence-parallel step draws a rank's dropout bits for its
    token shard, so only a step without them can equal the single-process
    one), and ``seq_axes``."""
    import dataclasses
    from modaltune_tpu_torch.configs import gigapath_modaltune_config
    cfg = gigapath_modaltune_config()
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dropout=0.0,
                                          drop_path_rate=0.0,
                                          seq_axes=seq_axes),
        adapter=dataclasses.replace(cfg.adapter, drop_path_rate=0.0),
        gene=dataclasses.replace(cfg.gene, dropout=0.0))


def read_counts_qrange() -> dict:
    """:func:`read_counts` and K1's launches with a ``q_token_range``
    (``K1f_qrange``, ``K1b_qrange``: K1b in two parts counts part 0 there
    and part 1 in ``K1b_part1``)."""
    dm = importlib.import_module(COUNTERS["K1f"][0])
    return dict(read_counts(), K1f_qrange=dm.QRANGE_LAUNCHES,
                K1b_qrange=dm.BWD_QRANGE_LAUNCHES,
                K1b_part1=dm.BWD_PART1_LAUNCHES)


def reset_counts_qrange() -> None:
    reset_counts()
    dm = importlib.import_module(COUNTERS["K1f"][0])
    dm.QRANGE_LAUNCHES = dm.BWD_QRANGE_LAUNCHES = 0
    dm.BWD_PART1_LAUNCHES = 0


def sp_grad_step(device, seed, mesh=None, **data_kw):
    """One grad step of GigaPath without dropout, ``seq_axes`` set, at
    ``data_kw``'s bucket (10,239 unless given), under ``mesh`` as the
    ambient mesh where given: ``(loss, {name: fp32 grad on the CPU},
    launches, ms of a second step, peak bytes)``."""
    import torch
    from modaltune_tpu_torch import make_grad_step
    from modaltune_tpu_torch.ops.dilated_sp import use_mesh
    model, tcfg, _, text, batch = build_train(
        device, **{**GIGAPATH, "cfg": gigapath_without_dropout(SEQ_AXES),
                   **data_kw})

    def step():
        gen = torch.Generator(device=device).manual_seed(seed)
        if mesh is None:
            return make_grad_step(model, tcfg)(batch, text, gen)
        with use_mesh(mesh):
            return make_grad_step(model, tcfg)(batch, text, gen)
    torch.cuda.synchronize()
    reset_counts_qrange()
    loss, grads = step()
    torch.cuda.synchronize()
    launches = read_counts_qrange()
    torch.cuda.reset_peak_memory_stats()
    _, ms = timed_once(step)
    peak = torch.cuda.max_memory_allocated()
    per = calls_per_forward(model)
    return (float(loss), {n: g.float().cpu() for n, g in grads.items()},
            launches, ms, peak, per)


def _sp_rank(rank, n, run_dir, seed):
    """Rank ``rank`` of the sequence-parallel step: a process of an
    ``n``-rank gloo group on the one card (NCCL refuses two ranks on one
    GPU), a ``(1, n)`` mesh, :func:`sp_grad_step`; its results saved to
    ``run_dir``."""
    import torch
    import torch.distributed as dist
    from modaltune_tpu_torch.ops import _build
    from modaltune_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.load_library()
    dist.init_process_group("gloo", init_method=f"file://{run_dir}/init",
                            rank=rank, world_size=n)
    try:
        out = sp_grad_step(torch.device("cuda:0"), seed,
                           mesh=make_mesh(n_data=1, n_seq=n))
        torch.save(out, f"{run_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_parallel(device, card="", sp_kw=None, dp_kw=None, timeout=600):
    """The port's data and sequence parallelism on the one card, each
    against the single-device step.

    * A world of one over NCCL: ``make_dp_train_step`` on a one-rank data
      mesh against ``make_train_step`` from the same weights and dropout
      bits (GigaPath at full width, the 2,047 bucket; the launch counts of
      the step checked), ``DdpGradSync``'s mean of a grad step against the
      gradients, ``allgather_embeddings`` of the embed step's output with
      its id, ``process_sum`` and ``global_steps_min``, each through the
      NCCL group.
    * A 2-rank sequence-parallel GigaPath grad step at 10,239 (dropout
      off, ``seq_axes`` set): two processes share the card over gloo, each
      runs the 12 layers on its 5,120 tokens with K1f and K1b on its
      ``q_token_range`` (12 each and no plain K1 launch per rank); their
      loss and adapter gradients against the same model's single-process
      step by :func:`grad_readings` at the bf16 limits, and the two
      ranks' gradients equal."""
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from modaltune_tpu_torch import (make_embed_step, make_grad_step,
                                     make_train_step)
    from modaltune_tpu_torch.parallel import multihost as mh
    from modaltune_tpu_torch.parallel.mesh import (make_dp_train_step,
                                                   make_mesh)
    dp_kw = dp_kw or {**GIGAPATH, **GIGAPATH_2047}
    res = {}
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")

    # ---- a world of one over NCCL ----
    dist.init_process_group("nccl", init_method=f"file://{run_dir}/nccl",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(n_data=1)
        params, losses = {}, {}
        for kind in ("single", "dp"):
            model, tcfg, opt, text, batch = build_train(device, **dp_kw)
            gen = torch.Generator(device=device).manual_seed(5)
            step = make_train_step(model, tcfg, opt) if kind == "single" \
                else make_dp_train_step(model, tcfg, opt, mesh)
            torch.cuda.synchronize()
            reset_counts()
            losses[kind] = float(step(batch, text, gen))
            torch.cuda.synchronize()
            if kind == "dp":
                res["dp_launches"] = read_counts()
                per = calls_per_forward(model)
                want = {f"{k}{d}": n for k, n in per.items() for d in "fb"}
                check(res["dp_launches"] == want, f"dp train launches "
                      f"{res['dp_launches']} != {want}")
            params[kind] = {n: p.detach().float().clone()
                            for n, p in model.named_parameters()
                            if p.requires_grad}
        check(losses["dp"] == losses["single"], f"dp step loss "
              f"{losses['dp']} != the single-device step's "
              f"{losses['single']}")
        dp_err = max((params["dp"][n] - p).abs().max().item()
                     for n, p in params["single"].items())
        check(dp_err == 0.0, f"dp step parameters differ from the "
              f"single-device step's by {dp_err:.3e}")
        gen = torch.Generator(device=device).manual_seed(6)
        loss, grads = make_grad_step(model, tcfg)(batch, text, gen)
        trainable = {n: p for n, p in model.named_parameters()
                     if p.requires_grad}
        mean, mloss = mh.DdpGradSync(opt, trainable).mean(grads, loss)
        check(all(torch.equal(mean[n], grads[n].to(mean[n].dtype))
                  for n in grads) and float(mloss) == float(loss),
              "DdpGradSync's mean over a world of one changed the gradients")
        emb = make_embed_step(model, tcfg)(batch).float().cpu().numpy()
        x, ids = mh.allgather_embeddings(emb, ["case-0"])
        check(ids == ["case-0"] and (x == emb).all(),
              "allgather_embeddings over a world of one changed its input")
        check(list(mh.process_sum([1.5, 2.0])) == [1.5, 2.0] and
              mh.global_steps_min(7) == 7,
              "process_sum / global_steps_min over a world of one")
        del model, opt, params, grads, mean
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"parallel: a world of one over NCCL at bucket "
          f"{dp_kw['bucket']}: make_dp_train_step loss {losses['dp']:.6f} and "
          f"parameters bit-equal to make_train_step's, launches "
          f"{res['dp_launches']}; DdpGradSync mean, allgather_embeddings, "
          f"process_sum, global_steps_min through the NCCL group unchanged",
          flush=True)

    # ---- the 2-rank sequence-parallel step, against one process ----
    sp_kw = sp_kw or {}
    loss1, grads1, launches1, ms1, peak1, per = sp_grad_step(
        device, seed=7, **sp_kw)
    check(launches1["K1f"] == per["K1"] and launches1["K1f_qrange"] ==
          launches1["K1b_qrange"] == launches1["K1b_part1"] == 0,
          f"single-process step launches {launches1}")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_sp_rank, args=(r, SP_RANKS, run_dir, 7))
             for r in range(SP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, timeout - (time.perf_counter() - t0)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    check(not alive and all(p.exitcode == 0 for p in procs),
          f"sequence-parallel ranks: exit codes "
          f"{[p.exitcode for p in procs]} (killed after {timeout} s: "
          f"{bool(alive)})")
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{run_dir}/rank{r}.pt", weights_only=False)
             for r in range(SP_RANKS)]
    sp_launches = {k: sum(r[2][k] for r in ranks) for k in ranks[0][2]}
    for r in ranks:
        got = r[2]
        check(got["K1f_qrange"] == got["K1b_qrange"] == got["K1b_part1"]
              == per["K1"] and got["K1f"] == got["K1b"] == 0 and
              got["K2f"] == got["K2b"] == per["K2"],
              f"sequence-parallel rank launches {got}, want "
              f"{per['K1']} K1f, K1b part 0 and part 1 with a range and "
              f"{per['K2']} K2f/K2b")
    for n in grads1:
        check(torch.equal(ranks[0][1][n], ranks[1][1][n]),
              f"sequence-parallel ranks' {n} gradients differ")
    loss_sp, grads_sp = ranks[0][0], ranks[0][1]
    loss_rel = abs(loss_sp - loss1) / abs(loss1)
    g_all = max(g.abs().max().item() for g in grads1.values())
    rel_lim, row_lim = GRAD_LIMITS["bfloat16"]
    worst = (0.0, 0.0, "")
    null_worst = 0.0
    for n, want in grads1.items():
        got = grads_sp[n]
        if n.endswith(NULL_GRAD):
            null_worst = max(null_worst,
                             (got - want).abs().max().item() / g_all)
            continue
        rel, row = grad_readings(got, want, want)
        if rel > worst[0]:
            worst = (rel, row, n)
        check(rel <= rel_lim and row <= row_lim,
              f"sequence-parallel {n}: rel-L2 {rel:.3e}, row-scaled "
              f"{row:.3e} against the single-process step")
    check(loss_rel <= 1e-3 and null_worst <= 1e-2,
          f"sequence-parallel loss {loss_sp} vs {loss1} (rel {loss_rel:.3e})"
          f", NULL_GRAD max|err| / max|g| {null_worst:.3e}")
    res.update(sp_launches=sp_launches, sp_loss_rel=loss_rel,
               sp_worst_rel=worst[0], sp_ms=[r[3] for r in ranks],
               sp_peak=[r[4] for r in ranks], single_ms=ms1,
               single_peak=peak1)
    print(f"parallel: {SP_RANKS}-rank sequence-parallel grad step at bucket "
          f"{sp_kw.get('bucket', GIGAPATH['bucket'])} over gloo on one card "
          f"(dropout off): loss {loss_sp:.6f} vs {loss1:.6f} one process "
          f"(rel {loss_rel:.3e}); adapter gradients: largest rel-L2 "
          f"{worst[0]:.3e} (row-scaled {worst[1]:.3e}, {worst[2]}), "
          f"NULL_GRAD max|err| / max|g| {null_worst:.3e}; ranks' gradients "
          f"bit-equal; launches per rank {ranks[0][2]}; second step "
          f"{[round(r[3], 2) for r in ranks]} ms a rank (one process "
          f"{ms1:.2f} ms), peak {[round(r[4] / 2**30, 3) for r in ranks]} "
          f"GiB a rank (one process {peak1 / 2**30:.3f}); the ranks' run "
          f"{wall:.1f} s{'; ' + card if card else ''}", flush=True)
    return res


# ---------------------------------------------------------------------------
# The trainer: the port's CLI on the reference's file formats
# ---------------------------------------------------------------------------

# tests/test_dropin_e2e.py's layout at full width: GigaPath tile features
# on a 256-px grid; train one case of two slides (concatenated with the
# +1,500 y-offset) and three of one, val and test two cases each in one
# packed container; 4,987 genes in 331 pathways of at most 100
TRAINER_DATA = dict(in_chans=1536, two_slides=(4800, 5100),
                    one_slide=(9000, 10239), n_genes=4987, n_groups=331,
                    max_size=100)
TRAINER_FLAGS = ["--mil_name", "longnetvit_gene_adapter", "--bf16", "1",
                 "--threshold", "25000", "--buckets", "10239",
                 "--num_epochs", "2", "--eval_interval", "1",
                 "--save_interval", "1", "--save_embeddings", "--seed", "0"]


def write_pathway_csv(path, n_genes, n_groups, max_size):
    """The pathway-membership CSV (gene x pathway 0/1) of
    ``synthetic_pathways`` over genes ``g0 .. g{n_genes - 1}``."""
    import numpy as np
    from modaltune_tpu_torch.data import synthetic_pathways
    groups = synthetic_pathways(n_genes=n_genes, n_groups=n_groups,
                                max_size=max_size, seed=0)
    member = np.zeros((n_genes, n_groups), np.int64)
    for j, names in groups.items():
        member[[int(g[1:]) for g in names], j] = 1
    with open(path, "w") as f:
        f.write("gene," + ",".join(f"P{j}" for j in range(n_groups)) + "\n")
        for i, row in enumerate(member):
            f.write(f"g{i}," + ",".join(map(str, row)) + "\n")


def write_reference_files(root, in_chans, two_slides, one_slide, n_genes,
                          n_groups, max_size, seed=0,
                          projects=("TCGA-BRCA",), cases=(4, 2, 2)):
    """The reference's on-disk formats under ``root``: per-slide
    ``*_featvec.pt`` dicts (train), one ``.mtbc`` container written by
    ``pack_feature_files`` (val and test), split JSONs ``{"data": rows}``
    with ``cases`` (train, val, test) cases of each of ``projects`` (one
    project after another), alternating ``primary_class`` and seeded
    ``durations`` and ``vital_status``, a ``.pt`` dict of (4, 512) text
    embeddings, the gene CSV and the pathway-membership CSV. The first
    train case has two slides. In each project's split the first case is
    the earliest death and the second a death too, so every site's split
    holds a comparable pair and every site's train split two events.
    -> the CLI's data flags."""
    import numpy as np
    import torch
    from modaltune_tpu_torch.data.bagcache import pack_feature_files
    rng = np.random.default_rng(seed)
    feats = root / "features"
    feats.mkdir()

    def slide(name, length_range):
        n = int(rng.integers(*length_range))
        path = feats / f"{name}_featvec.pt"
        torch.save({"features": torch.from_numpy(rng.standard_normal(
            (n, in_chans), dtype=np.float32)),
            "coords": torch.from_numpy((rng.integers(0, 900, (n, 2)) * 256.0)
                                       .astype(np.float32))}, path)
        return str(path)

    genes = [f"g{i}" for i in range(n_genes)]
    cache = root / "features.mtbc"
    text, gene_rows, flags, to_pack = {}, [], [], []
    for split, n_cases in zip(("train", "val", "test"), cases):
        rows = []
        for k in range(n_cases * len(projects)):
            i = k % n_cases
            sub = f"TCGA-{split[:2].upper()}-{k:04d}"
            cid = f"{sub}-case"
            n_slides = 2 if (split == "train" and k == 0) else 1
            meta = {"case_id": cid, "case_submitter_id": sub,
                    "project_id": projects[k // n_cases],
                    "primary_class": i % 2,
                    "durations": float(rng.integers(2, 100)),
                    "vital_status": int(rng.random() < 0.7)}
            if i < 2:
                meta["vital_status"] = 1
            if i == 0:
                meta["durations"] = 1.0
            for s in range(n_slides):
                path = slide(f"{sub}-DX{s + 1}",
                             two_slides if n_slides == 2 else one_slide)
                if split != "train":       # into the packed container
                    to_pack.append(path)
                    path = f"{cache}:{len(to_pack) - 1}"
                rows.append(dict(meta, slide_submitter_id=f"{sub}-DX{s + 1}",
                                 features_path=path))
            text[cid] = torch.from_numpy(rng.standard_normal(
                (4, 512), dtype=np.float32))
            gene_rows.append((sub, rng.standard_normal(n_genes)))
        with open(root / f"{split}.json", "w") as f:
            json.dump({"data": rows}, f)
        flags += [f"--{split}_json", str(root / f"{split}.json")]
    pack_feature_files(to_pack, str(cache))
    for path in to_pack:
        Path(path).unlink()
    torch.save(text, root / "text.pt")
    with open(root / "genes.csv", "w") as f:
        f.write("case_id," + ",".join(genes) + "\n")
        for sub, vec in gene_rows:
            f.write(sub + "," + ",".join(f"{v:.5f}" for v in vec) + "\n")
    write_pathway_csv(root / "pathways.csv", n_genes, n_groups, max_size)
    return flags + ["--genomics_csv_path", str(root / "genes.csv"),
                    "--pathway_csv", str(root / "pathways.csv"),
                    "--text_location", str(root / "text.pt")]


def written_files(root, tag, data_kw):
    """:func:`write_reference_files` under ``root``, its time and size
    printed -> the CLI's data flags."""
    t0 = time.perf_counter()
    flags = write_reference_files(root, **data_kw)
    size = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    print(f"{tag}: reference files written in {time.perf_counter() - t0:.1f}"
          f" s ({size / 2**30:.3f} GiB)", flush=True)
    return flags


def run_cli(cli, args, Trainer, methods):
    """``cli.run_one_seed(args)`` in-process, every launch count set to 0
    just before it -> (the one ``Trainer`` it built, the seconds of each
    call of each of ``methods`` with the device synchronised around it, the
    launch counts just after, the peak allocated bytes, the run's wall
    seconds)."""
    import torch
    from modaltune_tpu_torch.data import datasets as data_mod
    trainers, seconds = [], {}
    init = Trainer.__init__

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        trainers.append(self)

    def timed(name):
        fn = getattr(Trainer, name)

        def wrapper(self, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            seconds.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return mock.patch.object(Trainer, name, wrapper)

    patches = [mock.patch.object(Trainer, "__init__", spy_init)] + [
        timed(n) for n in methods]
    data_mod._BAGCACHE_READERS.clear()
    torch.cuda.reset_peak_memory_stats()
    for p in patches:
        p.start()
    # the main path: every launch count starts at 0 just before it
    reset_counts()
    t0 = time.perf_counter()
    try:
        cli.run_one_seed(args)
    finally:
        for p in patches:
            p.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (trainer,) = trainers
    return (trainer, seconds, read_counts(), torch.cuda.max_memory_allocated(),
            wall)


def phase_trainer(device, card="", data_kw=None, flags=None, tag="trainer",
                  want_bucket=None):
    """The port's train CLI (``run_one_seed``) in-process on the
    reference's file formats at ``data_kw``'s sizes (``TRAINER_DATA``):
    two epochs of training with the in-loop readout on val, test with the
    best weights, a full-state checkpoint every epoch, deploy. Prints the
    trainer's median ms/step (each step ends when its loss reaches the
    host, after the update), s/epoch, the loader's host ms per batch (the
    time the epoch loop blocks in the train loader's next()), eval and
    deploy seconds, peak memory and the readout rows. Checks: finite
    losses; the best weights reload strictly in a fresh trainer and a file
    missing one tensor is refused; the checkpoint restores bit-equal; the
    deploy's results and embeddings; the test embeddings equal the embed
    step of the reloaded model on the same batches; every ``.mtbc`` read
    took the native reader; K1f, K1b, K2f and K2b launched; with
    ``want_bucket``, every batch the trainer ran (train, eval, deploy) in
    that bucket."""
    import tempfile

    import numpy as np
    import torch
    from modaltune_tpu_torch import create_aggregator, make_embed_step
    from modaltune_tpu_torch.data import BucketedLoader
    from modaltune_tpu_torch.data import datasets as data_mod
    from modaltune_tpu_torch.tools import train as cli
    from modaltune_tpu_torch.train import trainer as trainer_mod
    from modaltune_tpu_torch.train import batch_to_device
    data_kw = data_kw or TRAINER_DATA
    flags = TRAINER_FLAGS if flags is None else flags
    Trainer = trainer_mod.ModalTuneTrainer
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data_flags = written_files(root, tag, data_kw)
        args = cli.build_parser().parse_args(
            flags + data_flags + ["--output_path", str(root / "results"),
                                  "--device", device.type])

        # the bucket of every batch the trainer moves to the card
        buckets, to_device = [], Trainer._batch

        def spy_batch(self, batch):
            buckets.append(batch.bag.shape[1])
            return to_device(self, batch)
        with mock.patch.object(Trainer, "_batch", spy_batch):
            trainer, seconds, launches, peak, wall = run_cli(
                cli, args, Trainer, ("train_one_epoch", "fit_readout_heads",
                                     "evaluate", "deploy"))
        print(f"{tag}: {len(buckets)} batches in buckets "
              f"{sorted(set(buckets))}", flush=True)
        check(want_bucket is None or set(buckets) == {want_bucket},
              f"{tag}: batches in buckets {sorted(set(buckets))}, not all in "
              f"{want_bucket}")
        run = root / "results" / "seed_0"

        rows = [json.loads(line) for line in open(run / "run_metrics.jsonl")]
        losses = [r["train_loss"] for r in rows if "train_loss" in r]
        check(len(losses) == trainer.cfg.num_epochs and
              all(math.isfinite(x) for x in losses),
              f"{tag}: epoch losses {losses}")
        step_ms = statistics.median(trainer.step_ms)
        loader_ms = trainer.loader_ms
        print(f"{tag}: {len(trainer.step_ms)} train steps, median "
              f"{step_ms:.2f} ms/step ({[round(x, 2) for x in trainer.step_ms]}); "
              f"s/epoch {[round(x, 2) for x in seconds['train_one_epoch']]}; "
              f"epoch losses {losses}; {card}", flush=True)
        print(f"{tag}: loader host ms per batch (blocked in next()) mean "
              f"{statistics.mean(loader_ms):.3f}, median "
              f"{statistics.median(loader_ms):.3f}, max {max(loader_ms):.3f} "
              f"({[round(x, 3) for x in loader_ms]})", flush=True)
        print(f"{tag}: readout fits {sum(seconds['fit_readout_heads']):.2f} "
              f"s ({len(seconds['fit_readout_heads'])} fits), evaluate "
              f"{sum(seconds['evaluate']):.2f} s "
              f"({len(seconds['evaluate'])} splits), deploy "
              f"{sum(seconds['deploy']):.2f} s; run_one_seed {wall:.1f} s; "
              f"peak allocated {peak / 2**30:.3f} GiB; launches {launches}",
              flush=True)
        for r in rows:
            if "val_cls_loss" in r or "test_cls_loss" in r:
                print(f"{tag}: readout {json.dumps(r)}", flush=True)

        # best weights: a fresh trainer loads them strictly; its embed step
        # gives the deploy's test embeddings on the same batches; a file
        # with one tensor removed is refused
        best = run / "best_model_weights.pt"
        check(best.exists(), f"{tag}: no best_model_weights.pt")
        datasets, packer = cli.load_real_datasets(args)
        model = create_aggregator(
            args.mil_name, device=device, cfg=cli.model_config(args),
            n_gene_groups=packer.n_groups, max_group_len=packer.max_group_len)

        def fresh_trainer(name):
            t = Trainer(model, trainer.cfg, datasets, str(root / name),
                        buckets=trainer.buckets)
            t.init_state(cli.initial_params(model, args),
                         frozen_dtype=torch.bfloat16)
            return t

        fresh = fresh_trainer("fresh")
        fresh.load_weights(str(best))
        deploy = json.load(open(run / "deploy_results.json"))
        check(all(all(k in deploy.get(t, {}) for k in ("c_index", "acc"))
                  for t in ("General", "Diagnosis", "Survival")),
              f"{tag}: deploy results {deploy}")
        feats = {}
        for split in ("train", "val", "test"):
            x = np.load(run / "data" / f"x_feats_{split}.npy")
            n = len(trainer.datasets[split])
            check(x.shape == (n, 3, 256) and np.isfinite(x).all(),
                  f"{tag}: x_feats_{split} {x.shape}")
            feats[split] = x
        # the deploy was the test loader's last pass: the same seed and
        # epoch draw the same subsample of a bag over the threshold
        test_loader = trainer.eval_loaders["test"]
        loader = BucketedLoader(datasets["test"], buckets=trainer.buckets,
                                shuffle=False, prefetch=0,
                                seed=test_loader.seed)
        loader.epoch = test_loader.epoch - 1
        embed = make_embed_step(model, trainer.cfg)
        again = np.concatenate([
            embed(batch_to_device(b, device)).float().cpu().numpy()
            for b in loader])
        diff = float(np.abs(again - feats["test"]).max())
        check(diff == 0.0, f"{tag}: deploy's test embeddings differ from "
              f"the reloaded model's embed step by {diff}")
        sd = torch.load(best, map_location="cpu", weights_only=True)
        dropped = sorted(sd)[len(sd) // 2]
        del sd[dropped]
        torch.save(sd, root / "broken.pt")
        try:
            fresh.load_weights(str(root / "broken.pt"))
            refused = False
        except ValueError:
            refused = True
        check(refused, f"{tag}: weights without {dropped} were accepted")

        # the checkpoint restores bit-equal
        restored = fresh_trainer("restored")
        restored.out_dir = run
        ck = torch.load(run / "ckpt.pt", map_location="cpu",
                        weights_only=True)
        check(restored.restore_checkpoint(), f"{tag}: no checkpoint")
        same_params = all(torch.equal(p.detach().cpu(), ck["trainable"][n])
                          for n, p in model.named_parameters()
                          if p.requires_grad)
        want, got = (trainer.optimizer.adamw.state_dict()["state"],
                     restored.optimizer.adamw.state_dict()["state"])
        same_adamw = want.keys() == got.keys() and all(
            torch.equal(want[i][k].cpu(), got[i][k].cpu())
            for i in want for k in want[i])
        check(restored.current_epoch == trainer.cfg.num_epochs and
              restored.optimizer.updates == trainer.optimizer.updates and
              same_params and same_adamw,
              f"{tag}: restored epoch {restored.current_epoch}, updates "
              f"{restored.optimizer.updates} (saved "
              f"{trainer.optimizer.updates}), trainable equal {same_params}, "
              f"AdamW equal {same_adamw}")
        print(f"{tag}: best weights reloaded strictly, a file without "
              f"{dropped} refused; checkpoint restored at epoch "
              f"{restored.current_epoch}, {restored.optimizer.updates} "
              f"updates, {len(ck['trainable'])} trainable tensors and "
              f"{len(got)} AdamW states bit-equal", flush=True)
        readers = list(data_mod._BAGCACHE_READERS.values())
        check(readers and all(r.native for r in readers),
              f"{tag}: .mtbc readers native: {[r.native for r in readers]}")
        print(f"{tag}: deploy {json.dumps(deploy)}", flush=True)
        print(f"{tag}: x_feats {[feats[s].shape for s in feats]} finite; "
              f"test embeddings equal the reloaded model's embed step; "
              f"{len(readers)} .mtbc reader(s), all native", flush=True)
    check(all(launches[k] > 0 for k in ("K1f", "K1b", "K2f", "K2b")),
          f"{tag}: launches {launches}")
    return dict(launches=launches, ms=step_ms, loader_ms=loader_ms,
                peak_bytes=peak, losses=losses, seconds=seconds)


# the pan-cancer trainer's cohort: four sites (SITE_LABEL's 0-3), 6 train,
# 3 val and 3 test cases each, bags of 1,500-2,000 tiles (the first train
# case of two slides of 750-1,000), at full width
PANCANCER_DATA = dict(TRAINER_DATA, two_slides=(750, 1000),
                      one_slide=(1500, 2000),
                      projects=("TCGA-BRCA", "TCGA-GBM", "TCGA-LUAD",
                                "TCGA-KIRC"), cases=(6, 3, 3))
PANCANCER_FLAGS = ["--mil_name", "longnetvit_gene_adapter", "--pancancer", "1",
                   "--reference_quirks", "1", "--bf16", "1", "--threshold",
                   "25000", "--buckets", "2047", "--num_epochs", "2",
                   "--eval_interval", "1", "--save_embeddings", "--seed", "0"]
PANCANCER_SITES = ("TCGA-BRCA", "TCGA-GBMLGG", "TCGA-NSCLC", "TCGA-RCC")
TASKS = ("General", "Diagnosis", "Survival")


def phase_pancancer(device, card="", data_kw=None, flags=None):
    """The port's train CLI with ``--pancancer 1 --reference_quirks 1``
    (``run_one_seed`` in-process) on the reference's file formats of four
    TCGA projects (``PANCANCER_DATA``): two epochs with the per-site readout
    on val, test with the best weights, deploy. Prints the trainer's median
    ms/step, s/epoch, the loader's host ms per batch, eval and deploy
    seconds and peak memory. Checks: every epoch ran every batch (no
    6-step cap: pan-cancer has none); finite losses; each val row holds
    ``site{s}_bal_acc`` and ``site{s}_c_index`` of the four sites and
    ``cancer_site_acc``; ``deploy_results_pancancer.json`` holds the four
    combined sites, each with the three tasks' finite ``c_index`` and
    ``pooled_c_index``, and ``site_classification`` for the three tasks;
    K1f, K1b, K2f and K2b launched."""
    import tempfile

    import torch
    from modaltune_tpu_torch.tools import train as cli
    from modaltune_tpu_torch.train.pancancer_trainer import PanCancerTrainer
    data_kw = data_kw or PANCANCER_DATA
    flags = PANCANCER_FLAGS if flags is None else flags
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data_flags = written_files(root, "pancancer", data_kw)
        args = cli.build_parser().parse_args(
            flags + data_flags + ["--output_path", str(root / "results"),
                                  "--device", device.type])
        trainer, seconds, launches, peak, wall = run_cli(
            cli, args, PanCancerTrainer, ("train_one_epoch",
                                          "fit_readout_heads", "evaluate",
                                          "deploy"))
        run = root / "results" / "seed_0"
        rows = [json.loads(line) for line in open(run / "run_metrics.jsonl")]
        deploy = json.load(open(run / "deploy_results_pancancer.json"))

    epochs = trainer.cfg.num_epochs
    steps = len(trainer.train_loader)
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    check(len(trainer.step_ms) == epochs * steps,
          f"pancancer: {len(trainer.step_ms)} train steps in {epochs} epochs "
          f"of {steps} batches")
    check(len(losses) == epochs and all(math.isfinite(x) for x in losses),
          f"pancancer: epoch losses {losses}")
    val = [r for r in rows if "val_cls_loss" in r]
    want = [f"val_site{s}_{m}" for s in range(4)
            for m in ("bal_acc", "c_index")] + ["val_cancer_site_acc"]
    check(len(val) == epochs and all(all(k in r for k in want) for r in val),
          f"pancancer: val rows {val}")
    check(set(PANCANCER_SITES) | {"site_classification"} <= set(deploy) and
          all(all(math.isfinite(deploy[s][t][k]) for t in TASKS
                  for k in ("c_index", "pooled_c_index"))
              for s in PANCANCER_SITES) and
          set(deploy["site_classification"]) == set(TASKS),
          f"pancancer: deploy results {deploy}")
    step_ms = statistics.median(trainer.step_ms)
    loader_ms = trainer.loader_ms
    print(f"pancancer: {len(trainer.step_ms)} train steps ({epochs} epochs of "
          f"{steps}, no cap under --reference_quirks 1), median "
          f"{step_ms:.2f} ms/step; s/epoch "
          f"{[round(x, 2) for x in seconds['train_one_epoch']]}; epoch "
          f"losses {losses}; {card}", flush=True)
    print(f"pancancer: loader host ms per batch (blocked in next()) mean "
          f"{statistics.mean(loader_ms):.3f}, median "
          f"{statistics.median(loader_ms):.3f}, max {max(loader_ms):.3f}",
          flush=True)
    print(f"pancancer: readout fits {sum(seconds['fit_readout_heads']):.2f} s "
          f"({len(seconds['fit_readout_heads'])} fits), evaluate "
          f"{sum(seconds['evaluate']):.2f} s ({len(seconds['evaluate'])} "
          f"splits), deploy {sum(seconds['deploy']):.2f} s; run_one_seed "
          f"{wall:.1f} s; peak allocated {peak / 2**30:.3f} GiB; launches "
          f"{launches}", flush=True)
    for r in rows:
        if "val_cls_loss" in r or "test_cls_loss" in r:
            print(f"pancancer: readout {json.dumps(r)}", flush=True)
    print(f"pancancer: deploy {json.dumps(deploy)}", flush=True)
    check(all(launches[k] > 0 for k in ("K1f", "K1b", "K2f", "K2b")),
          f"pancancer: launches {launches}")
    return dict(launches=launches, ms=step_ms, loader_ms=loader_ms,
                peak_bytes=peak, losses=losses, seconds=seconds)


# the supervised baselines through the CLI, on TRAINER_DATA's files at the
# 10,239 bucket: (name, flags, rel-L2 limit of card against CPU in fp32)
BASELINE_RUNS = (
    ("abmil", ["--mil_name", "abmil"], 1e-4),
    ("transmil_cat_survival", ["--mil_name", "transmil", "--fusion", "cat",
                               "--mode", "survival"], 1e-3),
    ("gene_mixer_group", ["--mil_name", "gene_mixer_group"], 1e-4),
)
BASELINE_FLAGS = ["--threshold", "25000", "--buckets", "10239",
                  "--num_epochs", "2", "--eval_interval", "1", "--seed", "0"]
# one TransMIL train step at the reference's threshold: B = 4 (the MIL
# trainer's batch size) at the 25,599 bucket
TRANSMIL_BIG = dict(batch=4, bucket=25599, valid=(25599, 24000, 22000, 20000))


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() /
                 want.double().norm().clamp_min(1e-30))


def step_times(trainer, inputs, y, events, steps=3):
    """ms of each of ``steps`` train steps of a baseline trainer on one
    batch, after one warm-up, by CUDA events; each loss finite."""
    trainer.train_step(inputs, y, events)
    times = []
    for _ in range(steps):
        loss, ms = timed_once(lambda: trainer.train_step(inputs, y, events))
        check(math.isfinite(float(loss)), f"train step: loss {loss}")
        times.append(ms)
    return times


def head_input(model, inputs):
    """The input of the model's head LayerNorm (``final_norm``) on
    ``inputs``, in eval mode."""
    import torch
    seen = []
    norm = getattr(model, "head", model).final_norm
    hook = norm.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        hook.remove()
    return seen[0]


def phase_baselines(device, card="", data_kw=None, runs=BASELINE_RUNS,
                    flags=None, big=TRANSMIL_BIG):
    """The port's train CLI for the supervised baselines (ABMIL classifier,
    TransMIL "(cat)" survival, the gene-only model), two epochs each, on the
    reference's files at full width (1,536-d tiles, 4,987 genes in 331
    pathways, hidden 512). Each prints its ms/step, s/epoch and peak memory.
    Checks: finite losses; the best weights written and held by the model
    after the run (reloaded for the test split); the test metrics; for one
    val batch, the model's outputs on the card against the same model and
    weights on the CPU in fp32, rel-L2 at most the run's limit; no kernel of
    the port launched. Then one TransMIL train step of ``big`` (timed, its
    peak memory), loss finite."""
    import copy
    import tempfile

    import torch
    from modaltune_tpu_torch.data import BucketedLoader
    from modaltune_tpu_torch.tools import train as cli
    from modaltune_tpu_torch.train.gene_trainer import (BEST,
                                                        GeneBaselineTrainer)
    data_kw = data_kw or TRAINER_DATA
    flags = BASELINE_FLAGS if flags is None else flags
    out, trainers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data_flags = written_files(root, "baselines", data_kw)
        for name, run_flags, limit in runs:
            run = root / name / "seed_0"
            args = cli.build_parser().parse_args(
                run_flags + flags + data_flags +
                ["--output_path", str(root / name), "--device", device.type])
            trainer, seconds, launches, peak, wall = run_cli(
                cli, args, GeneBaselineTrainer, ("train_one_epoch",
                                                 "evaluate"))
            rows = [json.loads(line)
                    for line in open(run / "run_metrics.jsonl")]
            losses = [r["train_loss"] for r in rows if "train_loss" in r]
            check(len(losses) == trainer.cfg.num_epochs and
                  all(math.isfinite(x) for x in losses),
                  f"{name}: epoch losses {losses}")
            best = torch.load(run / BEST, map_location="cpu",
                              weights_only=True)
            held = trainer.model.state_dict()
            check(best.keys() == held.keys() and
                  all(torch.equal(best[k], held[k].cpu()) for k in best),
                  f"{name}: the model does not hold {BEST}")
            key = "test_c_index" if trainer.model.mode == "survival" \
                else "test_bal_acc"
            test = [r for r in rows if key in r]
            check(len(test) == 1 and math.isfinite(test[0][key]),
                  f"{name}: test rows {test}")
            check(not any(launches.values()),
                  f"{name}: kernels launched {launches}")

            def first_batch(split):
                loader = trainer.loaders[split]
                return next(iter(BucketedLoader(
                    trainer.datasets[split], buckets=loader.buckets,
                    batch_size=loader.batch_size, shuffle=False,
                    prefetch=0)))

            # one val batch on the card against the CPU, fp32; and the
            # head LayerNorm's input, whose norm over its centred norm is
            # the factor by which the norm scales a relative error
            model = trainer.model.eval()
            cpu_model = copy.deepcopy(model).cpu()
            batch = first_batch("val")
            inputs = trainer._model_inputs(batch)
            cpu_inputs = [t.cpu() for t in inputs]
            with torch.no_grad():
                card_out, cpu_out = model(*inputs), cpu_model(*cpu_inputs)
            if isinstance(card_out, tuple):     # hazards, S (not the bin)
                pairs = list(zip(card_out[:2], cpu_out[:2]))
            else:
                pairs = [(card_out, cpu_out)]
            errs = [rel_l2(g.cpu(), w) for g, w in pairs]
            h_cpu = head_input(cpu_model, cpu_inputs)
            h_err = rel_l2(head_input(model, inputs).cpu(), h_cpu)
            centred = h_cpu - h_cpu.mean(-1, keepdim=True)
            gain = float((h_cpu.norm(dim=-1) / centred.norm(dim=-1)).max())
            check(all(e <= limit for e in errs),
                  f"{name}: card vs CPU rel-L2 {errs} > {limit}")
            # the train step alone, on the first train batch
            tb = first_batch("train")
            times = step_times(trainer, trainer._model_inputs(tb),
                               *trainer._targets(tb))
            print(f"{name}: train step {[round(t, 2) for t in times]} ms "
                  f"(median {statistics.median(times):.2f}, B = "
                  f"{tb.bag.shape[0]} at {tb.bag.shape[1]}); in the CLI "
                  f"{len(trainer.step_ms)} steps "
                  f"{[round(t, 2) for t in trainer.step_ms]} "
                  f"ms (the first warms up); s/epoch "
                  f"{[round(x, 2) for x in seconds['train_one_epoch']]}; "
                  f"evaluate {sum(seconds['evaluate']):.2f} s; run_one_seed "
                  f"{wall:.1f} s; peak allocated {peak / 2**30:.3f} GiB; "
                  f"losses {losses}; {key} {test[0][key]:.4f}; {card}",
                  flush=True)
            print(f"{name}: card vs CPU (fp32, batch of {batch.bag.shape[0]} "
                  f"at {batch.bag.shape[1]}) rel-L2 "
                  f"{[f'{e:.3g}' for e in errs]} (limit {limit:g}); the head "
                  f"LayerNorm's input {h_err:.3g}, which the norm's centring "
                  f"scales up to {gain:.3g}x", flush=True)
            out[name] = dict(ms=statistics.median(times), errs=errs,
                             peak_bytes=peak)
            trainers[name] = trainer

    # TransMIL at the reference's threshold
    trainer = trainers["transmil_cat_survival"]
    g = torch.Generator(device=device).manual_seed(0)
    b, n = big["batch"], big["bucket"]
    bag = torch.randn(b, n, trainer.model.fc1.in_features, generator=g,
                      device=device)
    mask = torch.arange(n, device=device)[None, :] < torch.tensor(
        big["valid"], device=device)[:, None]
    enc = trainer.model.head.gene_encoder
    genes = torch.randn(b, enc.n_groups, enc.max_group_len, generator=g,
                        device=device)
    y = torch.arange(b, device=device) % trainer.model.n_classes
    events = torch.ones(b, dtype=torch.int32, device=device)
    torch.cuda.reset_peak_memory_stats()
    times = step_times(trainer, (bag, mask, genes), y, events)
    peak = torch.cuda.max_memory_allocated()
    print(f"transmil @ {n}: one train step of B = {b} ({big['valid']} valid "
          f"tiles), {[round(t, 2) for t in times]} ms, median "
          f"{statistics.median(times):.2f} ms; peak allocated "
          f"{peak / 2**30:.3f} GiB; {card}", flush=True)
    out["transmil_big"] = dict(ms=statistics.median(times), peak_bytes=peak)
    return out


# ---------------------------------------------------------------------------
# Dataset preparation: a synthetic TCGA site through data/pipeline.py and
# data/extract.py, then the CLI on what they wrote
# ---------------------------------------------------------------------------

SITE_DIAGNOSES = ("Infiltrating duct carcinoma, NOS", "Lobular carcinoma, NOS")
SITE_STAGES = ("Stage IA", "Stage IIA", "Stage IIB", "Stage IIIC", "Stage IV",
               "Stage X", "'--")
SITE_T = ("T1c", "T2", "T3", "T4b", "TX", "Tis", "'--")
SITE_N = ("N0", "N0 (i+)", "N1a", "N2", "NX", "'--")
SITE_M = ("M0", "M1", "MX", "cM0 (i+)", "'--")


def write_tcga_site(root, seed=0, classes=(5, 4), project="TCGA-BRCA"):
    """A synthetic TCGA site in GDC's ``clinical.tsv`` and ``slide.tsv``
    columns under ``root``, drawn from ``seed``: ``classes[k]`` cases of
    the site's class k with gene data, and besides one case of an unmapped
    diagnosis (class -1), one without gene data, one without a diagnosis
    and one without a slide. Every case has two clinical rows (two
    treatments, as GDC lists them); every third case two slides; missing
    values are ``'--``; one dead case lacks its death date, one follow-up
    is negative, one vital status is "Not Reported". -> dict of the two
    paths, ``slides`` (slide_submitter_id -> its case's submitter id),
    ``gene_case_ids`` and ``n_cases``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    diagnoses = [SITE_DIAGNOSES[k] for k, n in enumerate(classes)
                 for _ in range(n)]
    diagnoses += ["Medullary carcinoma, NOS", SITE_DIAGNOSES[0], "'--",
                  SITE_DIAGNOSES[1]]
    order = rng.permutation(len(diagnoses) - 4)
    diagnoses = [diagnoses[i] for i in order] + diagnoses[-4:]
    no_gene, no_slide = len(diagnoses) - 3, len(diagnoses) - 1
    columns = ["case_id", "case_submitter_id", "project_id", "age_at_index",
               "days_to_death", "vital_status", "days_to_last_follow_up",
               "ajcc_pathologic_m", "ajcc_pathologic_n",
               "ajcc_pathologic_stage", "ajcc_pathologic_t", "gender",
               "primary_diagnosis", "year_of_diagnosis", "treatment_type"]
    clinical, slide_rows, slides, genes = [], [], {}, []

    def pick(values):
        return values[int(rng.integers(len(values)))]

    for i, diag in enumerate(diagnoses):
        sub = f"TCGA-{seed % 100:02d}-{i:04d}"
        cid = f"{seed:04x}{i:04x}-5e1c-4d7a-9c4f-{rng.integers(16**12):012x}"
        dead = rng.random() < 0.4 or i in (1, 2)
        vital = "Dead" if dead else "Alive"
        death = str(int(rng.integers(30, 3000))) if dead else "'--"
        follow = str(int(rng.integers(10, 4000)))
        if i == 1:
            death = "'--"
        if i == 3:
            follow = "-" + follow
        if i == 4:
            vital = "Not Reported"
        if i == 5:
            follow = "'--"
        age = "'--" if i == 6 else str(int(rng.integers(30, 86)))
        row = dict(case_id=cid, case_submitter_id=sub, project_id=project,
                   age_at_index=age, days_to_death=death, vital_status=vital,
                   days_to_last_follow_up=follow,
                   ajcc_pathologic_m=pick(SITE_M),
                   ajcc_pathologic_n=pick(SITE_N),
                   ajcc_pathologic_stage=pick(SITE_STAGES),
                   ajcc_pathologic_t=pick(SITE_T),
                   gender=pick(("female", "male")), primary_diagnosis=diag,
                   year_of_diagnosis=pick(("2004", "2010", "'--")))
        for treatment in ("Radiation Therapy, NOS",
                          "Pharmaceutical Therapy, NOS"):
            clinical.append(dict(row, treatment_type=treatment))
        if i != no_gene:
            genes.append(sub)
        if i == no_slide:
            continue
        for s in range(2 if i % 3 == 0 else 1):
            sid = f"{sub}-01Z-00-DX{s + 1}"
            slides[sid] = sub
            slide_rows.append(dict(case_id=cid, case_submitter_id=sub,
                                   project_id=project,
                                   slide_id=f"{cid[:8]}-slide-{s}",
                                   slide_submitter_id=sid,
                                   percent_tumor_cells=pick(("70", "'--"))))
    paths = {}
    for name, rows in (("clinical", clinical), ("slide", slide_rows)):
        paths[name] = str(root / f"{name}.tsv")
        cols = columns if name == "clinical" else list(rows[0])
        with open(paths[name], "w") as f:
            f.write("\t".join(cols) + "\n")
            for r in rows:
                f.write("\t".join(r[c] for c in cols) + "\n")
    return dict(paths, slides=slides, gene_case_ids=genes,
                n_cases=len(diagnoses))


def synthetic_slide(seed, n_tiles, tile=256, tissue=0.75, downsample=64):
    """A slide whose tissue, an ellipse over about ``tissue`` of the
    slide, holds about ``n_tiles`` tiles of ``tile`` px, drawn from
    ``seed``: ``(read_region, thumbnail, downsample)``. ``read_region(row,
    col, size)`` makes the pixels of any window as it is read (one of four
    seeded stain textures inside the tissue, white glass outside), so no
    slide array is held; ``thumbnail`` is the RGB thumbnail at
    1/``downsample``, from which ``extract.tissue_mask`` finds the
    tissue."""
    import numpy as np
    rng = np.random.default_rng(seed)
    side = math.ceil(math.sqrt(n_tiles / tissue)) * tile
    m = side // downsample
    yy, xx = np.mgrid[0:m, 0:m] + 0.5
    aspect = rng.uniform(0.8, 1.25)
    r = m * math.sqrt(tissue / math.pi)
    inside = ((yy - m / 2) / (r * aspect)) ** 2 + \
        ((xx - m / 2) / (r / aspect)) ** 2 <= 1.0
    textures = rng.integers(40, 170, (4, 512, 512, 3), dtype=np.uint8)
    thumb = np.where(inside[..., None], textures[0, :m, :m].mean(axis=(0, 1))
                     .astype(np.uint8), np.uint8(255))

    def read_region(row, col, size):
        ds = downsample
        tex = textures[(row // size * 7 + col // size * 13) % 4,
                       :size, :size]
        win = inside[row // ds:(row + size - 1) // ds + 1,
                     col // ds:(col + size - 1) // ds + 1]
        if win.shape == (size // ds, size // ds) and win.all():
            return tex
        win = np.repeat(np.repeat(win, ds, 0), ds, 1)[
            row % ds:row % ds + size, col % ds:col % ds + size]
        full = np.zeros((size, size), bool)
        full[:win.shape[0], :win.shape[1]] = win
        return np.where(full[..., None], tex, np.uint8(255))

    return read_region, thumb, downsample


# ---------------------------------------------------------------------------
# The LongNet extras: the LoRA encoder variant, MoE, xPos, the T5 bias
# ---------------------------------------------------------------------------

def lora_encoder_grads(device, bucket=10239, n_valid=9000, cfg=None):
    """The LoRA encoder alone (ModalTune-GigaPath's 12 layers unless
    ``cfg``, a ``LongNetConfig`` with ``lora_adapter``), every LoRA B
    nonzero, on ``bucket + 1`` tokens with ``n_valid`` valid: the gradients
    of ``sum(out * cot)`` to the LoRA parameters through the kernels in
    bf16 (K2f and K2b per branch and layer, their launches by family
    checked), and through the plain versions in bf16 and in fp32, each
    layer checkpointed so that the plain scores of one layer at a time are
    held. Checks: the image branch's B gets signal, the gene and task
    deltas (zero contexts) none; bf16 gradient cosine against the plain
    bf16 path >= 0.999 and the worst tensor's rel-L2 from the fp32 plain
    path within 2x the bf16 plain path's (the train steps' gate)."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from modaltune_tpu_torch import init_weights
    from modaltune_tpu_torch.models import LongNetEncoder
    if cfg is None:
        cfg = model_config(GIGAPATH["config"]).backbone.longnet(
            lora_adapter=True, dropout=0.0, drop_path_rate=0.0)
    check(cfg.lora_adapter, "lora_encoder_grads: the config has no LoRA")
    g = torch.Generator().manual_seed(11)
    enc = init_weights(LongNetEncoder(cfg, with_final_norm=False), g)
    n_b = lora_b_nonzero(enc, g)
    for name, p in enc.named_parameters():
        p.requires_grad_("_lora_" in name)
    length, d = bucket + 1, cfg.embed_dim
    x = torch.randn(1, length, d, generator=g)
    cot = torch.randn(1, length, d, generator=g).to(device)
    mask = (torch.arange(length) < n_valid)[None].to(device)
    models = {"bf16": enc.to(device, torch.bfloat16).eval(),
              "fp32": copy.deepcopy(enc).to(device, torch.float32).eval()}

    def grads(dtype, plain):
        m = models[dtype]
        m.zero_grad(set_to_none=True)

        def run():
            h = x.to(device, m.layers[0].final_layer_norm.weight.dtype)
            for layer in m.layers:
                h = checkpoint(layer, h, mask, use_reentrant=False) \
                    if plain else layer(h, mask)
            (h.float() * cot).sum().backward()
        run_plain(run) if plain else run()
        torch.cuda.synchronize()
        return {n: p.grad.float().flatten() for n, p in m.named_parameters()
                if p.requires_grad}

    reset_counts()
    got = grads("bf16", False)
    launches = read_counts()
    k2 = check_k2_families("lora encoder", launches,
                           len(cfg.segment_lengths) * cfg.num_layers)
    check(launches["K2f"] == launches["K2b"] ==
          len(cfg.segment_lengths) * cfg.num_layers and
          launches["K1f"] == launches["K3f"] == 0,
          f"lora encoder launches {launches}")
    plain, plain32 = grads("bf16", True), grads("fp32", True)
    signal = [n for n in got if "_B_img" in n and got[n].abs().max() > 0]
    silent = [n for n in got if ("_gene" in n or "_task" in n)
              and got[n].abs().max() > 0]
    check(len(signal) == 3 * cfg.num_layers and not silent,
          f"lora encoder: B_img with gradient {len(signal)} of "
          f"{3 * cfg.num_layers}; gene/task with gradient {silent}")
    live = [n for n in got if "_img" in n]
    cos = torch.nn.functional.cosine_similarity(
        torch.cat([got[n] for n in live]), torch.cat([plain[n] for n in live]),
        dim=0).item()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    e_k = {n: rel(got[n], plain32[n]) for n in live}
    e_p = {n: rel(plain[n], plain32[n]) for n in live}
    wk, wp = max(e_k, key=e_k.get), max(e_p, key=e_p.get)
    print(f"lora encoder: {cfg.num_layers} layers at {length} tokens "
          f"({n_valid} valid), {n_b} B matrices nonzero; gradients to "
          f"{len(got)} LoRA tensors, launches {launches}; B_img of every "
          f"layer has signal, gene/task none; kernel vs plain bf16 cosine "
          f"{cos:.6f}; worst rel-L2 from the fp32 plain path "
          f"{e_k[wk]:.3e} ({wk}) vs {e_p[wp]:.3e} plain bf16 ({wp})",
          flush=True)
    check(cos >= 0.999 and e_k[wk] <= 2 * e_p[wp],
          f"lora encoder kernel vs plain: cosine {cos:.6f}, worst tensor "
          f"{e_k[wk]:.3e} vs {e_p[wp]:.3e} plain")
    del models
    torch.cuda.empty_cache()
    return dict(launches=launches, k2_families=k2, cosine=cos,
                worst_tensor=(e_k[wk], e_p[wp]))


def phase_lora(device, card="", build_kw=None, compare_kw=None,
               encoder_kw=None):
    """ModalTune-GigaPath with the LoRA encoder variant
    (``lora_adapter``) at full width, LoRA B nonzero: one embed at the
    10,239 bucket held to the plain path, three train steps (backbone and
    its LoRA frozen, as the JAX package's ``FROZEN_KEY = "backbone"``
    freezes them) held to the plain path by the train steps' gates, every
    one of its 60 D = 48 K2f and K2b launches a step on the wgmma family
    and each held to its plain version on its own inputs
    (:func:`k2_call_readings`); then the encoder alone with gradients to
    the LoRA parameters (:func:`lora_encoder_grads`)."""
    import torch
    build_kw = build_kw or GIGAPATH_LORA
    res = {"gigapath_lora_embed": phase_slice(
        device, torch.bfloat16, card=card, build_kw=dict(build_kw, n_slides=1),
        timing_rounds=3, tag="lora slice")}
    res["gigapath_lora_train"] = phase_train(
        device, card=card, build_kw=build_kw,
        compare_kw=compare_kw or GIGAPATH_2047, tag="lora train",
        k2_calls=True)
    res["encoder"] = lora_encoder_grads(device, **(encoder_kw or {}))
    return res


def _moe_run(model, x, cot, autocast, with_aux=True):
    """``(out, aux, dx, {param: grad})`` of ``sum(out * cot)`` (+ aux
    where asked), all fp32, the forward under bf16 autocast where
    asked."""
    import torch
    x = x.clone().requires_grad_()
    model.zero_grad(set_to_none=True)
    with torch.autocast(x.device.type, dtype=torch.bfloat16,
                        enabled=autocast):
        out, aux = model(x)
    loss = (out.float() * cot).sum()
    (loss + aux if with_aux else loss).backward()
    return (out.float().detach(), aux.item(), x.grad.float(),
            {n: p.grad.float() for n, p in model.named_parameters()})


def _moe_rank(rank, n, run_dir, experts, factors):
    """Rank ``rank`` of the expert-parallel MoE: a process of an
    ``n``-rank gloo group on the one card, its token rows of the
    ``x`` and its share of the experts of the ``state`` that
    ``run_dir/inputs.pt`` holds, on its device, for each (gate type,
    capacity factor) of ``factors``, in fp32; its results saved to
    ``run_dir``."""
    import torch
    import torch.distributed as dist
    from modaltune_tpu_torch.models.extras import MoeFeedForward
    torch.backends.cuda.matmul.allow_tf32 = False
    x, state, dev = torch.load(f"{run_dir}/inputs.pt", weights_only=False)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{run_dir}/init",
                            rank=rank, world_size=n)
    try:
        d, f = state["w1"].shape[1:]
        local = experts // n
        s = x.shape[1] // n
        out = {}
        for gate_type, factor in factors:
            m = MoeFeedForward(d, f, experts, capacity_factor=factor,
                               gate_type=gate_type,
                               group=dist.group.WORLD).eval()
            m.load_state_dict({k: v if k == "gate.weight" else
                               v[rank * local:(rank + 1) * local]
                               for k, v in state.items()})
            xs = x[:, rank * s:(rank + 1) * s].to(dev)
            got = _moe_run(m.to(dev), xs, torch.ones_like(xs), False,
                           with_aux=False)
            out[gate_type] = (got[0].cpu(), got[2].cpu(),
                              {k: v.cpu() for k, v in got[3].items()})
        torch.save(out, f"{run_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_moe(device, card="", tokens=10240, dim=768, ffn=3072, experts=8,
              xpos_shape=(1, 10240, 48), bias_kw=None, timeout=300):
    """The MoE FFN at GigaPath's widths (``dim``, ``ffn``, ``experts``
    experts, ``tokens`` tokens): top-1 and top-2 gating, forward and
    backward under bf16 autocast on the card against the same weights in
    fp32 on the CPU (the routing equal, out and every gradient by
    :func:`grad_readings` at the bf16 limits, aux within 1e-5); then
    expert parallelism at a capacity that drops no token, in fp32: over a
    world of one on NCCL (the exchange a copy: bit-equal to the model
    without a group) and over two gloo ranks sharing the card, each with
    half the tokens and half the experts (out and the gradients of
    ``sum(out)`` within 1e-5 of the largest value of the single process's;
    the aux loss is each rank's own); then ``apply_xpos`` at
    ``xpos_shape`` and the T5 bias (16 heads, 1,024 x 1,024) on the card
    against the CPU."""
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from modaltune_tpu_torch import init_weights
    from modaltune_tpu_torch.models.extras import (
        MoeFeedForward, RelativePositionBias, apply_xpos, top1_gating,
        top2_gating)
    g = torch.Generator().manual_seed(21)
    x = torch.randn(1, tokens, dim, generator=g)
    cot = torch.randn(1, tokens, dim, generator=g)
    res = {}
    for gate_type in ("top1", "top2"):
        cpu = init_weights(MoeFeedForward(dim, ffn, experts,
                                          gate_type=gate_type),
                           torch.Generator().manual_seed(22)).eval()
        with torch.no_grad():
            for b in (cpu.b1, cpu.b2):
                b.normal_(0.0, 0.02, generator=g)
        card_m = copy.deepcopy(cpu).to(device)
        gating = top1_gating if gate_type == "top1" else top2_gating
        s, e = tokens, experts
        cap = max(1, int((2 if gate_type == "top2" else 1) * s / e))
        with torch.no_grad():
            want_d = gating(cpu.gate(x.reshape(s, dim)), cap)[1]
            got_d = gating(card_m.gate(x.to(device).reshape(s, dim)), cap)[1]
        moved = int((got_d.cpu() != want_d).any(dim=(1, 2)).sum())
        kept = int(want_d.any(dim=(1, 2)).sum())
        want = _moe_run(cpu, x, cot, False)
        got = _moe_run(card_m, x.to(device), cot.to(device), True)
        torch.cuda.synchronize()
        out_r = check_out(got[0], want[0].to(device), "bfloat16",
                          f"moe {gate_type} out")
        names = sorted(want[3])
        grad_r = check_grads(["x"] + names,
                             [got[2]] + [got[3][n] for n in names],
                             [want[2].to(device)] + [want[3][n].to(device)
                                                     for n in names],
                             cot.to(device), "bfloat16",
                             f"moe {gate_type} gradient")
        aux_err = abs(got[1] - want[1])
        check(moved == 0 and aux_err <= 1e-5,
              f"moe {gate_type}: {moved} tokens routed otherwise on the "
              f"card; aux {got[1]} vs {want[1]}")
        xd, cd = x.to(device), cot.to(device)
        ms = time_ms(lambda: _moe_run(card_m, xd, cd, True), iters=5,
                     warmup=1)
        res[gate_type] = dict(out=out_r, grads=grad_r, ms=ms, kept=kept)
        print(f"moe {gate_type}: {tokens} tokens, {experts} experts of "
              f"{dim} -> {ffn}, capacity {cap}: {kept} tokens routed, the "
              f"same on the card and the CPU; bf16 card vs fp32 CPU: out "
              f"rel-L2 {out_r[0]:.3e} (row-scaled {out_r[1]:.3e}), worst "
              f"gradient of x and {len(names)} parameters rel-L2 "
              f"{grad_r[0]:.3e} (row-scaled {grad_r[1]:.3e}), aux |err| "
              f"{aux_err:.2e}; forward + backward {ms:.3f} ms"
              f"{'; ' + card if card else ''}", flush=True)
        del cpu, card_m, want, got

    # expert parallelism in fp32, at capacities that drop no token
    state = {k: v.detach().clone() for k, v in init_weights(
        MoeFeedForward(dim, ffn, experts),
        torch.Generator().manual_seed(23)).state_dict().items()}
    factors = (("top1", float(experts)), ("top2", experts / 2.0))
    single = {}
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    dist.init_process_group("nccl", init_method=f"file://{run_dir}/nccl",
                            rank=0, world_size=1)
    try:
        for gate_type, factor in factors:
            outs = []
            for group in (None, dist.group.WORLD):
                m = MoeFeedForward(dim, ffn, experts, capacity_factor=factor,
                                   gate_type=gate_type, group=group).eval()
                m.load_state_dict(state)
                outs.append(_moe_run(m.to(device), x.to(device),
                                     torch.ones_like(x, device=device),
                                     False, with_aux=False))
            same = torch.equal(outs[0][0], outs[1][0]) and torch.equal(
                outs[0][2], outs[1][2]) and all(
                torch.equal(outs[0][3][k], outs[1][3][k]) for k in state)
            check(same, f"moe {gate_type}: a world of one over NCCL changed "
                  f"the result")
            single[gate_type] = outs[0]
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print("moe: expert parallelism over a world of one (NCCL): out and "
          "gradients bit-equal to the model without a group, top-1 and "
          "top-2", flush=True)
    torch.save((x, state, device), f"{run_dir}/inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_moe_rank, args=(r, 2, run_dir, experts,
                                                 factors))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, timeout - (time.perf_counter() - t0)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    check(not alive and all(p.exitcode == 0 for p in procs),
          f"expert-parallel ranks: exit codes {[p.exitcode for p in procs]}"
          f" (killed after {timeout} s: {bool(alive)})")
    ranks = [torch.load(f"{run_dir}/rank{r}.pt", weights_only=False)
             for r in range(2)]
    worst = 0.0
    for gate_type, _ in factors:
        out, _, dx, gp = single[gate_type]
        parts = [r[gate_type] for r in ranks]
        pairs = [("out", torch.cat([p[0] for p in parts], 1), out),
                 ("dx", torch.cat([p[1] for p in parts], 1), dx),
                 ("gate.weight", parts[0][2]["gate.weight"]
                  + parts[1][2]["gate.weight"], gp["gate.weight"])]
        pairs += [(k, torch.cat([p[2][k] for p in parts]), gp[k])
                  for k in ("w1", "b1", "w2", "b2")]
        for name, got_t, want_t in pairs:
            want_t = want_t.cpu()
            err = (got_t - want_t).abs().max().item() / \
                want_t.abs().max().item()
            worst = max(worst, err)
            check(err <= 1e-5, f"moe {gate_type} over two gloo ranks: "
                  f"{name} max|err| / max {err:.3e}")
    res["ep_worst"] = worst
    print(f"moe: expert parallelism over two gloo ranks sharing the card "
          f"(half the tokens and half the experts each), top-1 and top-2 "
          f"in fp32: out and gradients against one process, largest "
          f"max|err| / max {worst:.3e}", flush=True)

    # xPos and the T5 bias on the card against the CPU
    xp = torch.randn(*xpos_shape, generator=g)
    errs = {}
    for down in (False, True):
        want = apply_xpos(xp, downscale=down)
        got = apply_xpos(xp.to(device), downscale=down).cpu()
        errs[down] = (got - want).abs().max().item() / \
            want.abs().max().item()
    bias_kw = bias_kw or dict(num_buckets=32, max_distance=128,
                              num_heads=16, qlen=1024, klen=1024)
    rpb = init_weights(RelativePositionBias(
        bias_kw["num_buckets"], bias_kw["max_distance"],
        bias_kw["num_heads"]), torch.Generator().manual_seed(24))
    want_b = rpb(bias_kw["qlen"], bias_kw["klen"]).detach()
    got_b = copy.deepcopy(rpb).to(device)(bias_kw["qlen"],
                                          bias_kw["klen"]).detach().cpu()
    check(max(errs.values()) <= 1e-5 and torch.equal(got_b, want_b),
          f"xPos card vs CPU {errs}; T5 bias equal "
          f"{torch.equal(got_b, want_b)}")
    res.update(xpos_err=max(errs.values()))
    print(f"extras: apply_xpos {tuple(xpos_shape)} card vs CPU max|err| / "
          f"max {max(errs.values()):.3e} (up and down scaling); T5 bias "
          f"{tuple(want_b.shape)} bit-equal", flush=True)
    return res


# ---------------------------------------------------------------------------
# Dataset preparation on the card (data/pipeline.py, data/extract.py)
# ---------------------------------------------------------------------------

def card_tile_encoder(device, out_dim, seed):
    """A stand-in tile encoder on the card with seeded weights (the real
    tile weights are external): uint8 tiles ``(N, s, s, 3)`` -> RGB
    average-pooled to 16 x 16 -> a linear map to ``out_dim`` -> numpy
    fp32 ``(N, out_dim)``."""
    import torch
    import torch.nn.functional as F
    w = (torch.randn(768, out_dim, generator=torch.Generator().manual_seed(
        seed)) / math.sqrt(768)).to(device)

    def encode(tiles):
        t = torch.from_numpy(tiles).to(device).permute(0, 3, 1, 2).float()
        t = F.adaptive_avg_pool2d(t / 255.0, 16).flatten(1)
        return (t @ w).cpu().numpy()
    return encode


def card_text_encoder(device, seed, dim=512):
    """A stand-in text tower on the card with seeded weights (CONCH is
    external): each prompt's byte histogram through a linear map to
    ``dim``."""
    import numpy as np
    import torch
    w = (torch.randn(256, dim, generator=torch.Generator().manual_seed(seed))
         / 16.0).to(device)

    def encode(texts):
        counts = np.zeros((len(texts), 256), np.float32)
        for i, t in enumerate(texts):
            np.add.at(counts[i], np.frombuffer(t.encode(), np.uint8), 1.0)
        return (torch.from_numpy(counts).to(device) @ w).cpu().numpy()
    return encode


PREPARE_FLAGS = ["--mil_name", "longnetvit_gene_adapter", "--bf16", "1",
                 "--buckets", "2047", "--num_epochs", "1",
                 "--eval_interval", "1", "--seed", "0"]


def phase_prepare(device, card="", seed=0, tiles=1800, in_chans=1536,
                  n_genes=4987, n_groups=331, max_size=100, flags=None,
                  titan_tiles=2000, titan_cfg=None, titan_bucket=4095):
    """Dataset preparation end to end on a synthetic TCGA site
    (:func:`write_tcga_site`, seed ``seed``), then training on what it
    wrote. ``pipeline.load_labelset`` (the available slides only) ->
    ``make_splits`` (the split JSONs), ``prepare_clinical_features``,
    ``generate_prompts`` and ``make_text_embeddings`` (a stand-in text
    tower on the card), ``process_gene_matrix`` on a synthetic Xena
    matrix (constant genes, a second sample of a case); every slide of
    the splits through ``extract.extract_slide_features``
    (:func:`synthetic_slide`, 256-px tiles, about ``tiles`` a case; a
    stand-in tile encoder on the card, ``in_chans`` wide) into the
    ``.npz`` bags the JSONs name; then the train CLI in-process on those
    files (``PREPARE_FLAGS``: one epoch at the 2,047 bucket) with K1f,
    K1b, K2f and K2b launched. Separately ``extract_slide_features_titan``
    on a slide of about ``titan_tiles`` 512-px tiles (a 768-d stand-in
    patch encoder) with the port's TitanViT in bf16 as its slide encoder
    (``grid_scatter_bag`` into ``titan_bucket`` cells): 6 K4f launches,
    the slide embedding held to the plain path. Prints the host seconds
    of every step."""
    import tempfile

    import numpy as np
    import torch
    from modaltune_tpu_torch import init_weights
    from modaltune_tpu_torch.data import extract, pipeline
    from modaltune_tpu_torch.data import datasets as data_mod
    from modaltune_tpu_torch.models import TitanViT, grid_scatter_bag
    from modaltune_tpu_torch.tools import train as cli
    from modaltune_tpu_torch.train import trainer as trainer_mod
    flags = PREPARE_FLAGS if flags is None else flags
    seconds = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        site = timed("write_site", lambda: write_tcga_site(root, seed))
        df = timed("load_labelset", lambda: pipeline.load_labelset(
            "brca", site["clinical"], site["slide"],
            available_slide_ids=list(site["slides"])))
        splits = timed("make_splits", lambda: pipeline.make_splits(
            df, str(root / "features"), site["gene_case_ids"],
            str(root / "splits"), "brca", seed=seed))
        clinical = timed("prepare_clinical_features",
                         lambda: pipeline.prepare_clinical_features(
                             df, str(root / "clinical.npz")))
        rows = pipeline.frame_records(pipeline.drop_duplicates(
            df, ("case_id",)))
        prompts = timed("generate_prompts",
                        lambda: pipeline.generate_prompts(rows, "brca"))
        text = timed("make_text_embeddings",
                     lambda: pipeline.make_text_embeddings(
                         rows, "brca", card_text_encoder(device, seed + 1),
                         str(root / "text.npz")))
        rng = np.random.default_rng(seed + 2)
        samples = [f"{c}-01A" for c in site["gene_case_ids"]]
        samples.append(f"{site['gene_case_ids'][0]}-11A")
        expr = rng.standard_normal((n_genes + 3, len(samples)))
        expr[-3:] = 2.0                      # constant genes
        frame = {"sample": [f"g{i}" for i in range(n_genes)]
                 + ["c0", "c1", "c2"]}
        frame.update({s: expr[:, j].tolist() for j, s in enumerate(samples)})
        genes = timed("process_gene_matrix",
                      lambda: pipeline.process_gene_matrix(
                          frame, [f"g{i}" for i in range(n_genes)],
                          output_csv=str(root / "genes.csv")))
        write_pathway_csv(root / "pathways.csv", n_genes, n_groups, max_size)
        n_rows = {k: len(v) for k, v in splits.items()}
        check(min(n_rows.values()) > 0 and len(clinical) == len(rows) and
              all(len(v) == len(rows) for v in prompts.values()) and
              all(v.shape == (4, 512) for v in text.values()) and
              len(genes["case_id"]) == len(site["gene_case_ids"]) and
              len(genes) == n_genes + 1,
              f"prepare: split rows {n_rows}, {len(clinical)} clinical "
              f"vectors, {len(text)} text tables, gene frame "
              f"{len(genes['case_id'])} x {len(genes) - 1}")

        # every slide the splits name, through the tile encoder on the card
        encode = card_tile_encoder(device, in_chans, seed + 3)
        (root / "features").mkdir()
        slide_ids = sorted({r["slide_submitter_id"] for v in splits.values()
                            for r in v})
        per_case = {}
        for r in rows:
            per_case[r["case_id"]] = sum(
                1 for v in splits.values() for x in v
                if x["case_id"] == r["case_id"])
        n_tiles = []

        def extract_all():
            for i, sid in enumerate(slide_ids):
                case = next(r for v in splits.values() for r in v
                            if r["slide_submitter_id"] == sid)
                read_region, thumb, ds = synthetic_slide(
                    seed * 1000 + i, tiles // per_case[case["case_id"]])
                bag = extract.extract_slide_features(
                    read_region, extract.tissue_mask(thumb), ds, encode,
                    output_npz=case["features_path"])
                n_tiles.append(len(bag["features"]))
        timed("extract_slide_features", extract_all)
        feats, _ = data_mod.load_feature_bag(splits["test"][0]
                                             ["features_path"])
        check(feats.shape[1] == in_chans and np.isfinite(feats).all(),
              f"prepare: bag {feats.shape}")
        print(f"prepare: site of {site['n_cases']} cases -> "
              f"{len(rows)} cases with a slide and a diagnosis, split rows "
              f"{n_rows}, {len(slide_ids)} slides of {min(n_tiles)}-"
              f"{max(n_tiles)} tiles ({sum(n_tiles)} in all) encoded on the "
              f"card to {in_chans}-d; gene CSV {len(genes['case_id'])} cases "
              f"x {len(genes) - 1} genes", flush=True)

        # the CLI on the prepared files
        split_dir = root / "splits"
        args = cli.build_parser().parse_args(flags + [
            "--train_json", str(split_dir / "train_brca_cls_feat.json"),
            "--val_json", str(split_dir / "val_brca_cls_feat.json"),
            "--test_json", str(split_dir / "test_brca_cls_feat.json"),
            "--genomics_csv_path", str(root / "genes.csv"),
            "--pathway_csv", str(root / "pathways.csv"),
            "--text_location", str(root / "text.npz"),
            "--output_path", str(root / "results"),
            "--device", device.type])
        t = time.perf_counter()
        trainer, run_s, launches, peak, wall = run_cli(
            cli, args, trainer_mod.ModalTuneTrainer, ("train_one_epoch",))
        seconds["train_cli"] = time.perf_counter() - t
        metrics = [json.loads(line) for line in
                   open(root / "results" / "seed_0" / "run_metrics.jsonl")]
        losses = [r["train_loss"] for r in metrics if "train_loss" in r]
        check(len(losses) == 1 and all(math.isfinite(x) for x in losses),
              f"prepare: epoch losses {losses}")
        check(all(launches[k] > 0 for k in ("K1f", "K1b", "K2f", "K2b")),
              f"prepare: launches {launches}")
        print(f"prepare: the train CLI on the prepared files: "
              f"{len(trainer.step_ms)} steps, median "
              f"{statistics.median(trainer.step_ms):.2f} ms/step, epoch "
              f"loss {losses[0]:.6f}, run_one_seed {wall:.1f} s, peak "
              f"allocated {peak / 2**30:.3f} GiB, launches {launches}"
              f"{'; ' + card if card else ''}", flush=True)

        # TITAN: 512-px tiles, a stand-in patch encoder, TitanViT in bf16
        tcfg = titan_cfg or model_config(TITAN["config"]).backbone
        vit = init_weights(TitanViT(tcfg), torch.Generator().manual_seed(
            seed + 4)).to(device, torch.bfloat16).eval()

        def slide_encoder(features, coords):
            tokens, gc, valid = grid_scatter_bag(
                features, coords, tcfg.patch_size_lv0, bucket=titan_bucket)
            with torch.no_grad():
                out = vit(torch.from_numpy(tokens)[None].to(
                    device, torch.bfloat16),
                    torch.from_numpy(gc)[None].to(device),
                    torch.from_numpy(valid)[None].to(device))
            return out.float()[0].cpu().numpy()

        read_region, thumb, ds = synthetic_slide(seed + 5, titan_tiles,
                                                 tile=512)
        patch = card_tile_encoder(device, tcfg.in_dim, seed + 6)
        reset_counts()
        bag = timed("extract_slide_features_titan",
                    lambda: extract.extract_slide_features_titan(
                        read_region, extract.tissue_mask(thumb), ds, patch,
                        slide_encoder=slide_encoder,
                        output_npz=str(root / "titan.npz")))
        titan_launches = read_counts()
        want = {k: tcfg.depth * (k == "K4f") for k in titan_launches}
        check(titan_launches == want,
              f"titan extract launches {titan_launches} != {want}")
        plain = run_plain(lambda: slide_encoder(bag["features"],
                                                bag["coords"]))
        emb = bag["slide_embedding"]
        cos = float(emb @ plain / np.linalg.norm(emb) / np.linalg.norm(plain))
        rel = float(np.linalg.norm(emb - plain) / np.linalg.norm(plain))
        cells = int(grid_scatter_bag(bag["features"], bag["coords"],
                                     tcfg.patch_size_lv0)[2].sum())
        print(f"prepare: TITAN extraction: {len(bag['features'])} tiles of "
              f"512 px -> {tcfg.in_dim}-d on the card, {cells} foreground "
              f"cells in the {titan_bucket} bucket, slide embedding "
              f"{emb.shape} by TitanViT in bf16 (K4f {titan_launches['K4f']})"
              f"; against the plain path cosine {cos:.6f}, rel-L2 "
              f"{rel:.3e}", flush=True)
        check(np.isfinite(emb).all() and cos >= 0.999 and rel <= 2e-2,
              f"titan extract vs plain: cosine {cos:.6f}, rel-L2 {rel:.3e}")
    print(f"prepare: host seconds {json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
          flush=True)
    return dict(gigapath_prepare=dict(launches=launches, seconds=seconds,
                                      losses=losses, peak_bytes=peak),
                titan_extract=dict(launches=titan_launches, cosine=cos,
                                   rel_l2=rel))


# ---------------------------------------------------------------------------
# Profiling on the card (utils/profiling.py, tools/trace_report.py)
# ---------------------------------------------------------------------------

# substrings of the kernel names of each kernel on the default route's
# train step (as profile_train.GROUPS names them)
PROFILE_CLASSES = {"K1f": "dilated_fwd", "K1b": "dilated_bwd",
                   "K2f": "flash_fwd", "K2b": "flash_bwd"}


def phase_profile(device, card="", build_kw=None, steps=2):
    """``utils.profiling.trace`` around ``steps`` GigaPath train steps
    (default route, 10,239 unless ``build_kw``), each timed by a
    ``StepTimer``, then ``tools/trace_report`` over the trace it wrote:
    the report takes the device's events, names a class of each of K1f,
    K1b, K2f and K2b, and its per-step device total lies within 10 % of
    :func:`device_times` of the same step. Prints the ten classes with the
    most device time and the timer's summary."""
    import tempfile
    import torch
    from modaltune_tpu_torch import make_train_step
    from modaltune_tpu_torch.tools import trace_report
    from modaltune_tpu_torch.utils.profiling import StepTimer, trace
    build_kw = build_kw or GIGAPATH
    model, tcfg, opt, text, batch = build_train(device, **build_kw)
    step = make_train_step(model, tcfg, opt)
    gen = torch.Generator(device=device).manual_seed(3)
    step(batch, text, gen)
    torch.cuda.synchronize()
    timer = StepTimer()
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            for _ in range(steps):
                timer.start()
                timer.stop(step(batch, text, gen))
        rep = trace_report.summarize(trace_report.load_events(log_dir),
                                     steps=steps)
    dev_ms, _ = device_times(lambda: step(batch, text, gen), iters=steps,
                             warmup=0)
    if dev_ms is None:   # the profiler saw nothing: the steps by events
        dev_ms = time_ms(lambda: step(batch, text, gen), iters=steps,
                         warmup=0)
    print(f"profile: trace_report over {steps} traced train steps at "
          f"bucket {batch['bag'].shape[1]}, the ten op classes with the "
          f"most device time:", flush=True)
    trace_report.print_report(rep, top=10)
    print(f"profile: StepTimer {json.dumps(timer.summary())}", flush=True)
    classes = list(rep["ms_per_step"])
    named = {k: [c for c in classes if sub in c]
             for k, sub in PROFILE_CLASSES.items()}
    total = rep["total_ms_per_step"]
    off = abs(total - dev_ms) / dev_ms
    print(f"profile: report's device total {total:.3f} ms/step against "
          f"device_times {dev_ms:.3f} ms/step ({100 * off:.2f} % apart); "
          f"kernel classes {json.dumps(named)}{'; ' + card if card else ''}",
          flush=True)
    check(rep["lane"] == "device" and all(named.values()) and off <= 0.10,
          f"profile: lane {rep['lane']}, classes {named}, total {total:.3f} "
          f"vs {dev_ms:.3f} ms")
    del model, opt, step
    torch.cuda.empty_cache()
    return dict(total_ms=total, device_ms=dev_ms, summary=timer.summary(),
                top=dict(list(rep["ms_per_step"].items())[:10]))


# ---------------------------------------------------------------------------
# The flagship: the reference's 25,599-token geometry, through the steps and
# the CLI, and the LongNet layers' rematerialization
# ---------------------------------------------------------------------------

# (name, LongNetConfig.remat, remat_policy) of the train steps compared
REMAT_RUNS = (("off", False, "flash"), ("flash", True, "flash"),
              ("full", True, "full"))
# the CLI's cohort at the reference's threshold: bags of 24,000-30,000
# tiles (the first train case two slides of 12,000-15,000), which
# --threshold 25000 cuts to 25,000 by its sorted subsample
# (data/datasets.py:245-246), all in the default buckets' 25,599
FLAGSHIP_DATA = dict(TRAINER_DATA, two_slides=(12000, 15000),
                     one_slide=(24000, 30000))
FLAGSHIP_FLAGS = ["--mil_name", "longnetvit_gene_adapter", "--bf16", "1",
                  "--threshold", "25000", "--num_epochs", "2",
                  "--eval_interval", "1", "--save_interval", "1",
                  "--save_embeddings", "--seed", "0"]


def with_remat(build_kw, remat, policy):
    """``build_kw`` whose model configuration's backbone has ``remat`` and
    ``remat_policy`` (``LongNetViTConfig`` forwards both to every LongNet
    layer)."""
    cfg = build_kw.get("cfg") or model_config(build_kw["config"])
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, remat=remat, remat_policy=policy))
    return dict(build_kw, cfg=cfg)


def live_storages():
    """A dispatch mode that records, by weak reference, every storage an op
    makes while it is on (not a view of its inputs'); ``alive()`` lists the
    sizes of those still alive: what a layer's forward leaves for the
    backward, in the bytes of its tensors rather than of the allocator's
    blocks, which keep up to 1 MiB more where a cached block is not split."""
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Live(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            inputs = {t.untyped_storage().data_ptr()
                      for t in tree_flatten((args, kwargs))[0]
                      if hasattr(t, "untyped_storage")}
            for t in tree_flatten(out)[0]:
                if hasattr(t, "untyped_storage") and \
                        t.untyped_storage().nbytes():
                    st = t.untyped_storage()
                    if st.data_ptr() not in inputs:
                        self.made.append((StorageWeakRef(st), st.data_ptr(),
                                          st.nbytes()))
            return out

        def alive(self):
            return sorted({ptr: n for ref, ptr, n in self.made
                           if not ref.expired()}.values(), reverse=True)
    return Live()


def grad_step_readings(device, model, tcfg, text, batch, layer=None,
                       seed=3):
    """One grad step (``make_grad_step``, no update) from ``model``'s
    weights on ``batch`` with a generator seeded ``seed`` -> (loss, {name:
    gradient on the host}, the device bytes that LongNet layer ``layer``
    leaves allocated from its forward's start to its end: what the
    backward keeps of it, its output included; None without ``layer``;
    JAX's ``"flash"`` set for that layer by :func:`flash_keep_bytes`, or
    None; the sizes of the storages its forward made that are alive at its
    end (:func:`live_storages`), or None)."""
    import torch
    from modaltune_tpu_torch import make_grad_step
    kept, hooks, jax_set, live = [], [], [], []
    if layer is not None:
        mod = model.backbone.encoder.layers[layer]
        mode = live_storages()

        def before(*_):
            kept.append(-torch.cuda.memory_allocated())
            mode.__enter__()

        def after(_, __, out):
            mode.__exit__(None, None, None)
            kept.append(torch.cuda.memory_allocated())
            jax_set.append(flash_keep_bytes(mod.cfg, out))
            live.append(mode.alive())
        hooks = [mod.register_forward_pre_hook(before),
                 mod.register_forward_hook(after)]
    gen = torch.Generator(device=device).manual_seed(seed)
    try:
        loss, grads = make_grad_step(model, tcfg)(batch, text, gen)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    grads = {n: g.detach().float().cpu() for n, g in grads.items()}
    return (float(loss), grads, sum(kept) if kept else None,
            jax_set[0] if jax_set else None, live[0] if live else None)


def flash_keep_bytes(cfg, out) -> int:
    """What JAX's ``"flash"`` policy keeps of one LongNet layer of ``cfg``
    (a ``LongNetConfig``) whose output is ``out`` (B, L, d), by
    arithmetic: the output and the attention's output, ``out``'s size
    each, and what the attention's backward kernel reads besides q/k/v:
    K1's stats (B*H, n + 2, L) fp32, or on the fused route K3's compact
    lses (B, H, M) and m, Z (2, B, H, L) fp32."""
    from modaltune_tpu_torch.ops.dilated_fused import total_rows
    b, length, _ = out.shape
    h, segs, ratios = cfg.num_heads, cfg.segment_lengths, cfg.dilated_ratios
    rows = (total_rows(length, segs, ratios) + 2 * length
            if not cfg.mega_attention else (len(segs) + 2) * length)
    return 2 * out.numel() * out.element_size() + 4 * b * h * rows


def step_difference(a, b):
    """(largest |difference| of the loss or of any gradient element, the
    tensors that differ) between two :func:`grad_step_readings`."""
    import torch
    (la, ga, *_), (lb, gb, *_) = a, b
    check(ga.keys() == gb.keys(), "grad steps of different parameters")
    differ = [n for n in ga if not torch.equal(ga[n], gb[n])]
    worst = max([abs(la - lb)] + [(ga[n] - gb[n]).abs().max().item()
                                  for n in differ])
    return worst, differ


def flagship_k2_shapes(length, n_valid):
    """:data:`K2_SHAPES`' adapter calls at a bucket of ``length`` tokens
    (the cls token included), ``n_valid`` of them valid: the injector and
    the extractor, named by the bucket (the prompt's 65 x 65 does not
    change)."""
    lk = length - 1
    return [(f"injector_{lk}", 36, lk, 65, 16, 0.0, False),
            (f"extractor_{lk}", 36, 65, lk, 16, (lk - n_valid) / lk, True)]


def phase_flagship(device, card="", build_kw=None, ref_kws=None, layer=6,
                   timed_steps=5, b2_steps=3, b4_steps=2, k1_kw=None,
                   trainer_kw=None):
    """ModalTune-GigaPath at the reference's 25,599 bucket
    (``GIGAPATH_25599``; ``build_kw`` and ``ref_kws``, the 10,239 and
    2,047 ones, to rehearse on the CPU), through the public entry
    points:

    * the default route's train step, B = 1, under remat off, ``"flash"``
      and ``"full"`` (:func:`drive_train`: launch counts, K1f 12 a step
      under ``"flash"`` and 24 under ``"full"``; ms/step and peak), each
      model fresh from the same seed; first one grad step each from the
      same weights, batch and generator state, held bit for bit to remat
      off within remat off's own run-to-run difference (two runs), and
      the bytes that LongNet layer ``layer`` keeps for the backward, under
      ``"flash"`` exactly JAX's ``"flash"`` set (:func:`flash_keep_bytes`);
    * the embed step there (:func:`phase_slice`);
    * the fused route (K3 + K5), its train step with remat off and under
      ``"flash"``, one grad step each held bit for bit to remat off as
      above (the bytes layer ``layer`` keeps printed beside JAX's
      ``"flash"`` set), its embeddings held to the default route's;
    * B = 2 and B = 4 on the default route under ``"flash"``: ``b2_steps``
      and ``b4_steps`` checked steps, ms/step and peak; remat off's peak at
      B = 2 predicted from B = 1's readings, not run;
    * every kernel of these paths at the shapes they give it, against its
      plain version with the gates of the 10,240 shape: K1f, K1b, K3f and
      K3b at (3, 25,600, 16, 48), 24,000 valid tokens (the plain versions
      run a batch row at a time; ``k1_kw`` overrides), K2f and K2b at the
      adapter's injector and extractor over 25,599 tokens, K5f and K5b at
      the FFN's (76,800, 3,072);
    * the cost of ``"flash"`` against remat off at 10,239 and at 2,047
      (where the step waits on the host; ``2 * timed_steps`` steps there),
      in turn, with the time Python's garbage collector takes a step;
    * the train CLI at ``--threshold 25000`` with the default buckets on
      ``FLAGSHIP_DATA``'s cohort, every batch in the 25,599 bucket
      (:func:`phase_trainer`; ``trainer_kw`` overrides).

    -> the paths' readings by name, the kernels' readings at the
    flagship's shapes by kernel (``at_25600``) and the remat table."""
    import torch
    build_kw = build_kw or dict(GIGAPATH, **GIGAPATH_25599)
    ref_kws = ref_kws or (GIGAPATH, dict(GIGAPATH, **GIGAPATH_2047))
    paths, runs = {}, {}
    names = {"off": "gigapath_flagship_off_train",
             "flash": "gigapath_flagship_train",
             "full": "gigapath_flagship_full_train"}
    for name, remat, policy in REMAT_RUNS:
        tag = f"flagship train remat {name}"
        model, tcfg, opt, text, batch = timed_build(
            device, tag, with_remat(build_kw, remat, policy))
        reads = [grad_step_readings(device, model, tcfg, text, batch,
                                    layer=layer)]
        if name == "off":
            reads.append(grad_step_readings(device, model, tcfg, text,
                                            batch))
        r = drive_train(device, model, tcfg, opt, text, batch, tag, card,
                        timed_steps=timed_steps)
        r.update(reads=reads, kept=reads[0][2], jax_kept=reads[0][3],
                 live=reads[0][4], layers=len(model.backbone.encoder.layers))
        runs[name] = paths[names[name]] = r
        del model, opt, batch, reads
        torch.cuda.empty_cache()
    off = runs["off"]["reads"]
    noise, noisy = step_difference(off[0], off[1])
    print(f"flagship remat: remat off against itself, the same weights, "
          f"batch and generator state: largest difference of the loss or "
          f"a gradient {noise:.3e} ({len(noisy)} tensors differ"
          f"{': ' if noisy else ''}{', '.join(noisy[:5])})", flush=True)
    for name in ("flash", "full"):
        diff, differ = step_difference(runs[name]["reads"][0], off[0])
        runs[name]["difference"] = diff
        print(f"flagship remat: {name!r} against remat off: largest "
              f"difference {diff:.3e} ({len(differ)} tensors differ"
              f"{': ' if differ else ''}{', '.join(differ[:5])})",
              flush=True)
        check(diff <= noise, f"flagship remat {name!r}: loss or gradients "
              f"{diff:.3e} from remat off, its own run-to-run {noise:.3e}")
    for name, r in runs.items():
        print(f"flagship remat {name}: {r['ms']:.2f} ms/step, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB, LongNet layer {layer} "
              f"keeps {r['kept']} B ({r['kept'] / 2**20:.1f} MiB) for the "
              f"backward (its output included); {card}", flush=True)
    flash = runs["flash"]
    check(flash["kept"] == flash["jax_kept"] == sum(flash["live"]),
          f"flagship remat 'flash': LongNet layer {layer} keeps "
          f"{flash['kept']} B ({sum(flash['live'])} B in the storages "
          f"{flash['live']}), JAX's 'flash' set {flash['jax_kept']} B")
    print(f"flagship remat 'flash': LongNet layer {layer} keeps exactly "
          f"JAX's 'flash' set, {flash['jax_kept']} B (arithmetic: the "
          f"output, K1's output and its stats; no q/k/v, no branch "
          f"output)", flush=True)
    check(flash["launches"]["K1f"] == flash["layers"] * len(flash["losses"]),
          f"flagship: K1f launched {flash['launches']['K1f']} times in "
          f"{len(flash['losses'])} steps under 'flash', not once a layer")
    print(f"flagship remat: K1f launched once a layer a step under 'flash' "
          f"({flash['launches']['K1f']} in {len(flash['losses'])} steps of "
          f"{flash['layers']} layers), twice under 'full' "
          f"({runs['full']['launches']['K1f']})", flush=True)

    embed = phase_slice(device, torch.bfloat16, card=card, build_kw=build_kw,
                        timing_rounds=2, tag="flagship slice",
                        compare_kw=GIGAPATH_2047)
    paths["gigapath_flagship_embed"] = embed

    fused = {}
    for name, remat in (("off", False), ("flash", True)):
        tag = f"flagship fused train remat {name}"
        model, tcfg, opt, text, batch = timed_build(
            device, tag, with_remat(dict(build_kw, route="fused"), remat,
                                    "flash"))
        fused[name] = [grad_step_readings(device, model, tcfg, text, batch,
                                          layer=layer if i == 0 else None)
                       for i in range(2 if name == "off" else 1)]
        key = ("gigapath_flagship_fused_train" if remat
               else "gigapath_flagship_fused_off_train")
        r = paths[key] = drive_train(device, model, tcfg, opt, text, batch,
                                     tag, card, timed_steps=timed_steps)
        r.update(kept=fused[name][0][2], jax_kept=fused[name][0][3],
                 live=fused[name][0][4])
        runs[f"fused_{name}"] = r
        print(f"flagship fused remat {name}: LongNet layer {layer} keeps "
              f"{r['kept']} B of allocator blocks for the backward (its "
              f"output included), {sum(r['live'])} B in "
              f"{r['live'] if remat else len(r['live'])} storages; JAX's "
              f"'flash' set by arithmetic "
              f"{r['jax_kept']} B (the output, K3's mixed output, its "
              f"compact lses, m and Z); {card}", flush=True)
        if remat:
            check(sum(r["live"]) == r["jax_kept"],
                  f"flagship fused remat 'flash': LongNet layer {layer}'s "
                  f"storages {r['live']} hold {sum(r['live'])} B, JAX's "
                  f"'flash' set {r['jax_kept']} B")
        del model, opt, batch
        torch.cuda.empty_cache()
    noise, _ = step_difference(*fused["off"])
    diff, differ = step_difference(fused["flash"][0], fused["off"][0])
    print(f"flagship fused remat: 'flash' against remat off: largest "
          f"difference {diff:.3e} ({len(differ)} tensors differ"
          f"{': ' if differ else ''}{', '.join(differ[:5])}); remat off "
          f"against itself {noise:.3e}", flush=True)
    check(diff <= noise, f"flagship fused remat 'flash': loss or gradients "
          f"{diff:.3e} from remat off, its own run-to-run {noise:.3e}")
    del fused
    paths["gigapath_flagship_fused_embed"] = phase_slice(
        device, torch.bfloat16, card=card,
        build_kw=dict(build_kw, route="fused"), timing_rounds=2,
        tag="flagship fused slice", compare_kw=GIGAPATH_2047,
        agree_with=embed["outs"])

    for n_rows, steps in ((2, b2_steps), (4, b4_steps)):
        tag = f"flagship B={n_rows} train remat flash"
        model, tcfg, opt, text, batch = timed_build(
            device, tag, with_remat(dict(build_kw, n_slides=n_rows,
                                         batch_size=n_rows), True, "flash"))
        r = drive_train(device, model, tcfg, opt, text, batch, tag, card,
                        steps=steps, timed_steps=steps)
        runs[f"flash_b{n_rows}"] = paths[f"gigapath_flagship_b{n_rows}_train"] = r
        del model, opt, batch
        torch.cuda.empty_cache()
    b2, b4 = runs["flash_b2"], runs["flash_b4"]
    one = runs["off"]
    predicted = one["base_bytes"] + 2 * (one["peak_bytes"] - one["base_bytes"])
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"flagship B=2: 'flash' {b2['ms']:.2f} ms/step, peak "
          f"{b2['peak_bytes'] / 2**30:.3f} GiB of the card's "
          f"{total / 2**30:.3f}; remat off at B = 2, not run, predicted from "
          f"B = 1 (arithmetic: held {one['base_bytes'] / 2**30:.3f} GiB + 2 x "
          f"{(one['peak_bytes'] - one['base_bytes']) / 2**30:.3f} GiB of "
          f"step) {predicted / 2**30:.3f} GiB; {card}", flush=True)
    print(f"flagship B=4: 'flash' {b4['ms']:.2f} ms/step, peak "
          f"{b4['peak_bytes'] / 2**30:.3f} GiB of the card's "
          f"{total / 2**30:.3f}; {card}", flush=True)

    k1_kw = dict(dict(shape=(3, 25600, 16, 48), n_valid=24000,
                      plain_rows=True), **(k1_kw or {}))
    shape, n_valid = k1_kw["shape"], k1_kw["n_valid"]
    k2_shapes = flagship_k2_shapes(shape[1], n_valid)
    big = {"K1f": phase_k1(device, iters=5, cuda_cores_shape=None, **k1_kw),
           "K1b": phase_k1b(device, **k1_kw),
           "K3f": phase_k3(device, iters=5, cuda_cores_shape=None,
                           **k1_kw),
           "K3b": phase_k3b(device, **k1_kw),
           "K2f": phase_k2(device, shapes=k2_shapes, iters=10),
           "K2b": phase_k2b(device, shapes=k2_shapes, iters=10),
           "K5f": phase_k5(device, shape=(shape[0] * shape[1], 3072),
                           iters=10),
           "K5b": phase_k5b(device, shape=(shape[0] * shape[1], 3072),
                            iters=10)}

    for ref_kw in ref_kws:
        bucket = ref_kw["bucket"]
        for name, remat in (("off", False), ("flash", True)):
            tag = f"remat {name} train @ {bucket}"
            model, tcfg, opt, text, batch = timed_build(
                device, tag, with_remat(ref_kw, remat, "flash"))
            r = drive_train(device, model, tcfg, opt, text, batch, tag, card,
                            timed_steps=timed_steps * (2 if bucket < 4095
                                                       else 1))
            runs[f"{name}_{bucket}"] = r
            if not remat:
                paths[f"gigapath_{bucket}_off_train"] = r
            del model, opt, batch
            torch.cuda.empty_cache()
        a, b = (runs[f"{n}_{bucket}"] for n in ("off", "flash"))
        print(f"remat cost at {bucket}: 'flash' {b['ms']:.2f} against off "
              f"{a['ms']:.2f} ms/step ({b['ms'] / a['ms']:.3f}x), of which "
              f"Python's garbage collector {b['gc_ms']:.2f} against "
              f"{a['gc_ms']:.2f} ms a step; peak "
              f"{b['peak_bytes'] / 2**30:.3f} against "
              f"{a['peak_bytes'] / 2**30:.3f} GiB; {card}", flush=True)

    trainer_kw = trainer_kw or dict(data_kw=FLAGSHIP_DATA,
                                    flags=FLAGSHIP_FLAGS, want_bucket=25599)
    paths["gigapath_flagship_trainer"] = phase_trainer(
        device, card=card, tag="flagship trainer", **trainer_kw)
    return dict(paths=paths, at_25600=big,
                remat={n: dict({k: r[k] for k in ("ms", "peak_bytes", "kept",
                                                  "jax_kept", "gc_ms")
                                if k in r},
                               **({"kept_in_storages": sum(r["live"])}
                                  if r.get("live") is not None else {}))
                       for n, r in runs.items()})


# ---------------------------------------------------------------------------
# A whole training schedule: the kernel paths against the plain paths
# ---------------------------------------------------------------------------

# the reference's schedule (train_modaltune.py:64-65,151-154): ten warmup
# epochs from lr/20, then four cosine ones; kd_loss_scale at its default, 10
MULTIEPOCH_TRAIN = dict(lr=5e-4, weight_decay=0.01, num_epochs=14,
                        warmup_epochs=10, warmup_factor=20.0,
                        temperature=1.0)
# a learnable synthetic cohort at the 2,047 bucket, where the plain path's
# saved scores fit: 6 train cases (the reference's epoch cap), 8 val, 8
# test (12 each took the phase past its 240 s budget), from seeds 0, 1, 2
MULTIEPOCH_DATA = dict(cases=(6, 8, 8), in_chans=1536,
                       bag_range=GIGAPATH_2047["bag_range"],
                       bucket=GIGAPATH_2047["bucket"])
# run -> (the frozen backbone's dtype, plain): bf16 under autocast as
# ``--bf16 1`` users train, or fp32; the kernels or every kernel entry
# point patched to its plain version (``run_plain``)
MULTIEPOCH_RUNS = {"k16": ("bfloat16", False), "p16": ("bfloat16", True),
                   "k32": ("float32", False), "p32": ("float32", True)}
# kernel path against plain path, epoch by epoch (PERF.md section 2)
TRAJECTORY_FP32 = 5e-3
TRAJECTORY_BF16_FLOOR = 5e-3
# the readout bands of tests/test_multiepoch_parity.py
BAND_C_INDEX = 0.10
BAND_BAL_ACC = 0.17


def learnable_cohort(cases, in_chans, bag_range, bucket, n_genes=4987,
                     n_groups=331, max_size=100):
    """``SyntheticSlideDataset(learnable=True)`` train, val and test splits
    of ``cases`` slides each (seeds 0, 1, 2), over the synthetic pathway
    table; every bag fits ``bucket``."""
    from modaltune_tpu_torch.data import SyntheticSlideDataset
    packer = synthetic_packer(n_genes, n_groups, max_size)
    check(bag_range[1] <= bucket,
          f"bags of up to {bag_range[1]} tiles do not fit the {bucket} "
          f"bucket")
    return {name: SyntheticSlideDataset(
        n_cases=n, in_chans=in_chans, bag_range=bag_range, packer=packer,
        n_genes=n_genes, seed=seed, learnable=True)
        for seed, (name, n) in enumerate(zip(("train", "val", "test"),
                                              cases))}


def family_times(device, bucket, n_valid, iters=10):
    """The kernels a train step at ``bucket`` launches, timed in each
    dtype's family on random inputs at its shapes (K1f with its stats and
    K1b at (3, bucket + 1, 16, 48) with ``n_valid`` valid tokens, K1b's
    family, its time on the card and split by kernel there, its bound: at
    fp32 at 3xTF32 and on the CUDA cores; K2f and K2b at the adapter's
    Injector, Extractor and prompt shapes) -> {dtype: {kernel: ms}};
    printed."""
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    dm = importlib.import_module(COUNTERS["K1f"][0])
    df = importlib.import_module(COUNTERS["K3b"][0])
    fa = importlib.import_module(COUNTERS["K2f"][0])
    ln = SlideEncoderConfig().longnet()
    seg, rat = ln.segment_lengths, ln.dilated_ratios
    shape = (3, bucket + 1, 16, 48)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dtn = str(dtype)[6:]
        r = out[dtn] = {}
        (q, k, v, dmix), mask = k1_inputs(shape, n_valid, device, dtype,
                                          seed=9, n_tensors=4)

        def fwd():
            return dm.mega_dilated_attention_cuda(q, k, v, mask, seg, rat,
                                                  48 ** -0.5, with_stats=True)
        _, stats = fwd()

        def bwd():
            return dm.mega_dilated_attention_backward_cuda(
                q, k, v, mask, dmix, stats, seg, rat, 48 ** -0.5)
        r["K1f"], r["K1b"] = time_ms(fwd, iters), time_ms(bwd, iters)
        r["K1b_device"], split = device_times(bwd, iters=3, warmup=1)
        r["K1b_split"] = split and {name.split("(")[0]: round(ms, 4)
                                    for name, ms in split.items()}
        pairs = shape[0] * dilated_pairs(shape[1], n_valid, seg, rat,
                                         shape[2])
        tensors = (q, k, v, mask, dmix, stats, q, k, v)
        if dtype == torch.float32:
            (r["K1b_bound"], _), (r["K1b_cuda_cores_bound"], _) = \
                tf32x3_bounds(pairs, 48, tensors)
        else:
            r["K1b_bound"], _ = attention_bound(pairs, 48, tensors,
                                                backward=True)
        family = df.card_family(48, dtype)
        for tag, lq, lk in (("injector", bucket, 65), ("extractor", 65,
                                                       bucket),
                            ("prompt", 65, 65)):
            q2, k2, v2, bias = k2_inputs(36, lq, lk, 16, 0.05, False, dtype,
                                         device, seed=3)

            def k2f():
                return fa.flash_attention_cuda(q2, k2, v2, bias, 0.25)
            o, lse = k2f()
            do = torch.randn_like(o)
            r[f"K2f_{tag}"] = time_ms(k2f, iters)
            r[f"K2b_{tag}"] = time_ms(
                lambda: fa.flash_attention_backward_cuda(
                    q2, k2, v2, bias, o, lse, do, 0.25), iters)
        print(f"multiepoch: kernel times at bucket {bucket}, {dtn} "
              f"({fa.card_family(bucket, 65, 16, dtype)} K2, {family} K1b; "
              f"K1b's bound at "
              f"{'3xTF32' if dtype == torch.float32 else 'bf16'}): "
              f"{ {k: x if x is None else round(x, 4) for k, x in r.items() if k != 'K1b_split'} }"
              f"; K1b on the card by kernel {r['K1b_split']}", flush=True)
        del q, k, v, dmix, stats
        torch.cuda.empty_cache()
    return out


def draws_digest(u) -> tuple:
    """A digest of one dropout draw, equal for equal bits: the shape and
    the sums of the draw's words and of their squares (mod 2^64)."""
    import torch
    words = u.contiguous().view(torch.int32).to(torch.int64)
    return (tuple(u.shape), int(words.sum()), int((words * words).sum()))


def train_schedule(device, name, base, params, tcfg, datasets, bucket, dtype,
                   plain, out_dir):
    """``ModalTuneTrainer.run`` of a copy of ``base`` from ``params`` on
    ``datasets`` with the frozen backbone in ``dtype`` (bf16: the steps
    autocast to it), every kernel entry point patched to its plain version
    where ``plain``; every launch count set to 0 just before the run and
    read just after -> the epochs' losses, the val rows, the test row, the
    epochs that saved the best weights, the train steps' ms, the launches
    (all, and those of the train epochs alone), the batches the trainer
    moved outside the train epochs (the readout's and eval's forwards),
    and the digests of the first train step's dropout draws."""
    import torch
    from modaltune_tpu_torch.models import layers as model_layers
    from modaltune_tpu_torch.train.trainer import ModalTuneTrainer
    model = copy.deepcopy(base)
    trainer = ModalTuneTrainer(model, tcfg, datasets, str(out_dir),
                               buckets=(bucket,), device=device)
    best, draws, recording, in_epoch = [], [], [False], [False]
    in_train = {k: 0 for k in COUNTERS}
    forwards, epoch_ms = [0], []
    uniform = model_layers._uniform

    def recorded_uniform(shape, x):
        u = uniform(shape, x)
        if recording[0]:
            draws.append(draws_digest(u))
        return u

    init_state = trainer.init_state

    def recorded_init_state(p, frozen_dtype=None):
        opt = init_state(p, frozen_dtype=frozen_dtype)
        step = trainer._train_step

        def first_recorded(*args):
            recording[0] = not draws
            try:
                return step(*args)
            finally:
                recording[0] = False

        trainer._train_step = first_recorded
        return opt

    train_one_epoch, save_weights = (trainer.train_one_epoch,
                                     trainer.save_weights)
    to_device = trainer._batch

    def counted_epoch():
        before = read_counts()
        t = time.perf_counter()
        in_epoch[0] = True
        try:
            loss = train_one_epoch()
        finally:
            in_epoch[0] = False
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t) * 1e3)
        for k, n in read_counts().items():
            in_train[k] += n - before[k]
        return loss

    def counted_batch(batch):
        forwards[0] += not in_epoch[0]
        return to_device(batch)

    def recorded_save_weights(weights):
        best.append(trainer.current_epoch)
        save_weights(weights)

    trainer.init_state = recorded_init_state
    trainer.train_one_epoch = counted_epoch
    trainer.save_weights = recorded_save_weights
    trainer._batch = counted_batch

    def run():
        return trainer.run(params, frozen_dtype=getattr(torch, dtype))

    with mock.patch.object(model_layers, "_uniform", recorded_uniform):
        # the main path: every launch count starts at 0 just before it
        reset_counts()
        t0 = time.perf_counter()
        run_plain(run) if plain else run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        families = {k: dict(c) for k, c in dilated_family_counts().items()}
    rows = [json.loads(line) for line in open(out_dir / "run_metrics.jsonl")]
    epochs = [r for r in rows if "train_loss" in r]
    (test,) = [r for r in rows if "test_cls_bal_acc" in r]
    out = dict(name=name, losses=[r["train_loss"] for r in epochs],
               val=[(r["val_cls_bal_acc"], r["val_c_index"])
                    for r in epochs],
               test=test, best=best, step_ms=list(trainer.step_ms),
               ms=statistics.median(trainer.step_ms), epoch_ms=epoch_ms,
               launches=launches, families=families,
               in_train=in_train, forwards=forwards[0],
               steps=len(trainer.step_ms), draws=draws, seconds=seconds,
               per_forward=calls_per_forward(model),
               again=recomputed_per_step(model))
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_multiepoch(device, card="", build_kw=None, data_kw=None,
                     train_kw=None, runs=None):
    """ModalTune-GigaPath at full width trained through
    ``ModalTuneTrainer.run`` over the reference's whole schedule
    (``MULTIEPOCH_TRAIN``: 14 epochs, ten of warmup, lr 5e-4,
    ``kd_loss_scale`` 10, eval every epoch, the test stage with the best
    weights) on a learnable cohort at the 2,047 bucket
    (``MULTIEPOCH_DATA``), four times from the same weights, data order
    and dropout bits (``MULTIEPOCH_RUNS``): k16, the kernels with a bf16
    backbone under autocast; p16, the same on the plain versions; k32 and
    p32, the same with an fp32 backbone (the kernels' fp32 families).
    First it times the kernels those runs launch, in each dtype's family,
    at the phase's shapes (:func:`family_times`).

    Prints each run's epoch losses, val bal-acc and c-index per epoch, the
    epochs that saved the best weights, the test row, the median ms/step
    and its seconds. Checks: each run learns (its last epoch's loss below
    0.8 of its first); the first train step's dropout draws are the same
    bits in every run; fp32, ``max_e |k32 - p32| / p32`` within
    ``TRAJECTORY_FP32``; bf16, ``max_e |k16 - p32| / p32`` within twice
    ``max_e |p16 - p32| / p32`` or ``TRAJECTORY_BF16_FLOOR``, whichever is
    larger (the kernel path may stray from fp32 no more than twice as far
    as bf16 rounding alone does); k16's and k32's test bal-acc and
    c-index within ``BAND_BAL_ACC`` and ``BAND_C_INDEX`` of p32's; on k16
    and k32 per train step K1f, K1b, K2f and K2b as many as the model's
    layers and adapter attentions (``calls_per_forward``, with what the
    remat runs again) and per readout or eval forward K1f and K2f, no K3,
    K4 or K5; on p16 and p32 no kernel launch at all, the recompute of
    the remat included. -> the k16 and k32 launches summed, for the
    kernels line."""
    import tempfile

    import torch
    from modaltune_tpu_torch.configs import TrainConfig
    build_kw = build_kw or GIGAPATH
    data_kw = data_kw or MULTIEPOCH_DATA
    runs = runs or MULTIEPOCH_RUNS
    tcfg = TrainConfig(**(train_kw or MULTIEPOCH_TRAIN))
    t0 = time.perf_counter()
    datasets = learnable_cohort(**data_kw)
    base = build_model(device, **build_kw)
    params = {k: v.detach().clone() for k, v in base.state_dict().items()}
    print(f"multiepoch: cohort {[len(d) for d in datasets.values()]} cases "
          f"(train, val, test) in bucket {data_kw['bucket']}, model built, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    family_times(device, data_kw["bucket"],
                 n_valid=sum(data_kw["bag_range"]) // 2)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (dtype, plain) in runs.items():
            r = res[name] = train_schedule(
                device, name, base, params, tcfg, datasets,
                data_kw["bucket"], dtype, plain, Path(tmp) / name)
            print(f"multiepoch {name} ({dtype} backbone, "
                  f"{'plain versions' if plain else 'kernels'}): "
                  f"{r['seconds']:.1f} s, {r['steps']} train steps, median "
                  f"{r['ms']:.2f} ms/step, s/epoch "
                  f"{[round(x / 1e3, 2) for x in r['epoch_ms']]}; "
                  f"{r['forwards']} readout and eval forwards; "
                  f"launches {r['launches']}; {card}", flush=True)
            print(f"multiepoch {name}: epoch losses {r['losses']}",
                  flush=True)
            print(f"multiepoch {name}: val (bal-acc, c-index) by epoch "
                  f"{[(round(a, 4), round(c, 4)) for a, c in r['val']]}; "
                  f"best weights saved at epochs {r['best']}; test "
                  f"{json.dumps({k: v for k, v in r['test'].items() if k[0] != '_'})}",
                  flush=True)
    del base, params
    torch.cuda.empty_cache()

    def worst(a, b):
        return max(abs(x - y) / y for x, y in zip(res[a]["losses"],
                                                  res[b]["losses"]))

    for name, r in res.items():
        check(r["losses"][-1] < 0.8 * r["losses"][0],
              f"multiepoch {name}: the loss went {r['losses'][0]:.6f} -> "
              f"{r['losses'][-1]:.6f}, not below 0.8 of the first epoch's")
        check(r["draws"] and r["draws"] == res["k16"]["draws"],
              f"multiepoch {name}: the first step's {len(r['draws'])} "
              f"dropout draws differ from k16's {len(res['k16']['draws'])}")
    fp32 = worst("k32", "p32")
    bf16, rounding = worst("k16", "p32"), worst("p16", "p32")
    bf16_limit = max(2 * rounding, TRAJECTORY_BF16_FLOOR)
    want = res["p32"]["test"]
    bands = {name: (abs(res[name]["test"]["test_cls_bal_acc"]
                        - want["test_cls_bal_acc"]),
                    abs(res[name]["test"]["test_c_index"]
                        - want["test_c_index"])) for name in ("k16", "k32")}
    print(f"multiepoch: the first step's {len(res['k16']['draws'])} dropout "
          f"draws the same bits in every run; max over epochs of |run - "
          f"p32| / p32: k32 {fp32:.3e} (limit {TRAJECTORY_FP32:.0e}), k16 "
          f"{bf16:.3e}, p16 {rounding:.3e} (k16's limit {bf16_limit:.3e}); "
          f"test |bal-acc - p32's|, |c-index - p32's|: "
          f"{ {n: (round(a, 4), round(c, 4)) for n, (a, c) in bands.items()} }"
          f"; {card}", flush=True)
    check(fp32 <= TRAJECTORY_FP32,
          f"multiepoch: k32 strays {fp32:.3e} from p32 (limit "
          f"{TRAJECTORY_FP32:.0e})")
    check(bf16 <= bf16_limit,
          f"multiepoch: k16 strays {bf16:.3e} from p32, bf16 rounding alone "
          f"{rounding:.3e} (limit {bf16_limit:.3e})")
    for name, (a, c) in bands.items():
        check(a <= BAND_BAL_ACC and c <= BAND_C_INDEX,
              f"multiepoch {name}: test bal-acc {a:.4f} and c-index {c:.4f} "
              f"from p32's (bands {BAND_BAL_ACC}, {BAND_C_INDEX})")

    kernels = list(COUNTERS)
    for name, r in res.items():
        if runs[name][1]:
            check(not any(r["launches"].values()),
                  f"multiepoch {name}: the plain path launched {r['launches']}")
            continue
        per, again = r["per_forward"], r["again"]
        step = {f"{k}{d}": n + (again.get(k, 0) if d == "f" else 0)
                for k, n in per.items() for d in "fb"}
        want_train = {k: step[k] * r["steps"] for k in kernels}
        forwards = r["forwards"]
        want_all = {k: want_train[k] + (per[k[:2]] * forwards
                                        if k.endswith("f") else 0)
                    for k in kernels}
        check(r["in_train"] == want_train and r["launches"] == want_all
              and step == dict(K1f=12, K1b=12, K2f=10, K2b=10, K3f=0, K3b=0,
                               K4f=0, K4b=0, K5f=0, K5b=0),
              f"multiepoch {name}: launches {r['launches']} ({r['in_train']} "
              f"in {r['steps']} train steps), want {step} a step and "
              f"{ {k: per[k[:2]] for k in kernels if k.endswith('f')} } a "
              f"forward over {forwards} forwards")
    print(f"multiepoch: k16 and k32 launched per train step "
          f"{ {k: res['k16']['in_train'][k] // res['k16']['steps'] for k in kernels} }"
          f" and K1f 12, K2f 10 per readout or eval forward; p16 and p32 "
          f"no kernel", flush=True)
    df = importlib.import_module(COUNTERS["K3b"][0])
    for name in ("k16", "k32"):   # K1f and K1b, forward and backward
        want = df.family(48, getattr(torch, runs[name][0]))
        for key in ("K1f", "K1b"):
            fams = res[name]["families"][key]
            n = res[name]["launches"][key]
            check(fams[want] == n == sum(fams.values()),
                  f"multiepoch {name}: {key} launches by family {fams}, "
                  f"want all {n} on {want}")
    k32, p32 = res["k32"]["ms"], res["p32"]["ms"]
    print(f"multiepoch: ms/step, median: k32 {k32:.2f} against p32 "
          f"{p32:.2f} ({k32 / p32:.3f}x); k16 {res['k16']['ms']:.2f}, p16 "
          f"{res['p16']['ms']:.2f}; K1f and K1b by family: k16 "
          f"{res['k16']['families']['K1f']}, "
          f"{res['k16']['families']['K1b']}, k32 "
          f"{res['k32']['families']['K1f']}, "
          f"{res['k32']['families']['K1b']}; {card}", flush=True)
    return dict(launches={k: res["k16"]["launches"][k]
                          + res["k32"]["launches"][k] for k in kernels},
                families={k: {f: res["k16"]["families"][k][f]
                              + res["k32"]["families"][k][f]
                              for f in df.FAMILIES}
                          for k in res["k16"]["families"]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from modaltune_tpu_torch.ops import _build
    clock = [time.perf_counter()]

    def lap(what):
        """Print the seconds since the last lap, for the run's budget."""
        clock.append(time.perf_counter())
        print(f"time: {what} {clock[-1] - clock[-2]:.1f} s", flush=True)

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = _last_line(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader", "--id=0"])
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, "
          f"{_last_line([_build.find_nvcc(), '--version'])}", flush=True)
    print("card (nvidia-smi name, power.limit):")
    print(card, flush=True)

    # 2. build
    info = _build.build_library()
    _build.load_library()
    print(f"build: {info['seconds']:.1f} s -> {info['path']}")
    # ptxas -v, summed up (the whole log lies beside the library)
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["log"])]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill loads",
                                         info["log"])]
    if regs:
        print(f"build: {len(regs)} kernels, at most {max(regs)} registers; "
              f"{sum(1 for x in spills if x)} spill, at most {max(spills)} "
              f"bytes of spill loads")
    # K2's wgmma kernels (namespace mt::fwg) and the 3xTF32 dilated core
    # (mt::dtf) one by one: none may spill
    for block in info["log"].split("Compiling entry function")[1:]:
        name = block.split("'")[1]
        if "3fwg" not in name and "3dtf" not in name:
            continue
        used = re.search(r"Used (\d+) registers", block).group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block).groups()
        short = re.search(r"\d+((?:flash|dilated)_\w+?_kernel)", name).group(1)
        print(f"build: {short}: {used} registers at launch, spill stores "
              f"{spill[0]}, loads {spill[1]} bytes")
        check(spill == ("0", "0"), f"{short} spills registers")

    lap("environment and build")

    # 3-12. kernels against their plain versions
    k2 = phase_k2(device, iters=10)
    k2b = phase_k2b(device, iters=10)
    lap("K2f, K2b")
    k1 = phase_k1(device, iters=10)
    k1b = phase_k1b(device)
    k1q = phase_k1_qrange(device)
    lap("K1f, K1b, their q_token_range")
    k3 = phase_k3(device)
    k3b = phase_k3b(device)
    k5 = phase_k5(device)
    k5b = phase_k5b(device)
    lap("K3f, K3b, K5f, K5b")
    k4 = phase_k4(device)
    k4b = phase_k4b(device)
    lap("K4f, K4b")

    # ModalTune-GigaPath: the embed step, the train step
    paths = {
        "gigapath_embed": phase_slice(device, torch.bfloat16, card=card,
                                      build_kw=GIGAPATH, timing_rounds=2),
        "gigapath_train": phase_train(device, card=card, build_kw=GIGAPATH,
                                      compare_kw=GIGAPATH_2047),
    }
    # the same on the fused route (K3 for K1, K5 for the FFN chain), its
    # embeddings held to the default route's
    paths["gigapath_fused_embed"] = phase_slice(
        device, torch.bfloat16, card=card, build_kw=GIGAPATH_FUSED,
        timing_rounds=2, tag="fused slice",
        agree_with=paths["gigapath_embed"]["outs"])
    paths["gigapath_fused_train"] = phase_train(
        device, card=card, build_kw=GIGAPATH_FUSED, compare_kw=GIGAPATH_2047,
        tag="fused train")
    # the same on the per-branch route (every branch on K2's wgmma family)
    paths["gigapath_branch_embed"] = phase_slice(
        device, torch.bfloat16, card=card, build_kw=GIGAPATH_BRANCH,
        timing_rounds=2, tag="branch slice",
        agree_with=paths["gigapath_embed"]["outs"])
    paths["gigapath_branch_train"] = phase_train(
        device, card=card, build_kw=GIGAPATH_BRANCH, compare_kw=GIGAPATH_2047,
        tag="branch train", k2_calls=True)
    # the --bf16 0 user's step: the default and the fused route with an
    # fp32 backbone (K1 and K3 on the 3xTF32 family)
    fp32 = phase_train_fp32(device, paths["gigapath_train"], card=card)
    paths["gigapath_fp32_train"] = fp32["fp32 train"]
    paths["gigapath_fused_fp32_train"] = fp32["fused fp32 train"]
    lap("GigaPath embed and train steps, three routes, the fp32 step")
    # ModalTune-TITAN: the embed step, the train step
    paths["titan_embed"] = phase_slice(
        device, torch.bfloat16, card=card, build_kw=TITAN, timing_rounds=2,
        tag="titan slice", compare_kw=TITAN_4095)
    paths["titan_train"] = phase_train(
        device, card=card, build_kw=TITAN, compare_kw=TITAN_2047,
        tag="titan train")
    # data parallelism over a world of one (NCCL) and the 2-rank
    # sequence-parallel step (gloo), each held to the single-device step
    lap("TITAN embed and train steps")
    par = phase_parallel(device, card=card)
    lap("parallel")
    paths["gigapath_dp_train"] = dict(launches=par["dp_launches"])
    paths["gigapath_sp_train"] = dict(launches=par["sp_launches"])
    # the trainer slice: the port's train CLI, train -> val -> test ->
    # deploy, on the reference's file formats at full width
    paths["gigapath_trainer"] = phase_trainer(device, card=card)
    lap("trainer")
    # the pan-cancer trainer through the CLI on four sites' files
    paths["gigapath_pancancer"] = phase_pancancer(device, card=card)
    lap("pan-cancer")
    # the supervised baselines: no kernel of the port, so not a path of the
    # kernels line
    phase_baselines(device, card=card)
    lap("baselines")
    # the LongNet extras: GigaPath with the LoRA encoder variant (every
    # branch on K2's wgmma family), then MoE with its exchange, xPos and
    # the T5 bias (no kernel of the port)
    lora = phase_lora(device, card=card)
    paths["gigapath_lora_embed"] = lora["gigapath_lora_embed"]
    paths["gigapath_lora_train"] = lora["gigapath_lora_train"]
    lap("LoRA")
    phase_moe(device, card=card)
    lap("MoE, xPos, T5 bias")
    # dataset preparation on a synthetic site, the CLI on what it wrote,
    # and a TITAN extraction with the slide encoder on K4f
    paths.update(phase_prepare(device, card=card))
    lap("preparation")
    # a trace of two train steps and its report
    phase_profile(device, card=card)
    lap("profile")
    # the reference's 25,599-token geometry: the train step under each
    # remat setting, the embed step, the fused route, B = 2, K1 at 25,600
    # tokens, the cost of remat at 10,239, the CLI at --threshold 25000
    flagship = phase_flagship(device, card=card)
    paths.update(flagship["paths"])
    lap("flagship")
    # the reference's whole warmup -> cosine schedule through the trainer:
    # the kernel paths' trajectories against the plain paths' (k16 and k32
    # count here)
    paths["gigapath_multiepoch"] = phase_multiepoch(device, card=card)
    lap("multiepoch")
    print(f"time: the run {clock[-1] - clock[0]:.1f} s", flush=True)

    def kernel(key, name, replaces, res, by_shape=None, source=None,
               family=None, sources=None):
        """One entry of the kernels line. launches: the sum over the
        paths' runs (by_path: each run's own count, every count set to 0
        just before it); max_abs_err: the largest output or gradient error
        of any comparison above (``errors[key]``), the flagship's shapes
        included; ms, plain_ms, bound_ms, library_ms: at K1's, K3's and
        K5's one shape, K2's Extractor shape, K4's N = 16,384 (by_shape:
        the others, with K2's kernel family and the kernel's and library
        call's time on the card alone); at_25600: the same readings at the
        shapes the flagship's paths give it (K1 and K3 (3, 25600, 16, 48),
        K5 (76800, 3072), K2 by shape, the adapter's calls over 25,599
        tokens).
        source: the file of the kernels the paths run, ``name``.cu unless
        given; family: the kernel family of the paths' bf16 calls, as the
        C entry points chose it where they export their rule (K1, K2,
        K3), else ``family``; device_ms where measured, and K1f's and
        K3f's mix kernel on the card and K1f's times with stats; K1f's
        and K3f's fp32 readings (``fp32``) and their CUDA-core family's at
        D = 64 (``cuda_cores``). A card time the profiler did not record
        is null. sources
        (K2): the file of each family, and the launches by family summed
        over the paths that count them (``launches_by_family``)."""
        big = flagship["at_25600"].get(key)
        err = errors[key](res if by_shape is None else by_shape)
        if big is not None:
            err = max(err, errors[key](big))
        by_path = {p: r["launches"][key] for p, r in paths.items()}
        qrange = {p: r["launches"].get(f"{key}_qrange", 0)
                  for p, r in paths.items()}
        out = {"name": name, "route": "cuda",
               "source": f"modaltune_tpu_torch/csrc/{source or name}.cu",
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path, "max_abs_err": err,
               "ms": res["ms"], "plain_ms": res["plain_ms"],
               "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
               "library_ms": res.get("library_ms")}
        out["family"] = res.get("family", family)
        for k in ("device_ms", "mix_device_ms", "stats_ms",
                  "stats_device_ms", "stats_mix_device_ms", "out_rel",
                  "out_row", "dx_only_ms", "dx_only_device_ms",
                  "dx_only_plain_ms", "dx_only_bound_ms",
                  "dx_only_bound_by"):
            if k in res:
                out[k] = res[k]
        if big is not None:
            def at(r, errs):
                return dict({k: r[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "family") if k in r},
                    max_abs_err=errs)
            out["at_25600"] = (
                {shape: at(r, errors[key]({shape: r}))
                 for shape, r in big.items()} if by_shape is not None
                else at(big, errors[key](big)))
        if key in ("K1f", "K1b"):
            # with a q_token_range: launches on the paths (the
            # sequence-parallel step's ranks), the shards' largest error
            # against the whole call, the middle shard of 2's time and
            # bound, and every shard count's readings
            bwd = key == "K1b"
            half = k1q["by_n"][2]
            out.update(
                qrange_launches=sum(qrange.values()),
                qrange_launches_by_path={p: n for p, n in qrange.items()
                                         if n},
                qrange_max_abs_err=k1q["bwd_err" if bwd else "fwd_err"],
                qrange_ms=half["bwd_ms" if bwd else "ms"],
                qrange_device_ms=half["bwd_device_ms" if bwd
                                      else "device_ms"],
                qrange_bound_ms=half["bwd_bound_ms" if bwd else "bound_ms"],
                qrange_by_n={n: {k: r[k] for k in (
                    ("bwd_ms", "bwd_device_ms", "bwd_bound_ms") if bwd else
                    ("ms", "device_ms", "bound_ms"))} for n, r in
                    k1q["by_n"].items()})
            check(out["qrange_launches"] > 0,
                  f"{name} with a q_token_range was launched on no path")
            if bwd:   # K1b in two parts: part 1's launches apart
                part1 = {p: r["launches"].get("K1b_part1", 0)
                         for p, r in paths.items()}
                out["part1_launches_by_path"] = {p: n for p, n in
                                                 part1.items() if n}
        if key in ("K1f", "K3f", "K1b", "K3b"):
            # by family: the cores of each (bf16 wgmma, fp32 3xTF32; the
            # kernels of `name`.cu beside them) and the CUDA-core kernels;
            # launches summed over the paths that record them (the embed
            # and train steps', the schedule's); the fp32 family's readings
            # beside the bf16 ones
            side = 0 if key.endswith("f") else 1
            out["source_by_family"] = {
                fam: f"modaltune_tpu_torch/csrc/{pair[side]}"
                for fam, pair in df.CORE_SOURCES.items()}
            out["source_by_family"]["cuda_cores"] = (
                f"modaltune_tpu_torch/csrc/{name}.cu")
            out["launches_by_family"] = {
                fam: sum(r["families"][key][fam] for r in paths.values()
                         if "families" in r)
                for fam in out["source_by_family"]}
            check(out["launches_by_family"]["tf32x3"] > 0,
                  f"{name}: the 3xTF32 family was launched on no path")
        if key in ("K1b", "K3b"):
            out["fp32"] = res["fp32"]
            if big is not None:
                out["at_25600"]["fp32"] = big["fp32"]
            if key == "K1b":
                out["fp32"]["qrange_by_n"] = k1q["fp32_by_n"]
        if key in ("K1f", "K3f"):   # fp32: the 3xTF32 family's readings
            keep = ("family", "ms", "device_ms", "mix_device_ms",
                    "plain_ms", "bound_ms", "bound_by", "cuda_cores_bound_ms",
                    "stats_ms", "stats_device_ms", "rel", "row", "core_ms",
                    "core_device_ms", "core_bound_ms", "mix_alone_ms",
                    "mix_alone_device_ms", "mix_bound_ms", "k1f_ms")

            def fp32_of(r):
                return {k: r["float32"][k] for k in keep
                        if k in r["float32"]}
            out["fp32"] = fp32_of(res)
            if big is not None:
                out["at_25600"]["fp32"] = fp32_of(big)
            # the CUDA-core family (D != 48) at its own shape; no path
            # launches it
            out["cuda_cores"] = res["cuda_cores"]
        if sources:
            side = "bwd" if key.endswith("b") else "fwd"
            out["source_by_family"] = {
                fam: f"modaltune_tpu_torch/csrc/{stem}.cu"
                for fam, stem in sources.items()}
            out["launches_by_family"] = {
                fam: sum(r["k2_families"][side][fam] for r in paths.values()
                         if "k2_families" in r) for fam in sources}
        if by_shape:
            out["by_shape"] = {
                shape: {k: r.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}
                for shape, r in by_shape.items()}
            for shape, r in by_shape.items():   # K2's family, device times
                for k in ("family", "device_ms", "library_device_ms",
                          "fp32"):
                    if k in r:
                        out["by_shape"][shape][k] = r[k]
        check(out["launches"] > 0, f"{name} was launched on no path")
        return out

    def k2_sources(side):
        return {"cuda_cores": f"flash_attention_{side}",
                "short_keys": f"flash_short_side_{side}",
                "short_queries": f"flash_short_side_{side}",
                "wgmma": f"flash_wgmma_{side}"}

    both = ("float32", "bfloat16")

    def both_cores(r):
        """K1f's and K3f's readings: both dtypes, the CUDA-core leg's."""
        return both + (("cuda_cores",) if "cuda_cores" in r else ())
    # the largest output or gradient error of a kernel's readings (K2, K4:
    # of every shape's)
    errors = {
        "K1f": lambda r: max(r[dt]["out_err"] for dt in both_cores(r)),
        "K1b": lambda r: max(r[dt]["grad_err"] for dt in both),
        "K2f": lambda rs: max(r[dt]["out_err"] for r in rs.values()
                              for dt in both),
        "K2b": lambda rs: max(r[dt] for r in rs.values() for dt in both),
        "K3f": lambda r: max(r[dt].get(e, 0.0) for dt in both_cores(r)
                             for e in ("out_err", "piece_err", "mix_err")),
        "K3b": lambda r: max(r[dt]["grad_err"] for dt in both),
        "K4f": lambda rs: max(r[dt]["out_err"] for r in rs.values()
                              for dt in both),
        "K4b": lambda rs: max(r[dt] for r in rs.values() for dt in both),
        "K5f": lambda r: max(r[dt] for dt in both),
        "K5b": lambda r: max(r[dt] for dt in both),
    }
    df = importlib.import_module(COUNTERS["K3f"][0])
    kernels = [
        # at D = 48 the family's tensor-core forward core (bf16
        # dilated_fwd_wgmma.cu, fp32 dilated_fwd_tf32.cu) and the mix
        kernel("K1f", "dilated_attention_fwd",
               "modaltune_tpu/ops/dilated_mega.py:426", k1,
               source="dilated_fwd_wgmma"),
        # at D = 48 the family's gradient core (bf16 dilated_bwd_wgmma.cu,
        # fp32 dilated_bwd_tf32.cu) behind each route's prep
        kernel("K1b", "dilated_attention_bwd",
               "modaltune_tpu/ops/dilated_mega.py:641", k1b,
               source="dilated_bwd_wgmma"),
        # the adapter's calls run the short-side family (bf16, D = 16), the
        # per-branch route's the wgmma family (bf16, D = 48); fp32 the
        # CUDA-core kernels of `name`.cu
        kernel("K2f", "flash_attention_fwd",
               "modaltune_tpu/ops/flash_attention.py:155",
               k2["extractor"], k2, source="flash_short_side_fwd",
               sources=k2_sources("fwd")),
        kernel("K2b", "flash_attention_bwd",
               "modaltune_tpu/ops/flash_attention.py:292",
               k2b["extractor"], k2b, source="flash_short_side_bwd",
               sources=k2_sources("bwd")),
        kernel("K3f", "dilated_fused_fwd",
               "modaltune_tpu/ops/dilated_fused.py:468", k3,
               source="dilated_fwd_wgmma"),
        kernel("K3b", "dilated_fused_bwd",
               "modaltune_tpu/ops/dilated_fused.py:676", k3b,
               source="dilated_bwd_wgmma"),
        kernel("K4f", "alibi_attention_fwd",
               "modaltune_tpu/ops/alibi_flash.py:552", k4["n16384"], k4,
               family="wgmma"),
        kernel("K4b", "alibi_attention_bwd",
               "modaltune_tpu/ops/alibi_flash.py:594", k4b["n16384"], k4b,
               family="wgmma"),
        # bf16 at F = 3072 runs the row-resident kernels; fp32 the generic
        # ones; K5b's ms, plain_ms and bound the variant with dgamma/dbeta
        # (the TPU kernel's function), dx_only_* the train step's without
        kernel("K5f", "gelu_ln_fwd", "modaltune_tpu/ops/gelu_ln.py:169", k5),
        kernel("K5b", "gelu_ln_bwd", "modaltune_tpu/ops/gelu_ln.py:189", k5b),
    ]
    print(f"device times: {DEVICE_TIMES['by_events']} of "
          f"{DEVICE_TIMES['calls']} timed by CUDA events, the profiler having "
          f"recorded no device event", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
