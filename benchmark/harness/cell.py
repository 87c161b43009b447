"""One run of one cell: make the inputs from the seed, set the program up,
measure the window, read the per-layer metrics, free the program, check
what it produced against the reference, and build the result line."""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import roofline
from .inputs import Seeds, make_weights
from .manifest import Manifest

# top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "modaltune_tpu")
TOP_OPS = 10


@dataclasses.dataclass
class Context:
    """What a cell's entry is given: its configuration and workload files,
    the seeds, the device and the cohort's cases."""
    manifest: Manifest
    cell: dict
    config: dict
    workload: dict
    seeds: Seeds
    device: object
    cases: list

    @functools.cached_property
    def spec(self) -> dict:
        from ..reference.steps import param_spec
        return param_spec(self.config["reference"], self.config,
                          self.config["genes"])

    def weights(self) -> dict:
        """The weights, made anew from the seed on the device (the same
        every call): the frozen backbone's in the type it is served in."""
        from ..entries.port import frozen_dtype
        return make_weights(self.spec, self.seeds.weights, self.device,
                            frozen_dtype(self.config))


@dataclasses.dataclass
class View:
    """What a per-layer metric reader reads (``read(view) -> float or
    None``): the entry's kind, the window's record (``steps``,
    ``seconds``, ``pass_s``, ``traced_pass``, ``loader_ms``, ``trace``),
    the configuration, its FLOP counter, and the peaks (:mod:`.roofline`).
    The profiler stretches the epoch it traces on the host, so rates and
    shares of the host's time take the untraced epochs."""
    kind: str
    record: dict
    config: dict
    flops: object
    roofline: object = roofline

    @property
    def trace(self):
        return self.record.get("trace")

    @property
    def traced_steps(self) -> list:
        return [s for s in self.record["steps"] if s.traced]

    @property
    def untraced_steps(self) -> list:
        return [s for s in self.record["steps"] if not s.traced]

    @property
    def untraced_pass_s(self) -> list:
        """The seconds of each epoch (or pass) the profiler did not trace."""
        skip = self.record.get("traced_pass")
        return [x for i, x in enumerate(self.record["pass_s"]) if i != skip]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device, started: float, log=print) -> Optional[dict]:
    """The result line of one run, or None where the run must print none
    (``log`` says why)."""
    import torch
    manifest = Manifest.load(root)
    cell = manifest.cell(workload)
    config, wl = manifest.config(cell), manifest.workload(cell)
    seeds = Seeds.of(seed, wl["trainer_seed"])
    traffic = importlib.import_module(f"benchmark.traffic.{wl['generator']}")
    cases = traffic.make_cohort(wl, config, seeds.data)
    ctx = Context(manifest, cell, config, wl, seeds, device, cases)
    entry = importlib.import_module(f"benchmark.entries.{wl['entry']}") \
        .Entry(ctx)
    os.environ.update(config.get("environment", {}))
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    entry.setup()
    _sync(device)
    setup_s = time.perf_counter() - started
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    record = entry.window(seconds, trace)
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    flops = importlib.import_module(f"benchmark.flops.{config['flops']}")
    view = View(entry.kind, record, config, flops)

    values = dict(entry.end_to_end(record), setup_s=setup_s,
                  peak_mem_gib=window_peak / 2 ** 30)
    units = manifest.units()
    metrics: Dict[str, dict] = {}
    if trace:
        for name in manifest.per_layer_names(workload):
            v = manifest.reader(name)(view)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        for name in manifest.e2e_names(workload):
            metrics[name] = {"value": float(values[name]),
                             "unit": units[name]}

    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = entry.check()
    for k, v in getattr(entry, "values", {}).items():
        if k not in checks:
            log(f"reading {k} {v!r} (not compared)")
    log(f"setup {setup_s:.2f} s, window {record['seconds']:.2f} s "
        f"({len(record['steps'])} slides, {len(record['pass_s'])} passes: "
        f"{' '.join(f'{x:.3f}' for x in record['pass_s'])}), "
        f"check {time.perf_counter() - t_check:.2f} s")
    bad = forbidden_modules()
    if bad:
        log(f"modules of the JAX side were loaded: {bad}")
        return None
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": len(record["steps"]),
        "failed": int(failed),
        "metrics": metrics,
        "device": _device(device, max(peak, window_peak)),
    }
    if record.get("trace") is not None:
        t = record["trace"]
        result["device"].update(busy_s=t.busy_s(), window_s=t.window_s)
        ops = sorted(t.by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(t.idle_gaps().items(), key=lambda kv: -kv[1])
        result["breakdown"] = {"device_ops": [list(x) for x in ops[:TOP_OPS]],
                               "idle_gaps": [list(x) for x in gaps[:TOP_OPS]]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _device(device, peak: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def mean(xs) -> Optional[float]:
    return statistics.fmean(xs) if xs else None
