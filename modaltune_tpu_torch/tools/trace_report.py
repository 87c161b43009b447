"""Sum a ``torch.profiler`` Chrome trace by op class.

    python -m modaltune_tpu_torch.tools.trace_report TRACE_DIR
        [--steps N] [--top K] [--shapes CLASS | --breakdown CLASS]

Counterpart of the JAX package's ``tools/trace_report.py``, with its
flags. Loads the newest trace that :func:`..utils.profiling.trace` wrote
under ``TRACE_DIR``, takes its device events (kernels, copies and sets on
the GPU) or, in a trace without any, its outermost CPU ops, sums their
durations by op class (:func:`op_class`) and prints a ms/step table over
``--steps`` traced steps. ``--shapes CLASS`` (or ``--breakdown CLASS``)
splits that class by the input shapes the profiler recorded for the op
that launched each event.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_trace(trace_dir: str) -> Path:
    paths = [p for p in Path(trace_dir).rglob("*.pt.trace.json*")
             if p.is_file()]
    if not paths:
        raise FileNotFoundError(f"no trace json under {trace_dir}")
    return max(paths, key=lambda p: p.stat().st_mtime)


def load_events(trace_dir: str) -> List[dict]:
    path = newest_trace(trace_dir)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _outermost(ops: List[dict]) -> List[dict]:
    """The ops that no other op of the same thread encloses (CPU ops nest:
    ``aten::linear`` holds ``aten::addmm``)."""
    out = []
    ends: Dict[tuple, float] = {}
    for e in sorted(ops, key=lambda e: (e["pid"], e["tid"], e["ts"],
                                        -e["dur"])):
        lane = (e["pid"], e["tid"])
        if e["ts"] >= ends.get(lane, float("-inf")):
            out.append(e)
            ends[lane] = e["ts"] + e["dur"]
    return out


def op_events(events: List[dict]):
    """``(events, "device" | "cpu")``: the complete events on the GPU, or
    in a trace without them the outermost CPU ops."""
    complete = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    if dev:
        return dev, "device"
    return _outermost([e for e in complete if e.get("cat") == "cpu_op"]), \
        "cpu"


_TEMPLATE = re.compile(r"[<(].*$")
_SUFFIX = re.compile(r"[._]\d+$")


def op_class(name: str) -> str:
    """A kernel's or op's name without ``void``, template arguments,
    parameter list and numeric suffix (``void mt::dwg::dilated_fwd_wg_kernel
    <64>(...)`` -> ``mt::dwg::dilated_fwd_wg_kernel``)."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = _TEMPLATE.sub("", name).strip() or name
    return _SUFFIX.sub("", name)


def _shapes_by_op(events: List[dict]) -> Dict[int, str]:
    """External id -> the input shapes of the CPU op that holds it."""
    out = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and "Input Dims" in args:
            out[args.get("External id")] = str(
                [d for d in args["Input Dims"] if d])
    return out


def summarize(events: List[dict], steps: int = 2,
              shapes: Optional[str] = None) -> dict:
    """``{"lane": "device" | "cpu", "ms_per_step": {class: ms},
    "count_per_step": {class: n}, "total_ms_per_step": ms,
    "by_shape": {shape: ms per step}}`` (``by_shape`` for the class
    ``shapes``)."""
    ops, lane = op_events(events)
    us, count, by_shape = (collections.Counter(), collections.Counter(),
                           collections.Counter())
    dims = _shapes_by_op(events) if shapes else {}
    for e in ops:
        c = op_class(e["name"])
        us[c] += e["dur"]
        count[c] += 1
        if shapes and c == shapes:
            args = e.get("args") or {}
            if lane == "cpu":
                shape = str([d for d in args.get("Input Dims", []) if d])
            else:
                shape = dims.get(args.get("External id"), "?")
            by_shape[shape] += e["dur"]
    return {"lane": lane,
            "ms_per_step": {c: t / 1e3 / steps for c, t in us.most_common()},
            "count_per_step": {c: n / steps for c, n in count.items()},
            "total_ms_per_step": sum(us.values()) / 1e3 / steps,
            "by_shape": {s: t / 1e3 / steps
                         for s, t in by_shape.most_common()}}


def print_report(rep: dict, top: int = 18,
                 shapes: Optional[str] = None) -> None:
    print(f"{rep['lane']} events")
    print(f"{'op class':<60}{'ms/step':>12}{'count/step':>12}")
    for c, ms in list(rep["ms_per_step"].items())[:top]:
        print(f"{c[:59]:<60}{ms:>12.4f}{rep['count_per_step'][c]:>12g}")
    print(f"{'TOTAL':<60}{rep['total_ms_per_step']:>12.4f}")
    if shapes:
        print(f"\n-- '{shapes}' by shape --")
        for s, ms in list(rep["by_shape"].items())[:top]:
            print(f"{ms:>10.4f} ms  {s}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, default=2,
                    help="traced steady-state steps the totals span")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--shapes", "--breakdown", dest="shapes", default="",
                    help="break this op class down by shape")
    a = ap.parse_args(argv)
    rep = summarize(load_events(a.trace_dir), a.steps, a.shapes or None)
    if not rep["ms_per_step"]:
        print("no op events found in the trace", file=sys.stderr)
        return 1
    print_report(rep, a.top, a.shapes or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
