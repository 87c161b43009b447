"""Sum a ``torch.profiler`` Chrome trace by op class.

    python -m modaltune_tpu_torch.tools.trace_report TRACE_DIR
        [--steps N] [--top K] [--shapes CLASS | --breakdown CLASS] [--spans]

Counterpart of the JAX package's ``tools/trace_report.py``, with its
flags. Loads the newest trace that :func:`..utils.profiling.trace` wrote
under ``TRACE_DIR``, takes its device events (kernels, copies and sets on
the GPU) or, in a trace without any, its outermost CPU ops, sums their
durations by op class (:func:`op_class`) and prints a ms/step table over
``--steps`` traced steps. ``--shapes CLASS`` (or ``--breakdown CLASS``)
splits that class by the input shapes the profiler recorded for the op
that launched each event. ``--spans`` adds a table of device ms and host
self ms a step by the innermost ``mt.*`` span (:mod:`..utils.tracing`),
:func:`span_summary`.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host events: these categories and every CUDA API category (``cuda_*``)
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")


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


OUTSIDE = "(outside any span)"
SPAN_PREFIX = "mt."


class _Lanes:
    """The host events of every thread, nested by time, and the profiler's
    links: a kernel's ``correlation`` to the runtime call that launched
    it, a backward op's ``fwdbwd`` flow to its forward op (the flow the
    profiler draws from the ops' ``Sequence number`` and ``Fwd thread
    id``)."""

    def __init__(self, events: List[dict]):
        complete = [e for e in events if e.get("ph") == "X"]
        self.host = sorted((e for e in complete
                            if e.get("cat") in HOST_CATEGORIES
                            or str(e.get("cat", "")).startswith("cuda_")),
                           key=lambda e: (e["pid"], e["tid"], e["ts"],
                                          -e["dur"]))
        self.parent: List[int] = []
        self.lanes: Dict[tuple, List[int]] = collections.defaultdict(list)
        stack: List[int] = []
        for i, e in enumerate(self.host):
            lane = (e["pid"], e["tid"])
            while stack and (self._lane(stack[-1]) != lane or
                             e["ts"] >= self._end(stack[-1])):
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
            self.lanes[lane].append(i)
        self.starts = {lane: [self.host[i]["ts"] for i in idx]
                       for lane, idx in self.lanes.items()}
        self.launch = {}        # correlation -> the CUDA API call
        for i, e in enumerate(self.host):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                self.launch[c] = i
        starts, self.forward = {}, {}
        for e in events:
            if e.get("cat") == "fwdbwd" and e.get("ph") == "s":
                starts[e["id"]] = (e["pid"], e["tid"], e["ts"])
        for e in events:
            if e.get("cat") == "fwdbwd" and e.get("ph") == "f" and \
                    e["id"] in starts:
                bwd = self.at(e["pid"], e["tid"], e["ts"])
                fwd = self.at(*starts[e["id"]])
                if bwd >= 0 and fwd >= 0:
                    self.forward[bwd] = fwd
        self._memo: Dict[int, Optional[str]] = {}

    def _lane(self, i):
        return self.host[i]["pid"], self.host[i]["tid"]

    def _end(self, i):
        return self.host[i]["ts"] + self.host[i]["dur"]

    def at(self, pid, tid, ts) -> int:
        """The innermost host event of the thread holding ``ts``, or -1."""
        idx = self.lanes.get((pid, tid))
        if not idx:
            return -1
        k = bisect.bisect_right(self.starts[(pid, tid)], ts) - 1
        i = idx[k] if k >= 0 else -1
        while i >= 0 and self._end(i) < ts:
            i = self.parent[i]
        return i

    def span_of(self, i: int) -> Optional[str]:
        """The innermost ``mt.*`` span around host event ``i``; where a
        backward op comes first, its forward op's span, if it has one."""
        if i < 0:
            return None
        if i not in self._memo:
            self._memo[i] = None    # a link back to itself ends here
            name = self.host[i]["name"]
            if self.host[i].get("cat") == "user_annotation" and \
                    name.startswith(SPAN_PREFIX):
                got = name
            else:
                got = self.span_of(self.forward[i]) \
                    if i in self.forward else None
                got = got or self.span_of(self.parent[i])
            self._memo[i] = got
        return self._memo[i]


def span_summary(events: List[dict], steps: int = 2) -> dict:
    """``{"device_ms_per_step": {span: ms}, "host_ms_per_step": {span:
    ms}, "count_per_step": {span: n}}`` by the innermost ``mt.*`` span
    (``(outside any span)`` for the rest). A kernel, copy or set counts
    under the span around the CUDA API call that launched it (its
    ``correlation``); a host event's self time (its duration less its
    children's) under its own; a backward op under its forward op's."""
    lanes = _Lanes(events)
    dev, host, count = (collections.Counter(), collections.Counter(),
                        collections.Counter())
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            c = (e.get("args") or {}).get("correlation")
            dev[lanes.span_of(lanes.launch.get(c, -1)) or OUTSIDE] += \
                e["dur"]
    child = collections.Counter()
    for i, p in enumerate(lanes.parent):
        if p >= 0:
            child[p] += lanes.host[i]["dur"]
    for i, e in enumerate(lanes.host):
        name = lanes.span_of(i) or OUTSIDE
        host[name] += e["dur"] - child[i]
        if name == e["name"]:
            count[name] += 1
    names = sorted(set(dev) | set(host) | {OUTSIDE},
                   key=lambda n: (-dev[n], -host[n]))
    return {"device_ms_per_step": {n: dev[n] / 1e3 / steps for n in names},
            "host_ms_per_step": {n: host[n] / 1e3 / steps for n in names},
            "count_per_step": {n: count[n] / steps for n in names}}


def print_spans(rep: dict, top: int = 18) -> None:
    dev, host = rep["device_ms_per_step"], rep["host_ms_per_step"]
    print(f"{'span':<40}{'device ms/step':>16}{'host self ms/step':>20}"
          f"{'opens/step':>12}")
    rows = list(dev)
    rows = rows[:top] + ([OUTSIDE] if OUTSIDE not in rows[:top] else [])
    for n in rows:
        print(f"{n[:39]:<40}{dev[n]:>16.4f}{host[n]:>20.4f}"
              f"{rep['count_per_step'][n]:>12g}")
    print(f"{'TOTAL':<40}{sum(dev.values()):>16.4f}"
          f"{sum(host.values()):>20.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, default=2,
                    help="traced steady-state steps the totals span")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--shapes", "--breakdown", dest="shapes", default="",
                    help="break this op class down by shape")
    ap.add_argument("--spans", action="store_true",
                    help="add device and host self ms by mt.* span")
    a = ap.parse_args(argv)
    events = load_events(a.trace_dir)
    rep = summarize(events, a.steps, a.shapes or None)
    if not rep["ms_per_step"]:
        print("no op events found in the trace", file=sys.stderr)
        return 1
    print_report(rep, a.top, a.shapes or None)
    if a.spans:
        print()
        print_spans(span_summary(events, a.steps), a.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
