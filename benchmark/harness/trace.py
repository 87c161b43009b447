"""One stretch of a run under ``torch.profiler``, reduced to what the
per-layer metrics and the breakdown read: every device operation's name
and interval, the host operations of every thread, the stretch's length
on the host clock."""

from __future__ import annotations

import bisect
import dataclasses
import functools
import time
from typing import Dict, List, Tuple

# host operations looked at before a gap counts as one with none running
SCAN = 4000


@dataclasses.dataclass
class Trace:
    window_s: float                       # the stretch, host clock
    device: List[Tuple[str, float, float]]  # (name, start us, end us)
    host: List[Tuple[str, float, float]]    # every thread's operations

    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.device]) / 1e6

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.device:
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out

    def seconds(self, pred) -> float:
        """Device seconds of the operations whose name ``pred`` accepts."""
        return sum((b - a) for n, a, b in self.device if pred(n)) / 1e6

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds the device sat idle between two operations, by the host
        operation that started last of those running at the gap's middle,
        on any thread (the innermost, where they nest; "(no operation)"
        where none was)."""
        spans = sorted((a, b) for _, a, b in self.device)
        host = sorted(self.host, key=lambda e: e[1])
        starts = [s for _, s, _ in host]
        out: Dict[str, float] = {}
        end = None
        for a, b in spans:
            if end is not None and a > end:
                mid = (a + end) / 2
                i = bisect.bisect_right(starts, mid) - 1
                stop = max(-1, i - SCAN)
                while i > stop and host[i][2] < mid:
                    i -= 1
                name = host[i][0] if i > stop else "(no operation)"
                out[name] = out.get(name, 0.0) + (a - end) / 1e6
            end = b if end is None else max(end, b)
        return out


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profiled:
    """``with Profiled() as p: ...`` profiles the block; ``p.window_s`` is
    its length on the host clock and ``p.trace`` its reduction. The device
    is synchronised at both ends.
    Without a CUDA device (the CPU tests) only the host is recorded."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        _sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    @functools.cached_property
    def trace(self) -> Trace:
        """The reduction, made on first use (after the window: reading the
        profiler's events takes seconds)."""
        from torch.autograd import DeviceType
        device, host = [], []
        for e in self._prof.events():
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    device.append(span)
            else:
                host.append(span)
        return Trace(self.window_s, device, host)
