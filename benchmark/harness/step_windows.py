"""The traced epoch's train steps as windows on the device's timeline, read
from the port's own spans (``modaltune_tpu_torch/utils/tracing.py``), and
the device's idle split between them and inside them.

Step k's window is [a_k, b_k]: a_k the start of the first device operation
that starts after its ``mt.train.step`` opens, b_k the end of the last that
starts before its ``mt.train.loss_read`` closes (the per-step sync). Idle
inside the windows is the host's dispatch falling behind the card; idle
between b_k and a_{k+1} is the sync, the loader, the copy, the text
projection and the forward's prologue. The epoch's head and tail lie in
neither."""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Tuple

STEP, READ = "mt.train.step", "mt.train.loss_read"


def windows(trace) -> List[Tuple[float, float]]:
    """[(a_k, b_k)] in us, one a step that launched device work; empty
    where the trace holds no step span (a program without them)."""
    opens = sorted(a for n, a, _ in trace.host if n == STEP)
    closes = sorted(b for n, _, b in trace.host if n == READ)
    ops = sorted((a, b) for _, a, b in trace.device)
    starts = [a for a, _ in ops]
    out = []
    for s in opens:
        k = bisect.bisect_left(closes, s)
        if k == len(closes):
            continue
        i = bisect.bisect_left(starts, s)
        j = bisect.bisect_right(starts, closes[k])
        if i < j:
            out.append((starts[i], max(b for _, b in ops[i:j])))
    return out


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _idle(busy, starts, x: float, y: float) -> float:
    """The part of [x, y] that no merged busy interval covers, us."""
    t = 0.0
    i = max(bisect.bisect_right(starts, x) - 1, 0)
    while i < len(busy) and busy[i][0] < y:
        t += max(0.0, min(y, busy[i][1]) - max(x, busy[i][0]))
        i += 1
    return (y - x) - t


def idle_ms(view) -> Optional[Tuple[float, float]]:
    """(within, between): the device's idle inside the step windows and
    between them, scaled to the untraced epoch by (median untraced epoch -
    traced busy) / traced idle, clamped at 0 (``device_idle_share.train``'s
    quantities), in ms a traced step. None without step spans."""
    t = view.trace
    if view.kind != "train" or t is None or not view.untraced_pass_s:
        return None
    w = windows(t)
    idle = t.window_s - t.busy_s()
    if not w or idle <= 0:
        return None
    busy = _merged((a, b) for _, a, b in t.device)
    starts = [a for a, _ in busy]
    within = sum(_idle(busy, starts, a, b) for a, b in w)
    between = sum(_idle(busy, starts, b, a2)
                  for (_, b), (a2, _) in zip(w, w[1:]) if a2 > b)
    scale = max(0.0, statistics.median(view.untraced_pass_s)
                - t.busy_s()) / idle
    return (within * scale / 1e3 / len(w), between * scale / 1e3 / len(w))
