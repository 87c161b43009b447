"""Profiling helpers: a ``torch.profiler`` trace and a step timer.

Counterpart of ``modaltune_tpu/utils/profiling.py``. :func:`trace` writes
a Chrome trace (``chrome://tracing``, Perfetto) under its directory, which
``python -m modaltune_tpu_torch.tools.trace_report`` sums by op class;
:class:`StepTimer` keeps per-step wall times.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch

@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where the process sees a GPU; op input shapes recorded) and
    write its Chrome trace to ``log_dir/<time>_<pid>.pt.trace.json.gz``."""
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        name = f"{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.pt.trace.json.gz"
        prof.export_chrome_trace(str(Path(log_dir) / name))


class StepTimer:
    """Per-step wall times. :meth:`stop` anchors the step's end on a host
    fetch of ``sync_value`` (a tensor the step produced), which cannot
    return before the device has computed it."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if sync_value is not None:
            float(torch.as_tensor(sync_value).detach().reshape(-1)[0].cpu())
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = sorted(self.times)
        n = len(t)
        return {
            "steps": n,
            "mean_s": sum(t) / n,
            "p50_s": t[n // 2],
            "p90_s": t[int(n * 0.9)],
            "total_s": sum(t),
        }
