"""Named spans on the profiler's clock.

:func:`span` opens a ``torch.profiler.record_function`` range while a
torch profiler records (``utils.profiling.trace``, or any
``torch.profiler.profile``), and otherwise returns one shared null
context, so an unprofiled step pays a flag check a span. A span keeps no
clock or buffer of its own: the profiler holds it beside the CUDA kernels
it records, on the same time base, and hands it over when it stops.

Every name is a fixed string under ``mt.``; a span's parent is the span
that encloses it on its thread. The trainer's loop opens ``mt.train.*``,
the train step ``mt.step.*``, the model ``mt.backbone.*``,
``mt.adapter.*`` and ``mt.gene.*``, and each ``*_cuda`` launcher of
``ops/`` one ``mt.op.<kernel>`` around its launch.
``python -m modaltune_tpu_torch.tools.trace_report LOG_DIR --spans``
sums a trace's device and host time by the innermost span.
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records on this
    thread; the shared null context otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
