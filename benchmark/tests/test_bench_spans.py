"""The device's idle split into between-step and within-step idle, read from
the port's ``mt.train.step`` and ``mt.train.loss_read`` spans: known gaps
on hand-made traces, None without the spans, the two summing to the scaled
idle of the step windows; and on the tiny cell the spans reach the traced
epoch's host events."""

import json
import time

import pytest
import torch

from benchmark.entries.train import Step
from benchmark.harness import cell, step_windows
from benchmark.harness.cell import View
from benchmark.harness.manifest import Manifest
from benchmark.harness.trace import Trace, union_us
from benchmark.tests import tiny

NAMES = ("within_step_idle_ms.train", "between_steps_idle_ms.train")

# three steps (us): (step opens, step closes, read opens, read closes)
SPANS = [(0, 900, 900, 1000), (1200, 1750, 1800, 1900),
         (2000, 2450, 2500, 2600)]
DEVICE = [(-200, -100),                   # the epoch's head
          (100, 300), (400, 600),         # step 0: 100 idle inside
          (1050, 1100),                   # between: the text projection
          (1300, 1500), (1550, 1700),     # step 1: 50 idle inside
          (2100, 2400),                   # step 2: none
          (2700, 2800)]                   # the tail
WINDOWS = [(100, 600), (1300, 1700), (2100, 2400)]
WITHIN_US, BETWEEN_US = 150.0, (700 - 50) + 400.0
WINDOW_S, BUSY_US = 3300e-6, 1300.0


def _trace(spans=SPANS, device=DEVICE):
    host = [("aten::mm", 5, 50)]
    for s0, s1, r0, r1 in spans:
        host += [("mt.train.step", s0, s1), ("mt.train.loss_read", r0, r1),
                 ("mt.step.forward", s0 + 1, s1 - 1)]
    return Trace(window_s=WINDOW_S, host=host,
                 device=[(f"k{i}", a, b) for i, (a, b) in enumerate(device)])


def _view(trace, untraced=(2300e-6, 2200e-6, 2400e-6), kind="train"):
    passes = [99.0, *untraced]                      # pass 0 is traced
    return View(kind, {"steps": [Step("a", 63, 40, traced=True)] * 3,
                       "seconds": sum(passes), "pass_s": passes,
                       "traced_pass": 0, "loader_ms": [1.0],
                       "trace": trace}, tiny.gigapath_config(), None)


def _read(name, view):
    return Manifest.load(tiny.REPO).reader(name)(view)


def test_windows_open_and_close_on_the_spans():
    assert step_windows.windows(_trace()) == WINDOWS


def test_the_readers_give_the_known_idle_scaled_to_the_untraced_epoch():
    # (median untraced 2300 - busy 1300) / traced idle (3300 - 1300) = 0.5
    view = _view(_trace())
    assert _read(NAMES[0], view) == pytest.approx(WITHIN_US * 0.5 / 1e3 / 3)
    assert _read(NAMES[1], view) == pytest.approx(BETWEEN_US * 0.5 / 1e3 / 3)


def test_their_sum_is_the_scaled_idle_of_the_windows():
    trace, view = _trace(), _view(_trace())
    first, last = WINDOWS[0][0], WINDOWS[-1][1]
    inside = [(max(a, first), min(b, last)) for _, a, b in trace.device
              if b > first and a < last]
    idle_us = (last - first) - union_us(inside)
    scale = (2300e-6 - trace.busy_s()) / (trace.window_s - trace.busy_s())
    got = _read(NAMES[0], view) + _read(NAMES[1], view)
    assert got == pytest.approx(idle_us * scale / 1e3 / len(WINDOWS))


def test_overlapping_streams_count_once():
    # a copy on a second stream under step 1's first kernel: no change
    device = DEVICE + [(1350, 1450)]
    view = _view(_trace(device=device))
    busy = union_us([(a, b) for a, b in device]) * 1e-6
    scale = (2300e-6 - busy) / (WINDOW_S - busy)
    assert _read(NAMES[0], view) == pytest.approx(WITHIN_US * scale / 1e3 / 3)


def test_a_faster_untraced_epoch_than_the_busy_time_reads_zero():
    view = _view(_trace(), untraced=(1000e-6, 1100e-6))
    assert _read(NAMES[0], view) == 0 and _read(NAMES[1], view) == 0


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_spans_a_trace_or_a_train_entry(name):
    bare = _trace()
    bare.host = [e for e in bare.host if not e[0].startswith("mt.train.")]
    assert _read(name, _view(bare)) is None
    assert _read(name, _view(_trace(device=[]))) is None
    assert _read(name, _view(None)) is None
    assert _read(name, _view(_trace(), kind="embed")) is None
    assert _read(name, _view(_trace(), untraced=())) is None


STEP_SPANS = '''"""Traced steps whose mt.train.step span reached the trace."""


def read(view):
    return float(sum(n == "mt.train.step" for n, _, _ in view.trace.host))
'''


def test_the_tiny_cells_traced_epoch_holds_the_step_spans(tiny_root):
    (tiny_root / "benchmark" / "metrics" / "step_spans.py").write_text(
        STEP_SPANS)
    p = tiny_root / "BENCHMARK.json"
    m = json.loads(p.read_text())
    extra = {"unit": "ms", "better": "lower", "source": "program_span",
             "layer": "steps", "moves": "train_slides_per_s",
             "workloads": ["tiny-gigapath-train"]}
    m["per_layer"] += [dict(extra, name=n) for n in NAMES]
    m["per_layer"].append(dict(extra, name="step_spans", unit="steps"))
    p.write_text(json.dumps(m))
    r = cell.run(tiny_root, "tiny-gigapath-train", 2 ** 31 + 77, 0.2, True,
                 torch.device("cpu"), time.perf_counter(), log=print)
    assert r["correct"], r["checks"]
    # every cohort case once in the traced epoch; no device lane on the CPU
    assert r["metrics"]["step_spans"]["value"] == \
        tiny.workload()["cohort"]["lengths"]["cases"]
    assert not set(NAMES) & set(r["metrics"])
