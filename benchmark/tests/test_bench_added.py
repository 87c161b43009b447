"""A cell, a configuration and a per-layer metric are found from files
added in a copy of the benchmark, with no file there edited; each cell
runs end to end on the CPU (the port's plain versions in place of its
kernels) and its check passes."""

import json

import pytest
import torch

from benchmark.harness import cell
from benchmark.tests import tiny

METRIC = '''"""Steps of the window, a count."""


def read(view):
    return float(len(view.record["steps"]))
'''


def _run(root, name, trace=True, seed=2 ** 31 + 12345):
    import time
    return cell.run(root, name, seed, 0.2, trace, torch.device("cpu"),
                    time.perf_counter(), log=print)


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_added_cells_run_and_are_correct(tiny_root, name):
    r = _run(tiny_root, name, trace=False)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert list(r)[-1] == "checks"
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {e["name"] for e in m["end_to_end"]
            if name in e.get("workloads", [name])}
    assert set(r["metrics"]) == want


def test_added_metric_is_read(tiny_root):
    (tiny_root / "benchmark" / "metrics" / "window_steps.py").write_text(
        METRIC)
    p = tiny_root / "BENCHMARK.json"
    m = json.loads(p.read_text())
    m["per_layer"].append({"name": "window_steps", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "steps", "moves": "train_slides_per_s",
                           "workloads": ["tiny-gigapath-train"]})
    p.write_text(json.dumps(m))
    r = _run(tiny_root, "tiny-gigapath-train")
    assert r["metrics"]["window_steps"]["value"] == r["attempted"]
    assert "train_mfu" in r["metrics"] and r["correct"]
    assert set(r["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
