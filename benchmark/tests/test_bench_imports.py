"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port; and a
run refuses to print a result once such a module is loaded."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness import cell
from benchmark.tests import tiny

BENCH = tiny.REPO / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(where):
    return sorted(p for p in where.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _files(BENCH), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(cell.FORBIDDEN)


@pytest.mark.parametrize("path", _files(BENCH / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"modaltune_tpu_torch", "modaltune_tpu", "jax"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "modaltune_tpu_torch.fake", object())
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "modaltune_tpu.fake", object())
    assert cell.forbidden_modules() == ["modaltune_tpu"]


def test_a_run_with_jax_loaded_prints_no_result(tiny_root, monkeypatch):
    import time
    import torch
    monkeypatch.setitem(sys.modules, "jax", object())
    assert cell.run(tiny_root, "tiny-gigapath-train", 5, 0.1, False,
                    torch.device("cpu"), time.perf_counter(),
                    log=lambda m: None) is None


def test_run_fails_without_a_card_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "gigapath-train-cohort", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_tiny_cells_run_on_the_card(tiny_root, card):
    for name in sorted(tiny.CELLS):
        r = cell.run(tiny_root, name, 77, 0.5, True, card,
                     __import__("time").perf_counter(), log=print)
        assert r["correct"], r["checks"]
        assert r["device"]["busy_s"] > 0
