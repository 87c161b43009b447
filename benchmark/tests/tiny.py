"""A copy of the benchmark with a cell of its own at CPU-test sizes: a tiny
ModalTune-GigaPath configuration in fp32, a cohort of four cases, and the
repository's per-layer metric readers."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _config(name: str) -> dict:
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def gigapath_config() -> dict:
    c = _config("gigapath_modaltune")
    c["name"], c["precision"], c["in_dim"] = "tiny_gigapath", "fp32", 64
    m = c["model"]
    m["backbone"].update(in_chans=64, embed_dim=128, depth=4,
                         max_wsi_size=16384, remat=True)
    m["adapter"].update(num_heads=4, interaction_indexes=[[0, 1], [2, 3]])
    m["gene"].update(latent_dim=32, depth=2, final_groups=8, output_dim=128)
    c["longnet"].update(num_layers=4, embed_dim=128, ffn_dim=512,
                        segment_lengths=[1024, 1448, 2048, 2896, 4096])
    c["genes"] = dict(n_genes=60, n_pathways=12, max_pathway=7, table_seed=0)
    return c


def workload() -> dict:
    cohort = {"lengths": {"cases": 4, "mean": 60, "cap": 120},
              "pool_slack": 64, "tile_px": 256}
    limits = {"loss_gap": 1e-4, "grad_norm_gap": 1e-3,
              "change_norm_gap": 1e-2}
    return {"generator": "cohort", "entry": "train", "buckets": [63, 127],
            "cohort": cohort, "limits": limits, "trainer_seed": 5}


# every metric of the benchmark, on the tiny cell
E2E = [
    {"name": "train_slides_per_s", "unit": "slides/s", "better": "higher", "bound": 0.05, "source": "host_clock", "workloads": ["tiny-gigapath-train"]},
    {"name": "peak_mem_gib", "unit": "GiB", "better": "lower", "bound": 0.01, "source": "device_trace"},
    {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
]
PER_LAYER = [
    {"name": "loader_wait_ms.train", "unit": "ms", "better": "lower", "source": "program_span", "layer": "data", "moves": "train_slides_per_s", "workloads": ["tiny-gigapath-train"]},
    {"name": "train_mfu", "unit": "%", "better": "higher", "source": "host_clock", "layer": "steps", "moves": "train_slides_per_s", "workloads": ["tiny-gigapath-train"]},
    {"name": "torch_ops_ms_per_slide.train", "unit": "ms", "better": "lower", "source": "device_trace", "layer": "model", "moves": "train_slides_per_s", "workloads": ["tiny-gigapath-train"]},
    {"name": "dilated_attn_roofline.train", "unit": "%", "better": "higher", "source": "device_trace", "layer": "kernels", "moves": "train_slides_per_s", "workloads": ["tiny-gigapath-train"]},
    {"name": "device_idle_share.train", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device", "moves": "train_slides_per_s", "workloads": ["tiny-gigapath-train"]},
]

CELLS = {
    "tiny-gigapath-train": "tiny_gigapath",
}


def make_root(tmp: Path) -> Path:
    """A checkout-like root: ``BENCHMARK.json`` naming the tiny cells, and
    ``benchmark/`` with their configuration and workload files added."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "configs" / "tiny_gigapath.json").write_text(
        json.dumps(gigapath_config()))
    for name in CELLS:
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(
            json.dumps(workload()))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest(), indent=1))
    return root


def manifest() -> dict:
    """The tiny cell's ``BENCHMARK.json``: the repository's command and
    run length, every metric."""
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    m["configs"] = [
        {"name": n, "source": "https://example.org/tiny", "reduced": [],
         "file": f"benchmark/configs/{n}.json", "why": "CPU tests"}
        for n in ("tiny_gigapath",)]
    m["workloads"] = [{"name": name, "config": cfg, "traffic": name,
                       "chips": 1, "why": "CPU tests"}
                      for name, cfg in CELLS.items()]
    m["end_to_end"], m["per_layer"] = copy.deepcopy(E2E), copy.deepcopy(
        PER_LAYER)
    return m
