"""``BENCHMARK.json``: loading, the checks of its form, and the lookups by
name that make the harness run from data: a cell's configuration file,
its workload file (traffic, entry, limits) and the per-layer metric
readers under ``benchmark/metrics/``."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}\Z")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class ManifestError(ValueError):
    pass


def _line(text, what):
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or \
            "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(text, what):
    if not isinstance(text, str) or not NAME.match(text):
        raise ManifestError(f"{what} {text!r} is not a name")


class Manifest:
    def __init__(self, data: dict, root: Path):
        self.data, self.root = data, Path(root)
        self.validate()

    @classmethod
    def load(cls, root) -> "Manifest":
        root = Path(root)
        return cls(json.loads((root / "BENCHMARK.json").read_text()), root)

    # -- checks --------------------------------------------------------
    def validate(self) -> None:
        d = self.data
        if set(d) != TOP:
            raise ManifestError(f"keys {sorted(d)} are not {sorted(TOP)}")
        if not 1 <= len(d["paths"]) <= 16 or not all(
                PATH.match(p) and not p.startswith("/") and ".." not in
                p.split("/") for p in d["paths"]):
            raise ManifestError("paths: 1 to 16 relative directories")
        if not 1 <= len(d["command"]) <= 32:
            raise ManifestError("command: 1 to 32 words")
        for w in d["command"]:
            _line(w, "a word of command")
        if not (isinstance(d["run_seconds"], int)
                and 1 <= d["run_seconds"] <= 51):
            raise ManifestError("run_seconds: a whole number, 1 to 51")
        names = set()

        def unique(kind, entries, keys, extra=()):
            for e in entries:
                if not set(keys) <= set(e) <= set(keys) | set(extra):
                    raise ManifestError(f"{kind} {e.get('name')}: keys "
                                        f"{sorted(e)}")
                _name(e["name"], kind)
                if e["name"] in names:
                    raise ManifestError(f"{e['name']} named twice")
                names.add(e["name"])

        unique("config", d["configs"], CONFIG_KEYS)
        configs = {c["name"]: c for c in d["configs"]}
        for c in d["configs"]:
            _line(c["source"], "source")
            _line(c["why"], "why")
            if len(c["reduced"]) > 16:
                raise ManifestError("reduced: at most 16 keys")
            for k in c["reduced"]:
                _name(k, "reduced key")
            self._inside_paths(c["file"])
        if not 1 <= len(d["configs"]) <= 24:
            raise ManifestError("configs: 1 to 24")
        unique("workload", d["workloads"], CELL_KEYS)
        pairs = set()
        for w in d["workloads"]:
            _name(w["config"], "config")
            _name(w["traffic"], "traffic")
            _line(w["why"], "why")
            if w["config"] not in configs:
                raise ManifestError(f"{w['name']}: no config {w['config']}")
            if w["chips"] not in (1, 4):
                raise ManifestError(f"{w['name']}: chips is 1 or 4")
            if (w["config"], w["traffic"]) in pairs:
                raise ManifestError(f"{w['name']}: pair named twice")
            pairs.add((w["config"], w["traffic"]))
        if not 1 <= len(d["workloads"]) <= 24:
            raise ManifestError("workloads: 1 to 24")
        used = {w["config"] for w in d["workloads"]}
        if used != set(configs):
            raise ManifestError(f"configs used by no cell: "
                                f"{sorted(set(configs) - used)}")
        cells = {w["name"] for w in d["workloads"]}
        unique("end-to-end metric", d["end_to_end"], E2E_KEYS, ["workloads"])
        unique("per-layer metric", d["per_layer"], LAYER_KEYS, ["workloads"])
        if not 1 <= len(d["end_to_end"]) <= 16:
            raise ManifestError("end_to_end: 1 to 16")
        if not 1 <= len(d["per_layer"]) <= 128:
            raise ManifestError("per_layer: 1 to 128")
        e2e = {m["name"]: m for m in d["end_to_end"]}
        if "setup_s" not in e2e:
            raise ManifestError("end_to_end needs setup_s")
        for m in d["end_to_end"] + d["per_layer"]:
            if not UNIT.match(m["unit"]):
                raise ManifestError(f"{m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                raise ManifestError(f"{m['name']}: better is lower or higher")
            if not set(m.get("workloads", cells)) <= cells:
                raise ManifestError(f"{m['name']}: unknown cells")
        for m in d["end_to_end"]:
            if m["source"] not in ("host_clock", "device_trace"):
                raise ManifestError(f"{m['name']}: source")
            if not 0 < m["bound"] <= 0.25:
                raise ManifestError(f"{m['name']}: bound in (0, 0.25]")
        for m in d["per_layer"]:
            if m["source"] not in ("device_trace", "program_span",
                                   "program_counter", "host_clock"):
                raise ManifestError(f"{m['name']}: source")
            _line(m["layer"], "layer")
            if m["moves"] not in e2e:
                raise ManifestError(f"{m['name']}: moves {m['moves']}")
            for cell in m.get("workloads", cells):
                if m["moves"] not in self.e2e_names(cell):
                    raise ManifestError(f"{m['name']}: cell {cell} does not "
                                        f"report {m['moves']}")
        for cell in cells:
            if len(self.e2e_names(cell)) < 2:
                raise ManifestError(f"{cell}: setup_s and one more "
                                    f"end-to-end metric")
            if not self.per_layer_names(cell):
                raise ManifestError(f"{cell}: no per-layer metric")
        if len(json.dumps(d)) > 64 * 1024:
            raise ManifestError("BENCHMARK.json is over 64 KiB")

    def _inside_paths(self, rel: str) -> None:
        if not any(rel.startswith(p.rstrip("/") + "/")
                   for p in self.data["paths"]):
            raise ManifestError(f"{rel} lies outside paths")

    # -- lookups -------------------------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise ManifestError(f"no workload {name!r}")

    def config_entry(self, name: str) -> dict:
        return next(c for c in self.data["configs"] if c["name"] == name)

    def _for(self, metrics: List[dict], cell: str) -> List[dict]:
        return [m for m in metrics if cell in m.get("workloads", [cell])]

    def e2e_names(self, cell: str) -> List[str]:
        return [m["name"] for m in self._for(self.data["end_to_end"], cell)]

    def per_layer_names(self, cell: str) -> List[str]:
        return [m["name"] for m in self._for(self.data["per_layer"], cell)]

    def units(self) -> Dict[str, str]:
        return {m["name"]: m["unit"] for m in
                self.data["end_to_end"] + self.data["per_layer"]}

    def config(self, cell: dict) -> dict:
        return json.loads((self.root / self.config_entry(cell["config"])
                           ["file"]).read_text())

    def workload(self, cell: dict) -> dict:
        return json.loads((self.root / "benchmark" / "workloads" /
                           f"{cell['traffic']}.json").read_text())

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
