"""BENCHMARK.json's form: the repository's passes; each kind of fault is
refused."""

import pytest

from benchmark.harness.manifest import Manifest, ManifestError
from benchmark.tests import tiny


def test_the_repositorys_manifest_passes():
    m = Manifest.load(tiny.REPO)
    for cell in m.data["workloads"]:
        assert "setup_s" in m.e2e_names(cell["name"])
        assert (tiny.REPO / "benchmark" / "workloads" /
                f"{cell['traffic']}.json").is_file()
    for metric in m.data["per_layer"]:
        assert (tiny.REPO / "benchmark" / "metrics" /
                f"{metric['name']}.py").is_file()


def test_the_tiny_manifest_passes():
    Manifest(tiny.manifest(), tiny.REPO)


def _breaks(edit):
    d = tiny.manifest()
    edit(d)
    with pytest.raises(ManifestError):
        Manifest(d, tiny.REPO)


def _metric(d, name):
    return next(m for m in d["end_to_end"] + d["per_layer"]
                if m["name"] == name)


@pytest.mark.parametrize("edit", [
    lambda d: _metric(d, "train_mfu").update(name="train mfu"),
    lambda d: _metric(d, "train_mfu").update(name="train,mfu"),
    lambda d: _metric(d, "peak_mem_gib").update(unit="giga bytes"),
    lambda d: _metric(d, "peak_mem_gib").update(unit="µs"),
    lambda d: _metric(d, "train_mfu").update(better="up"),
    lambda d: _metric(d, "train_mfu").update(why="a key of its own"),
    lambda d: _metric(d, "setup_s").update(bound=0.3),
    lambda d: _metric(d, "train_slides_per_s").update(source="program_span"),
    lambda d: d["end_to_end"].remove(_metric(d, "setup_s")),
    # a per-layer metric whose cell does not report what it moves
    lambda d: (d["workloads"].append(dict(d["workloads"][0], name="other")),
               _metric(d, "train_mfu")["workloads"].append("other")),
    lambda d: _metric(d, "train_mfu").update(moves="no_such_metric"),
    lambda d: d["workloads"].append(dict(d["workloads"][0], name="again")),
    lambda d: d["workloads"][0].update(chips=2),
    lambda d: d["workloads"][0].update(why="two\nlines"),
    lambda d: d["configs"][0].update(file="/abs/config.json"),
    lambda d: d.update(run_seconds=52),
    lambda d: d.update(extra=1),
])
def test_faults_are_refused(edit):
    _breaks(edit)


def test_a_cell_without_per_layer_metrics_is_refused():
    def edit(d):
        d["workloads"].append(dict(d["workloads"][0], name="other"))
        _metric(d, "train_slides_per_s")["workloads"].append("other")
    _breaks(edit)


def test_manifest_size_limit():
    assert len((tiny.REPO / "BENCHMARK.json").read_text()) < 64 * 1024
