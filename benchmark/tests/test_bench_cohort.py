"""The cohort generator: the same lengths for every seed, drawn as the
workload file says, in an order the seed moves; and the cases handed to the
port's loader so that its first epoch opens with one case of each bucket."""

import collections
import json
import math

import numpy as np

from benchmark.entries import train
from benchmark.reference.steps import bucket_of
from benchmark.tests import tiny
from benchmark.traffic import cohort

REPO = tiny.REPO


def _files(cell):
    wl = json.loads((REPO / "benchmark" / "workloads" / f"{cell}.json")
                    .read_text())
    cfg = json.loads((REPO / "benchmark" / "configs" /
                      "gigapath_modaltune.json").read_text())
    return wl, cfg


def test_cell_lengths_are_the_laws_quantiles():
    wl, _ = _files("gigapath-train-cohort")
    spec = wl["cohort"]["lengths"]
    got = cohort.lengths(spec)
    assert len(got) == spec["cases"] == 20
    assert got == sorted(got) and max(got) == spec["cap"] == 25000
    # the quantile midpoints of the exponential law, by hand
    assert got[0] == round(-spec["mean"] * math.log(1 - 0.5 / 20))
    assert got[10] == round(-spec["mean"] * math.log(1 - 10.5 / 20))
    by_bucket = collections.Counter(bucket_of(n, wl["buckets"]) for n in got)
    assert by_bucket == {4095: 8, 8191: 5, 16383: 5, 25599: 2}


def test_seeds_move_order_and_features_not_the_lengths():
    wl, cfg = tiny.workload(), tiny.gigapath_config()
    a = cohort.make_cohort(wl, cfg, 1)
    b = cohort.make_cohort(wl, cfg, 2)
    assert sorted(k.length for k in a) == sorted(k.length for k in b) \
        == cohort.lengths(wl["cohort"]["lengths"])
    assert not np.allclose(a[0].bag[:8], b[0].bag[:8])
    assert not np.allclose(a[0].genes, b[0].genes)
    again = cohort.make_cohort(wl, cfg, 1)
    for x, y in zip(a, again):
        assert x.length == y.length and np.array_equal(x.bag, y.bag)
        assert np.array_equal(x.genes, y.genes)
    for k in a:
        assert k.bag.shape == (k.length, cfg["in_dim"])
        assert k.genes.shape == (cfg["genes"]["n_pathways"],
                                 cfg["genes"]["max_pathway"])
    wl, cfg = _files("gigapath-train-cohort")
    orders = {tuple(k.length for k in cohort.make_cohort(wl, dict(
        cfg, in_dim=4), seed)) for seed in (1, 2, 2 ** 31 + 7)}
    assert len(orders) == 3


def test_loaders_first_epoch_opens_with_one_case_of_each_bucket():
    from modaltune_tpu_torch.data.datasets import BucketedLoader
    from benchmark.entries.port import CohortDataset
    wl, cfg = _files("gigapath-train-cohort")
    cfg = dict(cfg, in_dim=4)
    for seed in (3, 2 ** 33 + 1):
        cases = cohort.make_cohort(wl, cfg, seed)
        ds = CohortDataset(train.dataset_order(cases, wl["buckets"],
                                               wl["trainer_seed"]))
        loader = BucketedLoader(ds, buckets=wl["buckets"], shuffle=True,
                                seed=wl["trainer_seed"], prefetch=0)
        first = [b.bag.shape[1] for b in loader]
        assert sorted(first[:train.CHECKED_STEPS]) == wl["buckets"]
        assert sorted(first) == sorted(bucket_of(k.length, wl["buckets"])
                                       for k in cases)
        want = train.visit_order(cases, wl["buckets"])
        assert [b.case_ids[0] for b in BucketedLoader(
            ds, buckets=wl["buckets"], seed=wl["trainer_seed"],
            prefetch=0)] == [k.case_id for k in want]


def test_pathway_table_is_fixed_and_full_width():
    genes = tiny.gigapath_config()["genes"]
    t = cohort.pathway_table(genes)
    assert np.array_equal(t, cohort.pathway_table(genes))
    assert (t[0] >= 0).all()
    vec = np.arange(genes["n_genes"], dtype=np.float32)
    packed = cohort.pack_genes(vec, t)
    assert np.array_equal(packed[t >= 0], t[t >= 0].astype(np.float32))
    assert (packed[t < 0] == 0).all()
