"""The FLOP counters and the roofline bounds against hand counts at small
shapes."""

import itertools

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.flops import gigapath_modaltune as gflops
from benchmark.harness import roofline
from benchmark.reference import common, steps
from benchmark.tests import tiny
from benchmark.traffic import cohort


def _pairs_by_hand(length, n_valid, segments, ratios, heads, q_range):
    p0, p1 = q_range or (0, length)
    total = 0
    for w, r in zip(segments, ratios):
        sl = min(w, length)
        per_group = -(-heads // r)
        for s0 in range(0, length, sl):
            for g in range(r):
                n_heads = max(0, min(per_group, heads - g * per_group))
                qs = [p for p in range(s0 + g, min(s0 + sl, length), r)
                      if p0 <= p < p1]
                ks = [p for p in range(s0 + g, min(s0 + sl, length), r)
                      if p < n_valid]
                total += n_heads * len(qs) * len(ks)
    return total


@pytest.mark.parametrize("length,n_valid,q_range", [
    (64, 64, None), (100, 77, None), (96, 90, (0, 90)), (130, 120, (16, 80))])
def test_dilated_pairs_by_hand(length, n_valid, q_range):
    segs, ratios = (32, 48, 64, 4096, 8192), (1, 2, 4, 8, 16)
    assert roofline.dilated_pairs(length, n_valid, segs, ratios, 16,
                                  q_range) == _pairs_by_hand(
        length, n_valid, segs, ratios, 16, q_range)


def test_bounds_by_hand():
    # 4 flop a pair a head-dim forward, 10 backward; bytes at 3.35 TB/s
    assert roofline.attention_bound_s(1e9, 48, 0, False) == \
        pytest.approx(4 * 1e9 * 48 / 989e12)
    assert roofline.attention_bound_s(1e9, 48, 0, True) == \
        pytest.approx(10 * 1e9 * 48 / 989e12)
    assert roofline.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def _reference_forward_flops(name, cfg, n):
    """Every product the reference runs for one slide cut to ``n`` tokens
    (its whole length where None), all valid (bucket = n), counted by
    torch's FLOP counter."""
    genes = cfg["genes"]
    rt = common.Runtime()
    model = steps._module(name).Model(rt, cfg, genes["n_pathways"],
                                      genes["max_pathway"])
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
        p.requires_grad_(False)
    wl = tiny.workload()
    case = max(cohort.make_cohort(wl, cfg, 0), key=lambda k: k.length)
    rows = steps.rows_of(case, cfg, [10 ** 6], "cpu")
    n_valid = int(rows["mask"].sum()) if n is None else n
    for k in ("bag", "coords"):
        rows[k] = rows[k][:, :n_valid]
    rows["mask"] = rows["mask"][:, :n_valid]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        common.tiled(model, rows, cfg["train"]["num_tasks"])
    return fc.get_total_flops(), n_valid


def test_gigapath_forward_flops_by_hand():
    cfg = tiny.gigapath_config()
    # 63 tiles and the cls token: one segment a branch (every segment is
    # longer), a multiple of every ratio, so the reference computes exactly
    # the counted pairs
    counted, n = _reference_forward_flops("gigapath_modaltune", cfg, 63)
    assert gflops.forward(cfg, n, n) == pytest.approx(counted, rel=1e-9)


@pytest.mark.parametrize("mod,cfg", [(gflops, tiny.gigapath_config())])
def test_train_counts_more_than_twice_the_forward(mod, cfg):
    for bucket, length in itertools.product([63, 127], [40, 63]):
        f, t = mod.forward(cfg, bucket, length), mod.train(cfg, bucket, length)
        assert 2 * f < t < 4 * f
