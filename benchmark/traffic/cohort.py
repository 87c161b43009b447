"""A cohort of cases, made from a workload file and a seed.

``cohort.lengths`` fixes the tile counts: ``cases`` quantiles of an
exponential law of the given ``mean`` (the quantile midpoints
(i + 0.5) / cases), each capped at ``cap``, the tiles the dataset keeps of
a larger slide. Every seed asks for the same lengths, so the same work;
the seed moves their order, the features, the coordinates, the genes, the
text embeddings and the labels.

A bag has one feature row per tile at 20x, with tile coordinates of
``tile_px`` pixels on a compact blob of grid cells. Features are windows
of one seeded host pool, genes a standard normal expression vector packed
into the configuration's pathway blocks (a table made from the
configuration's own seed).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass
class Case:
    case_id: str
    bag: np.ndarray        # (n, in_dim) float32
    coords: np.ndarray     # (n, 2) float32, level-0 pixels (y, x)
    length: int            # tiles
    genes: np.ndarray      # (n_pathways, max_pathway) float32
    text: np.ndarray       # (4, 512) float32
    label: int
    duration: float
    event: int


def pathway_table(genes: dict) -> np.ndarray:
    """(n_pathways, max_pathway) gene indices, -1 for padding: pathways of
    1..max_pathway distinct genes drawn from ``genes["table_seed"]``, the
    first of the full size."""
    rng = np.random.RandomState(genes["table_seed"])
    n, m, total = genes["n_pathways"], genes["max_pathway"], genes["n_genes"]
    table = np.full((n, m), -1, np.int64)
    for i in range(n):
        size = m if i == 0 else rng.randint(1, m + 1)
        table[i, :size] = rng.choice(total, size=size, replace=False)
    return table


def pack_genes(vec: np.ndarray, table: np.ndarray) -> np.ndarray:
    return np.where(table >= 0, vec[np.maximum(table, 0)], 0.0).astype(
        np.float32)


def lengths(spec: dict) -> List[int]:
    """Every case's tile count, shortest first: the quantile midpoints of
    an exponential law of mean ``spec["mean"]``, capped at
    ``spec["cap"]``."""
    n, mean = spec["cases"], spec["mean"]
    return [min(spec["cap"], max(1, int(round(
        -mean * math.log(1.0 - (i + 0.5) / n))))) for i in range(n)]


def _blob(rng, n: int) -> np.ndarray:
    """``n`` distinct (row, col) cells of a square about 1.3x their count,
    in row-major order."""
    side = int(np.ceil(np.sqrt(n * 1.3)))
    pick = np.sort(rng.choice(side * side, size=n, replace=False))
    return np.stack(np.divmod(pick, side), axis=1)


def make_cohort(workload: dict, config: dict, seed: int) -> List[Case]:
    c = workload["cohort"]
    rng = np.random.default_rng(seed)
    lens = lengths(c["lengths"])
    lens = [lens[i] for i in rng.permutation(len(lens))]
    in_dim = config["in_dim"]
    pool = rng.standard_normal((max(lens) + c["pool_slack"], in_dim),
                               dtype=np.float32)
    table = pathway_table(config["genes"])
    cases = []
    for i, n in enumerate(lens):
        xy = _blob(rng, n) * float(c["tile_px"])
        off = int(rng.integers(0, pool.shape[0] - n + 1))
        gvec = rng.standard_normal(config["genes"]["n_genes"]).astype(
            np.float32)
        cases.append(Case(
            case_id=f"case_{i:03d}", bag=pool[off:off + n],
            coords=xy.astype(np.float32), length=n,
            genes=pack_genes(gvec, table),
            text=rng.standard_normal((4, 512), dtype=np.float32),
            label=int(rng.integers(0, 2)),
            duration=float(rng.integers(1, 120)),
            event=int(rng.random() < 0.6)))
    return cases
