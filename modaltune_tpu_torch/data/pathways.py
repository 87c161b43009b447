"""Pathway-grouped gene packing.

Port of ``models/genomic_utils/define_gene_groups.py`` (pathway -> gene
lists from a binary pathway-membership CSV, SurvPath-style) plus the
TPU-side packing: the reference feeds a dict of 331 ragged tensors
(``data_utils/datasets.py:253-264``); here each case's flat gene vector
is gathered once into a dense zero-padded ``(n_groups, max_group_len)``
block so the gene encoder runs as stacked batched matmuls with fully
static shapes.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


def pathway_gene_groups(pathway_csv: str) -> Dict[int, List[str]]:
    """pathway index -> member gene names.

    CSV layout: first column ``gene``, remaining columns one per pathway
    with 0/1 membership (``gene_pathway_processed_v2.csv``: 4987 genes x
    331 pathways in the reference's dataset). Read with the ``csv`` module:
    a cell is a member where it reads as the number 1, as pandas's
    ``df[col] == 1`` has it in the JAX package's copy.
    """
    with open(pathway_csv, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [row for row in reader if row]
    return {i: [row[0] for row in rows if _is_one(row[i + 1])]
            for i in range(len(header) - 1)}


def _is_one(cell: str) -> bool:
    try:
        return float(cell) == 1.0
    except ValueError:
        return False


@dataclasses.dataclass
class GenePacker:
    """Static gather map: flat gene vector -> (n_groups, max_group_len)."""

    indices: np.ndarray   # (G, M) int32 into the gene vector
    mask: np.ndarray      # (G, M) bool — False entries are padding
    group_sizes: tuple

    @classmethod
    def build(cls, groups: Dict[int, List[str]],
              gene_names: Sequence[str],
              max_group_len: Optional[int] = None) -> "GenePacker":
        name_to_col = {g: i for i, g in enumerate(gene_names)}
        sizes = []
        idx_lists = []
        for i in range(len(groups)):
            cols = [name_to_col[g] for g in groups[i] if g in name_to_col]
            idx_lists.append(cols)
            sizes.append(len(cols))
        m = max_group_len or max(sizes)
        g = len(groups)
        indices = np.zeros((g, m), np.int32)
        mask = np.zeros((g, m), bool)
        for i, cols in enumerate(idx_lists):
            n = min(len(cols), m)
            indices[i, :n] = cols[:n]
            mask[i, :n] = True
        return cls(indices=indices, mask=mask, group_sizes=tuple(sizes))

    @property
    def n_groups(self) -> int:
        return self.indices.shape[0]

    @property
    def max_group_len(self) -> int:
        return self.indices.shape[1]

    def pack(self, gene_vector: np.ndarray) -> np.ndarray:
        """(..., n_genes) -> (..., G, M) with padding zeroed."""
        out = np.asarray(gene_vector)[..., self.indices]
        return np.where(self.mask, out, 0.0).astype(np.float32)


def synthetic_pathways(n_genes: int = 60, n_groups: int = 12,
                       max_size: int = 7, seed: int = 0
                       ) -> Dict[int, List[str]]:
    """Random pathway table for tests/benchmarks (gene names g0..gN)."""
    rng = np.random.RandomState(seed)
    groups = {}
    for i in range(n_groups):
        size = rng.randint(1, max_size + 1)
        members = rng.choice(n_genes, size=size, replace=False)
        groups[i] = [f"g{j}" for j in members]
    return groups
