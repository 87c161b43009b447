"""Host-side data pipeline: case-wise feature-bag dataset + bucketed
batching.

Re-design of ``data_utils/datasets.py`` (``FeaturesGeneTextDataset``) for
TPU execution:

* same case-wise semantics — multi-slide bags concatenated with a +1500
  y-offset between slides (``datasets.py:231-239``), random subsample to
  ``threshold`` patches with **sorted** kept indices
  (``datasets.py:274-281``), per-case CONCH text embeddings ``[4, 512]``,
  StandardScaler-normalized gene matrix merged on ``case_submitter_id``
  (``datasets.py:183-197``), optional clinical feature vector;
* but batches are **bucket-padded to static shapes** with a validity
  mask, so every train/eval step hits a cached XLA program instead of
  recompiling per bag length;
* gene dicts of 331 ragged tensors become one dense
  ``(n_groups, max_group_len)`` block (see ``pathways.GenePacker``).

Feature bags load from ``.npz`` (keys ``features``/``coords``), the
reference's torch ``.pt`` caches, or the packed container of
``bagcache.py`` (``cache.mtbc:IDX``). The port's copy reads CSV tables
with the ``csv`` module where the JAX package's uses pandas, and loads
``.pt`` files with ``weights_only=True``: the reference's feature, text
and clinical files are dicts of tensors.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import threading
import queue as queue_mod
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .pathways import GenePacker

# Bucket sizes are 1024-multiples MINUS ONE so the encoder sequence
# (bag + cls token) stays a multiple of LongNet's smallest segment
# length: an unaligned length forces segment padding in every dilated
# branch, measured at ~9% of the whole train step on v5e
# (+2.5 ms fwd / +8.5 ms bwd per layer at the 10k bucket).
DEFAULT_BUCKETS = (1023, 2047, 4095, 8191, 16383, 25599)

# BucketedLoader's worker re-checks its stop flag between timed puts; a
# consumer that leaves early waits at most JOIN_WAIT_S for the worker to
# finish the batch it is building
PUT_WAIT_S = 0.05
JOIN_WAIT_S = 10.0


def choose_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class Example:
    """One case (patient), host-side numpy."""

    bag: np.ndarray            # (L, in_chans) float32
    coords: np.ndarray         # (L, 2) float32
    genes: np.ndarray          # (G, M) float32 packed pathway blocks
    text: np.ndarray           # (4, 512) float32 CONCH prompt embeddings
    clinical: Optional[np.ndarray]  # (clinfeat_dim,) or None
    label: int
    duration: float
    event: int                 # vital_status (1 = event observed)
    case_id: str
    site: int = 0              # pan-cancer site label


@dataclasses.dataclass
class Batch:
    """Device-ready padded batch (all arrays stacked along axis 0)."""

    bag: np.ndarray            # (B, Lb, C)
    coords: np.ndarray         # (B, Lb, 2)
    mask: np.ndarray           # (B, Lb) bool
    genes: np.ndarray          # (B, G, M)
    text: np.ndarray           # (B, 4, 512)
    clinical: Optional[np.ndarray]
    label: np.ndarray          # (B,)
    duration: np.ndarray       # (B,)
    event: np.ndarray          # (B,)
    site: np.ndarray           # (B,)
    case_ids: List[str]
    # trailing rows that are wrap-around padding (pad_to_batch mode, for
    # mesh-divisible batch shapes); eval paths drop them from outputs
    pad_rows: int = 0


def pad_bag(bag: np.ndarray, coords: np.ndarray, bucket: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    l = bag.shape[0]
    mask = np.zeros(bucket, bool)
    mask[:l] = True
    if l < bucket:
        bag = np.pad(bag, ((0, bucket - l), (0, 0)))
        coords = np.pad(coords, ((0, bucket - l), (0, 0)))
    return bag[:bucket], coords[:bucket], mask


def collate(examples: Sequence[Example], bucket: int) -> Batch:
    bags, coords, masks = [], [], []
    for ex in examples:
        b, c, m = pad_bag(ex.bag, ex.coords, bucket)
        bags.append(b)
        coords.append(c)
        masks.append(m)
    clinical = None
    if examples[0].clinical is not None:
        clinical = np.stack([ex.clinical for ex in examples])
    return Batch(
        bag=np.stack(bags).astype(np.float32),
        coords=np.stack(coords).astype(np.float32),
        mask=np.stack(masks),
        genes=np.stack([ex.genes for ex in examples]).astype(np.float32),
        text=np.stack([ex.text for ex in examples]).astype(np.float32),
        clinical=clinical,
        label=np.array([ex.label for ex in examples], np.int32),
        duration=np.array([ex.duration for ex in examples], np.float32),
        event=np.array([ex.event for ex in examples], np.int32),
        site=np.array([ex.site for ex in examples], np.int32),
        case_ids=[ex.case_id for ex in examples],
    )


_BAGCACHE_READERS: Dict[str, object] = {}


def load_feature_bag(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load one slide's cached tile features: (features, coords).

    Supports per-slide ``.npz``/``.pt`` files and the packed native
    container via ``cache.mtbc:IDX`` paths (see data/bagcache.py)."""
    if ".mtbc:" in str(path):
        base, idx = str(path).rsplit(":", 1)
        from .bagcache import BagCacheReader
        reader = _BAGCACHE_READERS.get(base)
        if reader is None:
            reader = BagCacheReader(base)
            _BAGCACHE_READERS[base] = reader
        return reader.read(int(idx))
    p = Path(path)
    if p.suffix == ".npz":
        z = np.load(p)
        return np.asarray(z["features"], np.float32), \
            np.asarray(z["coords"], np.float32)
    if p.suffix in (".pt", ".pth"):
        import torch
        d = torch.load(p, map_location="cpu", weights_only=True)
        return d["features"].numpy().astype(np.float32), \
            d["coords"].numpy().astype(np.float32)
    raise ValueError(f"Unsupported feature file: {path}")


def load_embedding_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a ``case_id -> array`` embedding table.

    Accepts ``.npz`` archives and the reference's torch ``.pt``/``.pth``
    dicts as-is (text embeddings and clinical features are distributed
    that way: ``data_utils/datasets.py:180,203`` torch.loads
    ``text_location``/``clinical_location``), so a reference user's
    existing artifacts drop straight in."""
    p = Path(path)
    if p.suffix == ".npz":
        z = np.load(p)
        return {k: np.asarray(z[k], np.float32) for k in z.files}
    if p.suffix in (".pt", ".pth"):
        import torch
        d = torch.load(p, map_location="cpu", weights_only=True)
        return {str(k): np.asarray(v.numpy() if hasattr(v, "numpy")
                                   else v, np.float32)
                for k, v in d.items()}
    raise ValueError(f"Unsupported embedding table: {path}")


class FeatureBagDataset:
    """Case-wise multi-modal dataset over a split datalist.

    Args:
      datalist: list of per-slide dicts (the reference's split-JSON rows:
        ``case_id``, ``case_submitter_id``, ``features_path``, label
        fields, ``vital_status``, ``durations``, ``project_id``...).
      gene_matrix: (n_cases, n_genes) float32, already normalized.
      gene_case_ids: row order of ``gene_matrix`` (case_submitter_id).
      packer: GenePacker for pathway blocks.
      text_embeddings: case_id -> (4, 512) array.
      clinical: case_id -> (clinfeat_dim,) array, or None.
      labelset: which field is the class label.
      threshold: max patches per bag (random sorted subsample above it).
      site_label: project_id -> int site mapping (pan-cancer), optional.
    """

    def __init__(self, datalist: List[dict], gene_matrix: np.ndarray,
                 gene_case_ids: Sequence[str], packer: GenePacker,
                 text_embeddings: Dict[str, np.ndarray],
                 clinical: Optional[Dict[str, np.ndarray]] = None,
                 labelset: str = "primary_class", threshold: int = 25000,
                 site_label: Optional[Dict[str, int]] = None):
        self.packer = packer
        self.text_embeddings = text_embeddings
        self.clinical = clinical
        self.labelset = labelset
        self.threshold = threshold
        self.site_label = site_label or {}
        self.gene_rows = {cid: i for i, cid in enumerate(gene_case_ids)}
        self.gene_matrix = np.asarray(gene_matrix, np.float32)

        # keep only cases present in the gene table (datasets.py:192-197)
        self.by_case: Dict[str, List[dict]] = {}
        for row in datalist:
            if row["case_submitter_id"] not in self.gene_rows:
                continue
            self.by_case.setdefault(row["case_id"], []).append(row)
        self.case_ids = sorted(self.by_case)

    def __len__(self) -> int:
        return len(self.case_ids)

    def metadata(self) -> List[dict]:
        """First slide row per case (for eval label frames)."""
        return [self.by_case[c][0] for c in self.case_ids]

    def get(self, index: int, rng: np.random.RandomState) -> Example:
        case_id = self.case_ids[index]
        rows = self.by_case[case_id]
        bags, coords = [], []
        offset = 0.0
        for row in rows:
            f, c = load_feature_bag(row["features_path"])
            c = c + np.array([0.0, offset], np.float32)
            # +1500 between slides, like datasets.py:236-238
            offset = float(c[:, 1].max()) + 1500.0
            bags.append(f)
            coords.append(c)
        bag = np.concatenate(bags)
        coord = np.concatenate(coords)
        if bag.shape[0] > self.threshold:
            idx = np.sort(rng.permutation(bag.shape[0])[:self.threshold])
            bag, coord = bag[idx], coord[idx]

        meta = rows[0]
        gene_vec = self.gene_matrix[self.gene_rows[meta["case_submitter_id"]]]
        label = meta.get(self.labelset, -1)
        label = int(label) if label is not None and str(label) != "nan" \
            else -1
        dur = meta.get("durations", float("nan"))
        dur = float(dur) if dur is not None else float("nan")
        ev = meta.get("vital_status", 0)
        clin = None
        if self.clinical is not None:
            clin = np.asarray(self.clinical[case_id], np.float32)
        return Example(
            bag=bag, coords=coord, genes=self.packer.pack(gene_vec),
            text=np.asarray(self.text_embeddings[case_id], np.float32),
            clinical=clin, label=label, duration=dur, event=int(ev),
            case_id=case_id,
            site=self.site_label.get(meta.get("project_id", ""), 0))


class SyntheticSlideDataset:
    """Random dataset with the FeatureBagDataset interface, for tests and
    benchmarks (stands in for cached TCGA GigaPath features)."""

    def __init__(self, n_cases: int = 16, in_chans: int = 1536,
                 bag_range: Tuple[int, int] = (500, 2000),
                 packer: Optional[GenePacker] = None, n_genes: int = 60,
                 n_classes: int = 2, clinical_dim: int = 0,
                 n_sites: int = 1, threshold: int = 25000, seed: int = 0,
                 learnable: bool = False):
        """``learnable=True`` derives the labels from the inputs instead
        of sampling them: the subtype label is the sign of the first
        gene block's mean (and shifts the bag features by the label so
        both modalities carry it), and survival risk follows the second
        gene block — a stand-in for TCGA metric parity in environments
        without the real data (the closest available analogue of the
        reference's readout protocol, ``test_utils_modaltune.py:133-171``
        on real labels)."""
        from .pathways import synthetic_pathways
        rng = np.random.RandomState(seed)
        if packer is None:
            groups = synthetic_pathways(n_genes=n_genes)
            packer = GenePacker.build(groups,
                                      [f"g{i}" for i in range(n_genes)])
        self.packer = packer
        self.threshold = threshold
        self._examples = []
        for i in range(n_cases):
            l = rng.randint(*bag_range)
            gvec = rng.randn(n_genes).astype(np.float32)
            bag = rng.randn(l, in_chans).astype(np.float32)
            if learnable:
                k = max(4, n_genes // 4)
                label = int(gvec[:k].mean() > 0)
                bag = bag + 0.5 * label
                risk = float(gvec[k:2 * k].mean())
                duration = float(np.clip(60.0 * np.exp(-2.0 * risk)
                                         + rng.randn() * 2.0, 1.0, 240.0))
                event = int(rng.rand() < 0.8)
            else:
                label = rng.randint(n_classes)
                duration = float(rng.randint(1, 120))
                event = int(rng.rand() < 0.6)
            site = rng.randint(n_sites)
            self._examples.append(Example(
                bag=bag,
                coords=(rng.randint(0, 900, (l, 2)) * 256.0
                        ).astype(np.float32),
                genes=packer.pack(gvec),
                text=rng.randn(4, 512).astype(np.float32),
                clinical=(rng.randn(clinical_dim).astype(np.float32)
                          if clinical_dim else None),
                label=label,
                duration=duration,
                event=event,
                case_id=f"case_{i:04d}",
                site=site))
        self.case_ids = [e.case_id for e in self._examples]

    def __len__(self):
        return len(self._examples)

    def metadata(self):
        return [dict(case_id=e.case_id, primary_class=e.label,
                     durations=e.duration, vital_status=e.event,
                     project_id=str(e.site)) for e in self._examples]

    def get(self, index: int, rng: np.random.RandomState) -> Example:
        ex = self._examples[index]
        if ex.bag.shape[0] > self.threshold:
            idx = np.sort(rng.permutation(ex.bag.shape[0])[:self.threshold])
            ex = dataclasses.replace(ex, bag=ex.bag[idx],
                                     coords=ex.coords[idx])
        return ex


def device_put(a: Optional[np.ndarray], device=None):
    """Host array -> ``torch`` tensor on ``device`` (``None``: the current
    CUDA device, an error where there is none; the tests pass ``"cpu"``),
    copied asynchronously from pinned memory onto a card. ``None`` stays
    ``None``."""
    import torch
    if a is None:
        return None
    device = torch.device("cuda" if device is None else device)
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class BucketedLoader:
    """Iterates a dataset as bucket-padded batches built on a background
    thread (replaces the torch DataLoader worker pool at
    ``utils/base_trainer.py:274-295``).

    With ``device_prefetch=True`` the worker additionally issues an
    async copy to the card of the large arrays (bag/coords/mask/genes,
    clinical; see :func:`device_put`) so the H2D transfer overlaps the
    previous step's compute;
    otherwise batches are host numpy and transfer happens when the
    consumer converts them."""

    def __init__(self, dataset, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 batch_size: int = 1, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, device_prefetch: bool = False,
                 process_shard=None, pad_to_batch: bool = False):
        self.dataset = dataset
        self.buckets = tuple(sorted(buckets))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.device_prefetch = device_prefetch
        # (process_id, num_processes): iterate only this process's
        # case-modulo shard while dataset.metadata() stays global — the
        # DistributedSampler equivalent (base_trainer.py:283-307)
        self.process_shard = process_shard
        # pad partial batches to batch_size by wrapping around the epoch
        # order (DistributedSampler-style) so mesh-sharded steps always
        # see divisible shapes; Batch.pad_rows marks the synthetic rows
        self.pad_to_batch = pad_to_batch
        self.epoch = 0

    def _to_device(self, batch: Batch) -> Batch:
        return dataclasses.replace(
            batch, bag=device_put(batch.bag), coords=device_put(batch.coords),
            mask=device_put(batch.mask), genes=device_put(batch.genes),
            clinical=device_put(batch.clinical))

    def _indices(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.process_shard is not None:
            pid, n = self.process_shard
            order = order[pid::n]
        return order

    def __len__(self):
        # lower bound under bucket-grouped batching (exact at
        # batch_size=1): per-bucket remainders can add up to
        # n_buckets - 1 extra partial batches, unknowable without
        # loading every bag's length
        n = len(self._indices())
        return (n + self.batch_size - 1) // self.batch_size

    def _iter_batches(self) -> Iterator[Batch]:
        """Bucket-grouped batching: a batch is formed from examples that
        map to the SAME bucket, never padded to its largest member's
        bucket — at batch_size > 1 mixing a 2k bag into a 25k-bucket
        batch would waste 12x its FLOPs on padding. Examples stream in
        (shuffled) order into per-bucket pending lists; a full list
        emits a batch, partial lists flush at epoch end (wrap-padded to
        batch_size in pad_to_batch mode). batch_size=1 reduces exactly
        to per-example batches in iteration order."""
        rng = np.random.RandomState(self.seed + self.epoch)
        order = self._indices()
        if self.shuffle:
            rng.shuffle(order)
        pending: Dict[int, List[Example]] = {b: [] for b in self.buckets}
        for i in order:
            ex = self.dataset.get(int(i), rng)
            b = choose_bucket(ex.bag.shape[0], self.buckets)
            if len(pending[b]) + 1 == self.batch_size:
                yield collate(pending[b] + [ex], b)
                pending[b] = []
            else:
                pending[b].append(ex)
        for b in self.buckets:
            exs = pending[b]
            if not exs:
                continue
            pad = 0
            if self.pad_to_batch and len(exs) < self.batch_size:
                pad = self.batch_size - len(exs)
                exs = exs + [exs[i % len(exs)] for i in range(pad)]
            batch = collate(exs, b)
            if pad:
                batch = dataclasses.replace(batch, pad_rows=pad)
            yield batch

    def __iter__(self) -> Iterator[Batch]:
        """Batches in order, built ``prefetch`` ahead on a worker thread.
        A consumer that stops early (``break``, ``close()``, an exception)
        stops the worker too: the generator's ``finally`` sets ``stop``,
        the worker's timed puts see it, and the queued batches are
        dropped. An error in the worker is raised here."""
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        failed: List[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=PUT_WAIT_S)
                    return True
                except queue_mod.Full:
                    pass
            return False

        def worker():
            try:
                for b in self._iter_batches():
                    if stop.is_set():
                        break
                    if self.device_prefetch:
                        b = self._to_device(b)
                    if not put(b):
                        break
            except BaseException as e:  # handed to the consumer
                failed.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
            if failed:
                raise failed[0]
        finally:
            stop.set()
            t.join(timeout=JOIN_WAIT_S)
            while True:
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    break


class TitanGridDataset:
    """Wrapper applying TITAN's grid scatter to each example: the bag of
    patch features becomes a list of grid-cell tokens with grid
    coordinates and a foreground mask (``preprocess_features``,
    titan_adapter.py:295-327 — done host-side here so device shapes stay
    static)."""

    def __init__(self, dataset, patch_size_lv0: int = 1024):
        self.dataset = dataset
        self.patch_size_lv0 = patch_size_lv0
        self.packer = getattr(dataset, "packer", None)
        self.case_ids = dataset.case_ids

    def __len__(self):
        return len(self.dataset)

    def metadata(self):
        return self.dataset.metadata()

    def get(self, index: int, rng) -> Example:
        from ..models.titan import grid_scatter_bag
        ex = self.dataset.get(index, rng)
        tokens, gcoords, valid = grid_scatter_bag(
            ex.bag, ex.coords, self.patch_size_lv0)
        # keep only foreground cells (they are ordered first); bucketing
        # pads back to static shapes downstream
        n_fg = int(valid.sum())
        return dataclasses.replace(ex, bag=tokens[:n_fg],
                                   coords=gcoords[:n_fg])


class SubsetDataset:
    """View over a case-wise dataset restricted to a subset of cases —
    used by the k-fold harness (``base_trainer.py:242-272,545-571``)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)
        self.packer = getattr(dataset, "packer", None)
        self.case_ids = [dataset.case_ids[i] for i in self.indices]

    def __len__(self):
        return len(self.indices)

    def metadata(self):
        meta = self.dataset.metadata()
        return [meta[i] for i in self.indices]

    def get(self, index: int, rng):
        return self.dataset.get(self.indices[index], rng)


def kfold_splits(dataset, n_folds: int, seed: int = 0):
    """Case-level k-fold partition -> list of (train_subset, val_subset),
    stratified-free round-robin like the reference's KFold over cases."""
    n = len(dataset)
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    folds = [order[i::n_folds] for i in range(n_folds)]
    out = []
    for k in range(n_folds):
        val_idx = folds[k]
        train_idx = np.concatenate([folds[j] for j in range(n_folds)
                                    if j != k])
        out.append((SubsetDataset(dataset, train_idx.tolist()),
                    SubsetDataset(dataset, val_idx.tolist())))
    return out


def load_split_json(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def load_gene_csv(path: str):
    """Gene CSV (first column case_id) -> (matrix, case_ids, gene_names),
    StandardScaler-normalized over all rows like ``datasets.py:185-188``.
    An empty cell reads as NaN, as pandas reads it."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [row for row in reader if row]
    case_ids = [row[0] for row in rows]
    genes = header[1:]
    x = np.array([[float(v) if v.strip() else np.nan for v in row[1:]]
                  for row in rows], np.float64).reshape(len(rows), len(genes))
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std[std == 0] = 1.0
    return ((x - mean) / std).astype(np.float32), case_ids, genes
