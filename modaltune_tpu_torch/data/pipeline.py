"""Offline data pipeline: TCGA splits, clinical features, text prompts.

Counterpart of ``modaltune_tpu/data/pipeline.py``, rebuilt on ``csv``,
``json`` and numpy (the card's machine has neither pandas nor sklearn). A
table is a *frame*: a ``{column: list}`` dict in column order, one value
per row (``str``, ``int``, ``float``; a missing value is ``nan``), as
:func:`read_table` reads it; :func:`frame_records` turns it into rows.

* :func:`load_labelset`: ``clinical.tsv`` + ``slide.tsv`` (GDC's
  columns) -> slide-level frame with durations in months, the death-date
  censoring fixes, the event flag and the subtype classes.
* :func:`make_splits`: patient-level stratified 80/20 then 85/15 splits
  (:func:`train_test_split`, sklearn's ``StratifiedShuffleSplit`` draw),
  gene-availability gating of val/test, the split JSONs.
* :func:`prepare_clinical_features`: AJCC stage/T/N/M scrubbed and
  label-encoded, plus min-max normalised age -> ``{case_id: float32[5]}``.
* :func:`generate_prompts` / :func:`make_text_embeddings`: four prompts
  per case and a pluggable text encoder (``texts -> (N, dim)``).
* :func:`process_gene_matrix`: a Xena-style genes x samples frame -> the
  case x pathway-gene CSV.

The functions that need no table library (the class maps, ``_scrub``, the
prompt tables and functions) are the JAX package's code as it is; the rest
computes what the JAX package's pandas and sklearn calls compute, and
writes files that parse to the same objects.
"""

from __future__ import annotations

import csv
import json
import math
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

Frame = Dict[str, list]

# ---------------------------------------------------------------------------
# frames: read_csv's inference, rows, duplicates
# ---------------------------------------------------------------------------

# pandas' default missing-value strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"[+-]?\d+$")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def isna(value) -> bool:
    return value is None or (isinstance(value, float) and value != value)


def _infer_column(cells: Sequence[str]) -> list:
    """One column's cells as ``pd.read_csv`` types them: all ints and none
    missing -> ``int``; all numbers (or all missing) -> ``float`` with
    ``nan``; else ``str`` with ``nan`` for a missing cell."""
    na = [c in NA_STRINGS for c in cells]
    given = [c for c, m in zip(cells, na) if not m]
    if given and not any(na) and all(_INT.match(c) for c in given):
        return [int(c) for c in cells]
    if all(_INT.match(c) or _FLOAT.match(c) for c in given):
        return [math.nan if m else float(c) for c, m in zip(cells, na)]
    return [math.nan if m else c for c, m in zip(cells, na)]


def read_table(path: str, sep: str = "\t",
               infer: Sequence[str] = ()) -> Frame:
    """A delimited text file -> frame. The columns named in ``infer`` are
    typed as ``pd.read_csv`` types them (:func:`_infer_column`); every
    other column keeps its cells as strings. Blank lines are skipped."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader)
        rows = [r for r in reader if r]
    frame = {}
    for j, name in enumerate(header):
        cells = [r[j] if j < len(r) else "" for r in rows]
        frame[name] = _infer_column(cells) if name in infer else cells
    return frame


def n_rows(frame: Frame) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def take(frame: Frame, index: Sequence[int]) -> Frame:
    """The rows ``index`` of ``frame``, in that order."""
    return {c: [v[i] for i in index] for c, v in frame.items()}


def frame_records(frame: Frame) -> List[dict]:
    """``DataFrame.to_dict("records")``: one dict per row."""
    cols = list(frame)
    return [{c: frame[c][i] for c in cols} for i in range(n_rows(frame))]


def _key(value):
    """A hashable stand-in under which missing values are equal."""
    return ("<nan>",) if isna(value) else value


def drop_duplicates(frame: Frame, subset: Optional[Sequence[str]] = None
                    ) -> Frame:
    """The first row of each distinct ``subset`` (every column unless
    given), missing values equal to each other."""
    cols = list(subset or frame)
    seen, keep = set(), []
    for i in range(n_rows(frame)):
        k = tuple(_key(frame[c][i]) for c in cols)
        if k not in seen:
            seen.add(k)
            keep.append(i)
    return take(frame, keep)


# ---------------------------------------------------------------------------
# subtype class maps (make_dataset.py:15-178)
# ---------------------------------------------------------------------------

# per-site: (diagnosis renames, diagnosis -> class id)
SUBTYPE_MAPS = {
    "brca": ({}, {"Infiltrating duct carcinoma": 0, "Lobular carcinoma": 1}),
    "gbmlgg": ({}, {
        "Glioblastoma": 0, "Mixed glioma": 1, "Oligodendroglioma": 1,
        "Astrocytoma": 1, "Oligodendroglioma, anaplastic": 1,
        "Astrocytoma, anaplastic": 1}),
    "nsclc": ({
        "Adenocarcinoma with mixed subtypes": "Adenocarcinoma",
        "Squamous cell carcinoma, keratinizing": "Squamous cell carcinoma",
        "Squamous cell carcinoma, large cell, nonkeratinizing":
            "Squamous cell carcinoma",
        "Bronchiolo-alveolar carcinoma, non-mucinous":
            "Bronchiolo-alveolar carcinoma",
        "Bronchio-alveolar carcinoma, mucinous":
            "Bronchiolo-alveolar carcinoma",
        "Bronchio-alveolar carcinoma": "Bronchiolo-alveolar carcinoma"},
        {"Adenocarcinoma": 0, "Squamous cell carcinoma": 1}),
    "coadread": ({
        "Colon Adenocarcinoma with mixed subtypes": "Colon Adenocarcinoma",
        "Rectal Adenocarcinoma with mixed subtypes":
            "Rectal Adenocarcinoma"},
        {"Colon Adenocarcinoma": 0, "Rectal Adenocarcinoma": 1}),
    "rcc": ({
        "Papillary adenocarcinoma": "Papillary renal cell carcinoma",
        "Clear cell adenocarcinoma": "Renal clear cell carcinoma",
        "Renal cell carcinoma": "Renal clear cell carcinoma",
        "Renal cell carcinoma, chromophobe type":
            "Chromophobe renal cell carcinoma"},
        {"Papillary renal cell carcinoma": 0,
         "Renal clear cell carcinoma": 1,
         "Chromophobe renal cell carcinoma": 2}),
    "ucec": ({
        "Endometrioid adenocarcinoma, secretory variant":
            "Endometrioid adenocarcinoma",
        "Papillary serous cystadenocarcinoma": "Serous cystadenocarcinoma",
        "Adenocarcinoma": "Endometrioid adenocarcinoma",
        "Serous surface papillary carcinoma": "Serous cystadenocarcinoma"},
        {"Endometrioid adenocarcinoma": 0, "Serous cystadenocarcinoma": 1}),
    "blca": ({
        "Papillary adenocarcinoma": "Papillary transitional cell carcinoma"},
        {"Transitional cell carcinoma": 0,
         "Papillary transitional cell carcinoma": 1}),
}



def apply_subtype_classes(df: Frame, onco_code: str) -> Frame:
    """Strip ', NOS', apply per-site diagnosis renames and class ids;
    unmapped diagnoses keep class -1. For nsclc/coadread the diagnosis
    text gets the organ prefix like the reference. Returns a new frame
    with ``primary_class`` added."""
    df = dict(df)
    diag = [x if isna(x) else str(x).replace(", NOS", "")
            for x in df["primary_diagnosis"]]
    if onco_code == "coadread":
        prefixes = {"TCGA-COAD": "Colon ", "TCGA-READ": "Rectal "}
        diag = [prefixes[p] + d if p in prefixes and not isna(d) else d
                for d, p in zip(diag, df["project_id"])]
    renames, classes = SUBTYPE_MAPS.get(onco_code, ({}, {}))
    diag = [renames.get(d, d) if isinstance(d, str) else d for d in diag]
    df["primary_class"] = [classes.get(d, -1) if isinstance(d, str) else -1
                           for d in diag]
    if onco_code == "nsclc":
        diag = [d if isna(d) else "Lung " + d for d in diag]
    df["primary_diagnosis"] = [d if isna(d) else d.lower() for d in diag]
    return df


# ---------------------------------------------------------------------------
# clinical table -> case table with durations (make_dataset.py:180-278)
# ---------------------------------------------------------------------------

CLINICAL_COLUMNS = [
    "case_id", "age_at_index", "project_id", "days_to_death",
    "vital_status", "days_to_last_follow_up", "ajcc_pathologic_m",
    "ajcc_pathologic_n", "ajcc_pathologic_stage", "ajcc_pathologic_t",
    "primary_diagnosis", "year_of_diagnosis", "slide_submitter_id",
    "case_submitter_id",
]



def _to_number(value) -> float:
    """``pd.to_numeric(errors="coerce")`` of one value, as a float."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str) and (_INT.match(value) or _FLOAT.match(value)):
        return float(value)
    return math.nan


def load_labelset(onco_code: str, clinical_tsv: str, slide_tsv: str,
                  available_slide_ids: Optional[Sequence[str]] = None,
                  labelset: Sequence[str] = ("primary_diagnosis",)
                  ) -> Frame:
    """clinical.tsv + slide.tsv -> slide-level frame with durations
    in months (days/30.44), death-date censoring fixes, event flag, and
    subtype classes. Each clinical row is joined with every slide of its
    case, in the slide table's order (``nan`` where it has none)."""
    clin = read_table(clinical_tsv, infer=CLINICAL_COLUMNS)
    slides = read_table(slide_tsv, infer=CLINICAL_COLUMNS)
    by_case: Dict = {}
    for cid, sid in zip(slides["case_id"], slides["slide_submitter_id"]):
        by_case.setdefault(_key(cid), []).append(sid)
    index, sids = [], []
    for i, cid in enumerate(clin["case_id"]):
        for sid in by_case.get(_key(cid), [math.nan]):
            index.append(i)
            sids.append(sid)
    df = take(clin, index)
    df["slide_submitter_id"] = sids
    df = {c: [math.nan if v == "'--" else v for v in vals]
          for c, vals in df.items()}
    if available_slide_ids is not None:
        available = set(available_slide_ids)
        df = take(df, [i for i, s in enumerate(df["slide_submitter_id"])
                       if not isna(s) and s in available])
    df = drop_duplicates({c: df[c] for c in CLINICAL_COLUMNS if c in df})

    # durations: follow-up for alive, death date for dead; fall back to
    # follow-up when the death date is missing; negative -> abs; months
    follow = df.pop("days_to_last_follow_up")
    death = df.pop("days_to_death")
    durations = []
    for f, d, v in zip(follow, death, df["vital_status"]):
        x = d if v == "Dead" else f
        durations.append(abs(_to_number(f if isna(x) else x)) / 30.44)
    df["vital_status"] = [int(v == "Dead") for v in df["vital_status"]]
    # the column order of the JAX package's frame: durations last
    df["durations"] = durations
    labels = [c for c in labelset if c in df]
    df = take(df, [i for i in range(n_rows(df))
                   if not any(isna(df[c][i]) for c in labels)])
    return apply_subtype_classes(df, onco_code)


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``: draws per class
    closest to ``n_draws`` in proportion, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def train_test_split(items: Sequence, test_size: float, seed: int,
                     stratify: Sequence) -> tuple:
    """``sklearn.model_selection.train_test_split(items, test_size=...,
    random_state=seed, stratify=stratify)`` -> ``(train, test)`` lists:
    ``StratifiedShuffleSplit``'s one draw, bit for bit (sizes
    ``ceil(test_size * n)`` and the rest; per class the approximate mode
    of each side, ties and members drawn from one
    ``RandomState(seed)``; both sides permuted). Raises ``ValueError``
    where sklearn does: a class of one member, a side with fewer members
    than there are classes, an empty train side."""
    n = len(items)
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be in (0, 1)")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and "
                         f"train_size=None, the resulting train set will "
                         f"be empty.")
    classes, y_indices, class_counts = np.unique(
        np.asarray(stratify), return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is "
            "too few. The minimum number of groups for any class cannot be "
            f"less than 2. Classes with too few members are: "
            f"{classes[class_counts < 2].tolist()}")
    for side, size in (("train", n_train), ("test", n_test)):
        if size < len(classes):
            raise ValueError(f"The {side}_size = {size} should be greater "
                             f"or equal to the number of classes = "
                             f"{len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        members = class_indices[i].take(rng.permutation(class_counts[i]),
                                        mode="clip")
        train.extend(members[:n_i[i]])
        test.extend(members[n_i[i]:n_i[i] + t_i[i]])
    return ([items[i] for i in rng.permutation(train)],
            [items[i] for i in rng.permutation(test)])


def make_splits(df: Frame, features_dir: str, gene_case_ids: Sequence[str],
                output_dir: str, onco_code: str, seed: int = 0,
                features_suffix: str = "_featvec.npz") -> Dict[str, list]:
    """Patient-level stratified split (80/20 then 85/15); cases without
    genomic data or with class -1 go to train only
    (make_dataset.py:313-351). Writes the three split JSONs and returns
    their rows."""
    df = dict(df)
    with_genes = set(gene_case_ids)
    df["gene_availability"] = [int(c in with_genes)
                               for c in df["case_submitter_id"]]
    df["features_path"] = [str(Path(features_dir) / f"{sid}{features_suffix}")
                           for sid in df["slide_submitter_id"]]

    cases = frame_records(drop_duplicates(
        df, ("case_id", "primary_class", "gene_availability")))
    relevant = [c for c in cases
                if c["gene_availability"] == 1 and c["primary_class"] >= 0]
    irrelevant = [c["case_id"] for c in cases
                  if c["gene_availability"] == 0 or c["primary_class"] < 0]
    train_ids, test_ids = train_test_split(
        [c["case_id"] for c in relevant], 0.2, seed,
        [c["primary_class"] for c in relevant])
    first = set(train_ids)
    tr = [c for c in relevant if c["case_id"] in first]
    train_ids, val_ids = train_test_split(
        [c["case_id"] for c in tr], 0.15, seed,
        [c["primary_class"] for c in tr])
    train_ids = train_ids + irrelevant

    out = {}
    outdir = Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    rows = frame_records(df)
    for name, ids in (("train", train_ids), ("val", val_ids),
                      ("test", test_ids)):
        ids = set(ids)
        out[name] = [r for r in rows if r["case_id"] in ids]
        with open(outdir / f"{name}_{onco_code}_cls_feat.json", "w") as f:
            json.dump({"data": out[name]}, f, default=str)
    return out


# ---------------------------------------------------------------------------
# clinical feature vectors (make_clinical.py:14-116)
# ---------------------------------------------------------------------------

def _scrub(value: str, is_t: bool = False) -> str:
    v = str(value).replace(" (i+)", "").replace(" (i-)", "")
    if is_t:
        v = v.replace("is", "0")
    for ch in ("A", "a", "B", "b", "C", "c", "D", "d", "m", "i"):
        if ch == "a" and not is_t:
            continue
        v = v.replace(ch, "")
    return v



def _label_encode(values: Sequence[str]) -> np.ndarray:
    """sklearn's ``LabelEncoder().fit_transform``: each string's index
    among the sorted distinct strings."""
    index = {v: i for i, v in enumerate(sorted(set(values)))}
    return np.asarray([index[v] for v in values], np.int64)


def prepare_clinical_features(df: Frame, output_npz: Optional[str] = None
                              ) -> Dict[str, np.ndarray]:
    """AJCC stage/T/N/M scrubbed to coarse grades then label-encoded,
    plus min-max-normalized age -> {case_id: float32[5]}, one per case
    (its first row). A missing value encodes as its own category
    ``"nan"``; a missing age as 0.5."""
    df = drop_duplicates(df, ("case_id",))
    feats = []
    for col, is_t in (("ajcc_pathologic_stage", False),
                      ("ajcc_pathologic_t", True),
                      ("ajcc_pathologic_n", False),
                      ("ajcc_pathologic_m", False)):
        vals = [_scrub(x, is_t) if x == x else "nan" for x in df[col]]
        feats.append(_label_encode(vals).astype(np.float32))
    age = np.asarray([float(x) for x in df["age_at_index"]], np.float64)
    with np.errstate(invalid="ignore"):
        lo = np.nan if np.isnan(age).all() else np.nanmin(age)
        hi = np.nan if np.isnan(age).all() else np.nanmax(age)
    age = (age - lo) / max(hi - lo, 1e-9)
    feats.append(np.nan_to_num(age.astype(np.float32), nan=0.5))
    mat = np.stack(feats, axis=1)
    out = {cid: mat[i] for i, cid in enumerate(df["case_id"])}
    if output_npz:
        np.savez(output_npz, **out)
    return out


# ---------------------------------------------------------------------------
# text prompts + embeddings (make_textemb_conch.py:25-303)
# ---------------------------------------------------------------------------

CANCER_CODE = {
    "BRCA": "breast", "BLCA": "bladder urothelial",
    "COADREAD": "colorectal", "GBMLGG": "brain", "NSCLC": "lung",
    "RCC": "kidney", "STAD": "stomach", "UCEC": "uterus",
}
STAGE_WORDS = {"Stage I": "stage one", "Stage II": "stage two",
               "Stage III": "stage three", "Stage IV": "stage four",
               "Stage X": "stage cannot be determined"}
T_WORDS = {"T0": "no tumor detected", "T1": "tumor stage one",
           "T2": "tumor stage two", "T3": "tumor stage three",
           "T4": "tumor stage four",
           "TX": "tumor stage cannot be assessed"}
N_WORDS = {"N0": "cancer has not spread to lymph nodes",
           "N1": "node stage one", "N2": "node stage two",
           "N3": "node stage three",
           "NX": "node spread cannot be assessed"}
M_WORDS = {"M0": "no metastasis detected",
           "M1": "cancer has spread to distant organs",
           "MX": "metastasis status cannot be assessed"}


def survival_bins(durations: np.ndarray, n_bins: int = 4) -> np.ndarray:
    """Quantile bin edges over case durations (get_intervals)."""
    d = np.asarray(durations, float)
    d = d[np.isfinite(d)]
    edges = np.quantile(d, np.linspace(0, 1, n_bins + 1))
    edges[0] = d.min() - 1e-6
    edges[-1] = d.max() + 1e-6
    return edges


def survival_sentences(edges: np.ndarray) -> Dict[int, str]:
    q = np.round(edges).astype(int)
    out = {0: f"before {q[1]} months",
           len(q) - 1: f"after {q[len(q) - 1]} months"}
    for i in range(1, len(q) - 1):
        out[i] = f"between {q[i]} and {q[i + 1]} months"
    return out


def generate_prompts(rows: Sequence[dict], onco_code: str,
                     edges: Optional[np.ndarray] = None
                     ) -> Dict[str, List[str]]:
    """Four prompt strings per case: general / diagnosis / stage /
    survival (generate_prompts, make_textemb_conch.py:191-244)."""
    onco = CANCER_CODE[onco_code.upper()]
    if edges is None:
        edges = survival_bins([r.get("durations", np.nan) for r in rows])
    sent_label = survival_sentences(edges)
    event_words = {0: "was censored", 1: "died"}

    def word(mapper, value, scrub_t=False):
        if value != value or value is None:
            return None
        v = _scrub(value, scrub_t)
        return mapper.get(v, str(v))

    general, diagnosis, stage, survival = [], [], [], []
    for r in rows:
        onco_s = f"Cancer location: {onco};"
        diag = r.get("primary_diagnosis")
        diag_s = f"Cancer diagnosis: {diag};" if diag == diag and diag \
            else ""
        st = word(STAGE_WORDS, r.get("ajcc_pathologic_stage"))
        st_s = f"Overall stage: {st};" if st else ""
        m = word(M_WORDS, r.get("ajcc_pathologic_m"))
        m_s = f"Distant metastasis status: {m};" if m else ""
        nn = word(N_WORDS, r.get("ajcc_pathologic_n"))
        n_s = f"Lymph node status: {nn};" if nn else ""
        tt = word(T_WORDS, r.get("ajcc_pathologic_t"), scrub_t=True)
        t_s = f"Tumor stage status: {tt};" if tt else ""
        dur = r.get("durations", np.nan)
        if dur == dur and dur is not None:
            b = int(np.clip(np.searchsorted(edges[1:-1], dur), 0,
                            len(sent_label) - 1))
            ev = event_words[int(r.get("vital_status", 0))]
            surv_s = (f"Survival status: The patient {ev} "
                      f"{sent_label[b]}")
        else:
            surv_s = ""
        general.append(f"{onco_s} {diag_s} {st_s} {t_s} {n_s} {m_s} "
                       f"{surv_s}")
        diagnosis.append(f"{onco_s} {diag_s}")
        stage.append(f"{onco_s} {st_s} {t_s} {n_s} {m_s}")
        survival.append(f"{onco_s} {st_s} {t_s} {n_s} {m_s} {surv_s}")
    return {"general": general, "diagnosis": diagnosis, "stage": stage,
            "survival": survival}


def make_text_embeddings(rows: Sequence[dict], onco_code: str,
                         encode_text: Callable[[List[str]], np.ndarray],
                         output_npz: Optional[str] = None
                         ) -> Dict[str, np.ndarray]:
    """-> {case_id: (4, text_dim)} using a pluggable text encoder (the
    reference uses CONCH ``encode_text``; any callable texts->array
    works — e.g. a transformers CLIP text tower)."""
    prompts = generate_prompts(rows, onco_code)
    embs = [np.asarray(encode_text(prompts[k]), np.float32)
            for k in ("general", "diagnosis", "stage", "survival")]
    stacked = np.stack(embs, axis=1)  # (N, 4, dim)
    out = {r["case_id"]: stacked[i] for i, r in enumerate(rows)}
    if output_npz:
        np.savez(output_npz, **out)
    return out



# ---------------------------------------------------------------------------
# gene matrix (make_gene_dataset.py)
# ---------------------------------------------------------------------------

def _row_std(x: np.ndarray) -> np.ndarray:
    """``DataFrame.std(axis=1)`` (ddof 1, missing values skipped, ``nan``
    below two values) in pandas' own arithmetic: the mean from the sum,
    then the squared deviations summed."""
    mask = np.isnan(x)
    count = (~mask).sum(axis=1)
    vals = np.where(mask, 0.0, x)
    avg = vals.sum(axis=1, dtype=np.float64) / np.maximum(count, 1)
    sqr = (avg[:, None] - vals) ** 2
    np.putmask(sqr, mask, 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        var = sqr.sum(axis=1, dtype=np.float64) / (count - 1)
    var[count - 1 <= 0] = np.nan
    return np.sqrt(var)


def _csv_cell(value) -> str:
    if isna(value):
        return ""
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return str(value)


def process_gene_matrix(expr: Frame, pathway_genes: Sequence[str],
                        translate: Optional[Callable[[Sequence[str]],
                                                     Dict[str, str]]] = None,
                        output_csv: Optional[str] = None) -> Frame:
    """Xena-style RNA-seq frame (genes x samples, the first column the
    gene id, numeric cells) -> case x pathway-gene frame: drop the genes
    whose sample std is not above 0, optional symbol translation hook
    (the reference uses gene_thesaurus), transpose to cases, keep the
    pathway genes in their order, TCGA barcodes truncated to case level
    (the first sample of a case kept). Written as a CSV, ``case_id``
    first, when ``output_csv`` is given."""
    cols = list(expr)
    samples = cols[1:]
    # genes x samples in the column-major layout of pandas' blocks
    x = np.stack([np.asarray(expr[s], np.float64) for s in samples]).T \
        .reshape(len(expr[cols[0]]), len(samples))
    with np.errstate(invalid="ignore"):
        kept = np.flatnonzero(_row_std(x) > 0)
    genes = [expr[cols[0]][i] for i in kept]
    if translate is not None:
        mapping = translate(genes)
        genes = [mapping.get(g, g) for g in genes]
    row_of = {}
    for g, i in zip(genes, kept):
        row_of.setdefault(g, i)
    keep = [g for g in pathway_genes if g in row_of]
    out: Frame = {"case_id": []}
    for g in keep:
        out[g] = []
    seen = set()
    for s in samples:
        case = s[:12]            # TCGA-XX-XXXX case ids
        if case in seen:
            continue
        seen.add(case)
        out["case_id"].append(case)
        for g in keep:
            out[g].append(expr[s][row_of[g]])
    if output_csv:
        with open(output_csv, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(list(out))
            for row in zip(*out.values()):
                writer.writerow([_csv_cell(v) for v in row])
    return out
