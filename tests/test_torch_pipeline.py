"""The port's dataset preparation (``data/pipeline.py``, rebuilt on
``csv``, ``json`` and numpy) against the JAX package's (pandas and
sklearn), on the CPU.

Synthetic TCGA sites in GDC's columns (``chip_smoke.write_tcga_site``:
duplicate treatment rows, two-slide cases, ``'--`` for missing values, a
missing death date, a negative follow-up, an unmapped diagnosis that is a
class of one case, a case without gene data, one without a diagnosis and
one without a slide) go through both packages for seeds 0-3:

* ``load_labelset``: the rows, as JSON text, equal;
* ``make_splits``: the three split JSONs parse to equal objects (and are
  the same text), every split equal to sklearn's ``train_test_split``
  on the same ids; a mapped class with a single case raises the same
  ``ValueError`` in both;
* ``prepare_clinical_features``: the ``.npz`` arrays equal;
* ``generate_prompts`` and ``make_text_embeddings``: the prompts and the
  ``.npz`` equal;
* ``process_gene_matrix``: the gene CSVs read back equal (constant genes,
  a gene with missing values, a translation hook, two samples of a case);
* ``train_test_split`` against sklearn's over many class layouts and
  seeds, and ``read_table``'s types against ``pd.read_csv``'s.
"""

import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import train_test_split as sk_split

from modaltune_tpu.data import pipeline as J
from modaltune_tpu_torch.data import pipeline as P

REPO = Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 2, 3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def cs():
    return _chip_smoke()


@pytest.fixture(scope="module", params=SEEDS, ids=[f"seed{s}" for s in SEEDS])
def site(request, cs, tmp_path_factory):
    seed = request.param
    root = tmp_path_factory.mktemp(f"site{seed}")
    site = cs.write_tcga_site(root, seed)
    return dict(site, seed=seed, root=root,
                jax=J.load_labelset("brca", site["clinical"], site["slide"]),
                port=P.load_labelset("brca", site["clinical"],
                                     site["slide"]))


def test_labelset_matches_jax(site):
    want, got = site["jax"].to_dict("records"), P.frame_records(site["port"])
    assert list(site["jax"].columns) == list(site["port"])
    assert json.dumps(got, default=str) == json.dumps(want, default=str)
    assert {r["primary_class"] for r in got} == {-1, 0, 1}
    assert all(not r["durations"] < 0 for r in got)


def test_labelset_with_available_slides_matches_jax(site):
    keep = sorted(site["slides"])[::2]
    want = J.load_labelset("brca", site["clinical"], site["slide"],
                           available_slide_ids=keep)
    got = P.load_labelset("brca", site["clinical"], site["slide"],
                          available_slide_ids=keep)
    assert json.dumps(P.frame_records(got), default=str) == \
        json.dumps(want.to_dict("records"), default=str)


def test_splits_match_jax_and_sklearn(site):
    out = {}
    for name, mod, df in (("jax", J, site["jax"]), ("port", P, site["port"])):
        d = site["root"] / name
        out[name] = mod.make_splits(df, "/feats", site["gene_case_ids"],
                                    str(d), "brca", seed=site["seed"])
    texts = {}
    for split in ("train", "val", "test"):
        files = [(site["root"] / n / f"{split}_brca_cls_feat.json")
                 for n in ("jax", "port")]
        want, got = (json.loads(f.read_text()) for f in files)
        assert got == want, split
        texts[split] = files[1].read_text()
        assert texts[split] == files[0].read_text()
    # val and test hold gene-available cases of a mapped class only
    genes = set(site["gene_case_ids"])
    for split in ("val", "test"):
        assert all(r["case_submitter_id"] in genes and r["primary_class"] >= 0
                   for r in out["port"][split])
    # the splits are sklearn's draw on the same ids
    cases = P.drop_duplicates(site["port"], ("case_id",))
    rel = [(c, k) for c, k, s in zip(cases["case_id"],
                                     cases["primary_class"],
                                     cases["case_submitter_id"])
           if s in genes and k >= 0]
    ids, ys = [c for c, _ in rel], [k for _, k in rel]
    tr, te = sk_split(ids, test_size=0.2, random_state=site["seed"],
                      stratify=np.asarray(ys))
    assert set(te) == {r["case_id"] for r in out["port"]["test"]}
    ys_tr = [k for c, k in rel if c in set(tr)]
    tr2, va = sk_split([c for c in ids if c in set(tr)], test_size=0.15,
                       random_state=site["seed"], stratify=np.asarray(ys_tr))
    assert set(va) == {r["case_id"] for r in out["port"]["val"]}


def test_single_case_class_raises_in_both(cs, tmp_path):
    """Of class 1 only the case without a slide is left: a class of one
    member, which sklearn's stratified split refuses."""
    site = cs.write_tcga_site(tmp_path, 5, classes=(6, 0))
    errors = []
    for mod in (J, P):
        df = mod.load_labelset("brca", site["clinical"], site["slide"])
        with pytest.raises(ValueError) as err:
            mod.make_splits(df, "/feats", site["gene_case_ids"],
                            str(tmp_path / mod.__name__), "brca")
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "only 1 member" in errors[1]


def test_clinical_features_match_jax(site, tmp_path):
    J.prepare_clinical_features(site["jax"], str(tmp_path / "j.npz"))
    got = P.prepare_clinical_features(site["port"], str(tmp_path / "p.npz"))
    want = np.load(tmp_path / "j.npz")
    saved = np.load(tmp_path / "p.npz")
    assert list(want.files) == list(saved.files) == list(got)
    for k in want.files:
        assert saved[k].dtype == np.float32
        assert np.array_equal(saved[k], want[k]), k


def _encode_text(texts):
    """A deterministic stand-in text tower: a seeded vector per string."""
    return np.stack([np.random.RandomState(
        sum(map(ord, t)) % (2 ** 31)).randn(512) for t in texts])


def test_prompts_and_text_embeddings_match_jax(site, tmp_path):
    want_rows = site["jax"].drop_duplicates("case_id").to_dict("records")
    rows = P.frame_records(P.drop_duplicates(site["port"], ("case_id",)))
    assert json.dumps(rows, default=str) == json.dumps(want_rows, default=str)
    assert P.generate_prompts(rows, "brca") == \
        J.generate_prompts(want_rows, "brca")
    J.make_text_embeddings(want_rows, "brca", _encode_text,
                           str(tmp_path / "j.npz"))
    P.make_text_embeddings(rows, "brca", _encode_text,
                           str(tmp_path / "p.npz"))
    want, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert list(want.files) == list(got.files)
    for k in want.files:
        assert got[k].shape == (4, 512)
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("translate", [False, True], ids=["ids", "symbols"])
def test_gene_matrix_matches_jax(tmp_path, translate):
    rng = np.random.RandomState(3)
    genes = [f"G{i}" for i in range(30)]
    samples = [f"TCGA-AA-{i:04d}-01" for i in range(7)] + ["TCGA-AA-0002-11"]
    x = rng.randn(30, len(samples)) * 3
    x[4] = 0.0                     # constant genes
    x[9] = 5.0
    x[12, 2] = np.nan              # a missing value
    x[13] = np.nan
    x[13, 0] = 1.0                 # one value: no std
    expr = {"gene": genes, **{s: list(x[:, j]) for j, s in
                              enumerate(samples)}}
    pathway = ["G3", "G4", "G12", "ALIAS_G7", "G20", "G9", "Z1", "G13",
               "G1"]

    def hook(names):
        return {"G7": "ALIAS_G7", "G8": "ALIAS_G7"}
    tr = hook if translate else None
    J.process_gene_matrix(pd.DataFrame(expr), pathway, tr,
                          str(tmp_path / "j.csv"))
    got = P.process_gene_matrix(expr, pathway, tr, str(tmp_path / "p.csv"))
    want = pd.read_csv(tmp_path / "j.csv")
    back = pd.read_csv(tmp_path / "p.csv")
    pd.testing.assert_frame_equal(back, want)
    assert list(got) == list(want.columns)
    assert "G4" not in got and "G9" not in got and "G13" not in got
    assert got["case_id"] == [s[:12] for s in samples[:7]]


def test_subtype_classes_match_jax():
    cases = {
        "brca": ["Infiltrating duct carcinoma, NOS", "Lobular carcinoma",
                 "Medullary carcinoma"],
        "nsclc": ["Adenocarcinoma with mixed subtypes",
                  "Squamous cell carcinoma, keratinizing", "Mucinous x"],
        "coadread": ["Adenocarcinoma, NOS", "Adenocarcinoma with mixed "
                     "subtypes", "Mucinous adenocarcinoma"],
        "rcc": ["Clear cell adenocarcinoma, NOS", "Renal cell carcinoma, "
                "chromophobe type", "Papillary adenocarcinoma, NOS"],
    }
    projects = ["TCGA-COAD", "TCGA-READ", "TCGA-READ"]
    for code, diag in cases.items():
        frame = {"primary_diagnosis": diag, "project_id": projects}
        want = J.apply_subtype_classes(pd.DataFrame(frame), code)
        got = P.apply_subtype_classes(frame, code)
        assert got["primary_class"] == want["primary_class"].tolist(), code
        assert got["primary_diagnosis"] == \
            want["primary_diagnosis"].tolist(), code


@pytest.mark.parametrize("seed", range(12))
def test_train_test_split_equals_sklearn(seed):
    rng = np.random.RandomState(100 + seed)
    n_classes = 2 + seed % 3
    counts = rng.randint(2, 9, n_classes)
    y = np.repeat(np.arange(n_classes), counts)
    rng.shuffle(y)
    items = [f"c{i}" for i in range(len(y))]
    for test_size in (0.2, 0.15, 0.5):
        try:
            want = sk_split(items, test_size=test_size, random_state=seed,
                            stratify=y)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                P.train_test_split(items, test_size, seed, list(y))
            assert str(got.value) == str(err)
            continue
        got = P.train_test_split(items, test_size, seed, list(y))
        assert list(got[0]) == list(want[0])
        assert list(got[1]) == list(want[1])


def test_read_table_types_match_pandas(tmp_path):
    """read_csv's inference on the clinical columns: ints, ints with a
    missing value (float), decimals, an all-missing column, text with
    ``'--``, NA strings."""
    path = tmp_path / "t.tsv"
    cols = {"case_id": ["a", "b", "NA"], "age_at_index": ["40", "", "55"],
            "days_to_death": ["12", "-3", "7"],
            "days_to_last_follow_up": ["1.5", "2", "3e2"],
            "ajcc_pathologic_m": ["", "", ""],
            "ajcc_pathologic_n": ["N0", "'--", "null"],
            "year_of_diagnosis": ["2004", "'--", "2010"]}
    path.write_text("\t".join(cols) + "\n" + "\n".join(
        "\t".join(v[i] for v in cols.values()) for i in range(3)) + "\n")
    want = pd.read_csv(path, sep="\t", low_memory=False)
    got = P.read_table(str(path), infer=P.CLINICAL_COLUMNS)
    assert list(got) == list(want.columns)
    for c in cols:
        w = want[c].tolist()
        assert [type(v) for v in got[c]] == [type(v) for v in w], c
        assert json.dumps(got[c]) == json.dumps(w), c


def test_table_free_code_equals_jax():
    """The functions that need no table library are the JAX package's code
    as it is."""
    for name in ("_scrub", "survival_bins", "survival_sentences",
                 "generate_prompts", "make_text_embeddings"):
        assert inspect.getsource(getattr(P, name)) == \
            inspect.getsource(getattr(J, name)), name
    for name in ("SUBTYPE_MAPS", "CLINICAL_COLUMNS", "CANCER_CODE",
                 "STAGE_WORDS", "T_WORDS", "N_WORDS", "M_WORDS"):
        assert getattr(P, name) == getattr(J, name), name
