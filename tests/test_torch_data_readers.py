"""The port's file readers against the JAX package's, on the CPU.

The reference's drop-in formats (written by ``tests/test_dropin_e2e.py``'s
own writer: per-slide ``.pt`` feature dicts, split JSONs ``{"data":
rows}`` with a two-slide case, ``.pt`` text and clinical dicts, the gene
CSV and the pathway CSV), plus an ``.npz`` bag and an ``.mtbc`` container,
read by both packages: every array equal, for a seed.

* ``load_gene_csv`` and ``pathway_gene_groups`` read CSV with the ``csv``
  module in the port and with pandas in the JAX package;
* ``FeatureBagDataset.get`` with a threshold below the two-slide case's
  bag: the sorted subsample, the +1,500 y-offset between slides, the gene
  pack, text and clinical rows;
* the native ``.mtbc`` reader against the numpy one.
"""

import json

import numpy as np
import pytest
import torch

import modaltune_tpu.data as j_data
import modaltune_tpu_torch.data as p_data
from modaltune_tpu.data import bagcache as j_bagcache
from modaltune_tpu_torch.data import bagcache as p_bagcache
from modaltune_tpu_torch.data import datasets as p_datasets
from test_dropin_e2e import _write_reference_artifacts

THRESHOLD = 60      # below the two-slide case's 60-90 patches


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    splits = _write_reference_artifacts(root / "db",
                                        np.random.RandomState(0))
    rng = np.random.RandomState(1)
    bags = [(rng.randn(n, 64).astype(np.float32),
             (rng.randint(0, 50, (n, 2)) * 256).astype(np.float32))
            for n in (37, 120, 5)]
    np.savez(root / "bag.npz", features=bags[0][0], coords=bags[0][1])
    p_bagcache.write_bagcache(str(root / "bags.mtbc"), bags)
    return dict(root=root, db=root / "db", splits=splits, bags=bags)


def test_split_json_and_tables_equal_jax(files):
    db = files["db"]
    for path in files["splits"].values():
        assert p_data.load_split_json(path) == j_data.load_split_json(path)
    for name in ("BRCA_textembeddings_conch.pt",
                 "simple_clinical_dict_brca.pt"):
        want = j_data.load_embedding_dict(str(db / name))
        got = p_data.load_embedding_dict(str(db / name))
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_gene_and_pathway_csv_without_pandas_equal_jax(files):
    db = files["db"]
    gene_csv = str(db / "tcga_brca_xena_clean_pathway.csv")
    (wm, wc, wg), (gm, gc, gg) = (j_data.load_gene_csv(gene_csv),
                                  p_data.load_gene_csv(gene_csv))
    assert gc == wc and gg == wg
    assert gm.dtype == wm.dtype == np.float32
    np.testing.assert_array_equal(gm, wm)
    pathway_csv = str(db / "gene_pathway_processed.csv")
    want = j_data.pathway_gene_groups(pathway_csv)
    got = p_data.pathway_gene_groups(pathway_csv)
    assert got == want and len(got) == 6
    wp, gp = (j_data.GenePacker.build(want, wg),
              p_data.GenePacker.build(got, gg))
    np.testing.assert_array_equal(gp.indices, wp.indices)
    np.testing.assert_array_equal(gp.mask, wp.mask)


def test_csv_cells_read_as_pandas_reads_them(tmp_path):
    """Membership written as 1.0, blank cells, quoted names; an empty gene
    cell reads as NaN in both."""
    path = tmp_path / "pathways.csv"
    path.write_text('gene,A,B\n"G,1",1.0,0\nG2,,1\nG3,1,1\n')
    assert p_data.pathway_gene_groups(str(path)) == \
        j_data.pathway_gene_groups(str(path))
    path = tmp_path / "genes.csv"
    path.write_text("case_id,G1,G2\nc1,1.5,\nc2,0.25,2\nc3,-1,4\n")
    (wm, wc, _), (gm, gc, _) = (j_data.load_gene_csv(str(path)),
                                p_data.load_gene_csv(str(path)))
    assert gc == wc
    np.testing.assert_array_equal(gm, wm)
    assert np.isnan(gm[:, 1]).all()


def test_feature_bags_equal_jax(files):
    root = files["root"]
    rows = json.load(open(files["splits"]["train"]))["data"]
    paths = [row["features_path"] for row in rows[:3]]
    paths += [str(root / "bag.npz")] + [f"{root / 'bags.mtbc'}:{i}"
                                         for i in range(3)]
    for path in paths:
        (wf, wc), (gf, gc) = (j_data.load_feature_bag(path),
                              p_data.load_feature_bag(path))
        assert gf.dtype == wf.dtype == np.float32
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gc, wc)
    (f, c) = p_data.load_feature_bag(f"{root / 'bags.mtbc'}:1")
    np.testing.assert_array_equal(f, files["bags"][1][0])
    np.testing.assert_array_equal(c, files["bags"][1][1])
    with pytest.raises(ValueError):
        p_data.load_feature_bag(str(root / "bag.h5"))


def _datasets(data, files, split):
    db = files["db"]
    matrix, case_ids, genes = data.load_gene_csv(
        str(db / "tcga_brca_xena_clean_pathway.csv"))
    packer = data.GenePacker.build(
        data.pathway_gene_groups(str(db / "gene_pathway_processed.csv")),
        genes)
    rows = data.load_split_json(files["splits"][split])["data"]
    return data.FeatureBagDataset(
        rows, matrix, case_ids, packer,
        data.load_embedding_dict(str(db / "BRCA_textembeddings_conch.pt")),
        clinical=data.load_embedding_dict(
            str(db / "simple_clinical_dict_brca.pt")),
        threshold=THRESHOLD)


@pytest.mark.parametrize("split", ["train", "val"])
def test_feature_bag_dataset_equal_jax(files, split):
    want, got = _datasets(j_data, files, split), _datasets(p_data, files,
                                                           split)
    assert got.case_ids == want.case_ids
    assert got.metadata() == want.metadata()
    multi = [c for c in got.case_ids if len(got.by_case[c]) > 1]
    assert len(multi) == (1 if split == "train" else 0)
    for i in range(len(got)):
        w = want.get(i, np.random.RandomState(i))
        g = got.get(i, np.random.RandomState(i))
        for f in ("bag", "coords", "genes", "text", "clinical"):
            a, b = getattr(w, f), getattr(g, f)
            assert b.dtype == a.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        assert (g.label, g.duration, g.event, g.case_id, g.site) == \
            (w.label, w.duration, w.event, w.case_id, w.site)
        if g.case_id in multi:
            # subsampled below the two slides' rows, kept in order, and
            # the second slide's rows 1,500 px below the first's
            rows = got.by_case[g.case_id]
            first = p_data.load_feature_bag(rows[0]["features_path"])[1]
            assert g.bag.shape[0] == THRESHOLD
            ys = g.coords[:, 1]
            second = ys > first[:, 1].max()
            assert second.any() and (~second).any()
            assert ys[second].min() >= first[:, 1].max() + 1500.0


def test_native_and_numpy_bagcache_readers_agree(files):
    path = str(files["root"] / "bags.mtbc")
    native = p_bagcache.BagCacheReader(path)
    plain = p_bagcache.BagCacheReader(path, use_native=False)
    jax_native = j_bagcache.BagCacheReader(path)
    try:
        assert native.native and not plain.native
        assert len(native) == len(plain) == 3
        assert native.feat_dim == plain.feat_dim == 64
        for i, (f, c) in enumerate(files["bags"]):
            assert native.bag_len(i) == plain.bag_len(i) == len(f)
            for reader in (native, plain, jax_native):
                rf, rc = reader.read(i)
                np.testing.assert_array_equal(rf, f)
                np.testing.assert_array_equal(rc, c)
            # the subsample: each reader's own generator, both a sorted
            # subset of the bag's rows
            for reader in (native, plain):
                sf, sc = reader.read(1, threshold=50, seed=7)
                assert sf.shape == (50, 64) and sc.shape == (50, 2)
                rows = [int(np.where((files["bags"][1][0] == r).all(1))[0][0])
                        for r in sf]
                assert rows == sorted(set(rows))
                np.testing.assert_array_equal(sc, files["bags"][1][1][rows])
        assert p_datasets.load_feature_bag(f"{path}:2")[0].shape == (5, 64)
        assert p_datasets._BAGCACHE_READERS[path].native
    finally:
        for reader in (native, plain, jax_native):
            reader.close()


def test_pt_readers_load_tensors_only(tmp_path):
    """``.pt`` files are read with ``weights_only=True``: a dict of tensors
    loads, a pickled object does not."""
    good = tmp_path / "good.pt"
    torch.save({"features": torch.ones(3, 4), "coords": torch.zeros(3, 2)},
               good)
    f, c = p_data.load_feature_bag(str(good))
    assert f.shape == (3, 4) and c.shape == (3, 2)
    bad = tmp_path / "bad.pt"
    torch.save({"features": torch.ones(3, 4), "coords": torch.zeros(3, 2),
                "extra": _Opaque()}, bad)
    with pytest.raises(Exception):
        p_data.load_feature_bag(str(bad))


class _Opaque:
    pass
