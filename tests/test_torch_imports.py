"""The port stands alone, and its copies of the JAX package's
framework-free layers have not drifted.

* No module of ``modaltune_tpu_torch``, nor ``chip_smoke.py``,
  ``profile_train.py``, ``ab_branch_route.py`` or ``ab_prep.py``,
  imports ``jax``, ``flax``, ``optax`` or anything of ``modaltune_tpu``,
  nor ``sklearn`` or ``pandas``, which the card's machine does not have
  (walked with ``ast``, so an import inside a function counts too).
* The copied ``configs`` dataclasses equal the JAX package's field for
  field, default for default; the copied data layer gives the same arrays
  for a seed (its file readers: ``test_torch_data_readers.py``); the
  verbatim copies (``utils/constants.py``, ``utils/logging.py``,
  ``native/bagcache.cpp``, ``eval/pancancer.py``, ``data/extract.py``, the
  readout's numpy functions) are the same text; ``params_io`` reads and writes the same ``.npz`` files.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import modaltune_tpu.configs as j_configs
import modaltune_tpu.data as j_data
import modaltune_tpu_torch.configs as p_configs
import modaltune_tpu_torch.data as p_data
from modaltune_tpu.utils import params_io as j_params_io
from modaltune_tpu_torch.utils import params_io as p_params_io

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "modaltune_tpu")
# not installed beside the card
FORBIDDEN_HOST = ("sklearn", "pandas")
PORT_FILES = sorted((REPO / "modaltune_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "profile_train.py",
    REPO / "ab_branch_route.py", REPO / "ab_prep.py"]


def _imports(path):
    """Every absolute module name a file imports, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_are_found():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"modaltune_tpu_torch/configs.py",
            "modaltune_tpu_torch/data/datasets.py",
            "modaltune_tpu_torch/models/titan.py",
            "modaltune_tpu_torch/ops/alibi_flash.py",
            "modaltune_tpu_torch/utils/convert.py",
            "modaltune_tpu_torch/data/bagcache.py",
            "modaltune_tpu_torch/eval/readout.py",
            "modaltune_tpu_torch/train/trainer.py",
            "modaltune_tpu_torch/train/pancancer_trainer.py",
            "modaltune_tpu_torch/models/mil.py",
            "modaltune_tpu_torch/tools/train.py",
            "modaltune_tpu_torch/tools/trace_report.py",
            "modaltune_tpu_torch/models/extras.py",
            "modaltune_tpu_torch/data/pipeline.py",
            "modaltune_tpu_torch/data/extract.py",
            "modaltune_tpu_torch/utils/profiling.py", "chip_smoke.py",
            "profile_train.py", "ab_branch_route.py", "ab_prep.py"} <= names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[p.relative_to(REPO).as_posix()
                             for p in PORT_FILES])
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[p.relative_to(REPO).as_posix()
                             for p in PORT_FILES])
def test_port_imports_no_sklearn_or_pandas(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN_HOST]
    assert not bad, f"{path.name} imports {bad}"


CONFIG_CLASSES = ["AdapterConfig", "GeneEncoderConfig", "LongNetConfig",
                  "ModalTuneConfig", "SlideEncoderConfig", "TitanConfig",
                  "TitanModalTuneConfig", "TrainConfig"]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copy_equals_jax(name):
    """Same fields in the same order, and the same defaults."""
    jc, pc = getattr(j_configs, name), getattr(p_configs, name)
    assert [f.name for f in dataclasses.fields(jc)] == \
        [f.name for f in dataclasses.fields(pc)]
    assert dataclasses.asdict(jc()) == dataclasses.asdict(pc())


def test_config_functions_equal_jax():
    for fn, args in (("gigapath_modaltune_config", ()),
                     ("tiny_test_config", ()),
                     ("tiny_test_config", (4, True))):
        assert dataclasses.asdict(getattr(j_configs, fn)(*args)) == \
            dataclasses.asdict(getattr(p_configs, fn)(*args))
    assert j_configs.optimal_segment_lengths(262144, 256) == \
        p_configs.optimal_segment_lengths(262144, 256)
    d = dataclasses.asdict(j_configs.TitanModalTuneConfig())
    got = p_configs.model_config_from_dict(d)
    assert isinstance(got, p_configs.TitanModalTuneConfig)
    assert dataclasses.asdict(got) == d
    d = dataclasses.asdict(j_configs.gigapath_modaltune_config())
    got = p_configs.model_config_from_dict(d)
    assert isinstance(got, p_configs.ModalTuneConfig)
    assert dataclasses.asdict(got) == d
    assert set(j_configs.__all__) <= set(dir(p_configs))


def _batches(data, titan):
    groups = data.synthetic_pathways(n_genes=60, n_groups=12, max_size=7,
                                     seed=0)
    packer = data.GenePacker.build(groups, [f"g{i}" for i in range(60)])
    ds = data.SyntheticSlideDataset(n_cases=3, in_chans=16,
                                    bag_range=(100, 700), packer=packer,
                                    n_genes=60, clinical_dim=4, seed=5)
    if titan:
        ds = data.TitanGridDataset(ds)
    loader = data.BucketedLoader(ds, buckets=(255, 511, 1023), batch_size=1,
                                 shuffle=True, seed=2, prefetch=0,
                                 device_prefetch=False)
    return list(loader)


@pytest.mark.parametrize("titan", [False, True], ids=["bags", "titan_grid"])
def test_data_copy_equals_jax(titan):
    """SyntheticSlideDataset (-> TitanGridDataset) -> BucketedLoader gives
    the same batches, array for array, from both packages."""
    want, got = _batches(j_data, titan), _batches(p_data, titan)
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        assert [f.name for f in dataclasses.fields(w)] == \
            [f.name for f in dataclasses.fields(g)]
        for f in dataclasses.fields(w):
            a, b = getattr(w, f.name), getattr(g, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
    assert p_data.DEFAULT_BUCKETS == j_data.DEFAULT_BUCKETS
    assert set(j_data.__all__) <= set(p_data.__all__)


def test_kfold_splits_copy_equals_jax():
    def folds(data):
        ds = data.SyntheticSlideDataset(n_cases=10, in_chans=4,
                                        bag_range=(5, 9), seed=0)
        return [(tr.case_ids, va.case_ids, va.metadata())
                for tr, va in data.kfold_splits(ds, 3, seed=1)]

    assert folds(j_data) == folds(p_data)


def test_device_prefetch_puts_tensors_on_the_device(monkeypatch):
    """``BucketedLoader._to_device`` is the one edit of the copy: torch
    tensors through ``device_put`` instead of ``jax.device_put``."""
    import torch
    from modaltune_tpu_torch.data import datasets
    (batch,) = _batches(p_data, False)[:1]
    monkeypatch.setattr(datasets, "device_put",
                        lambda a, device=None: p_data.device_put(a, "cpu"))
    loader = p_data.BucketedLoader(None, device_prefetch=True)
    moved = loader._to_device(batch)
    for name in ("bag", "coords", "mask", "genes", "clinical"):
        t = getattr(moved, name)
        assert isinstance(t, torch.Tensor)
        assert np.array_equal(t.numpy(), getattr(batch, name))
    assert moved.text is batch.text
    assert p_data.device_put(None, "cpu") is None


def test_batch_to_device_passes_device_tensors_through():
    """A batch whose fields a device prefetch already made tensors on the
    target device is handed to the step as it is; numpy fields are
    copied."""
    import torch
    from modaltune_tpu_torch.train import batch_to_device
    (batch,) = _batches(p_data, False)[:1]
    loader = p_data.BucketedLoader(None, device_prefetch=True)
    with pytest.MonkeyPatch.context() as mp:
        from modaltune_tpu_torch.data import datasets
        mp.setattr(datasets, "device_put",
                   lambda a, device=None: p_data.device_put(a, "cpu"))
        moved = loader._to_device(batch)
    got = batch_to_device(moved, "cpu")
    for name in ("bag", "coords", "mask", "genes", "clinical"):
        assert got[name] is getattr(moved, name), name
    fresh = batch_to_device(batch, "cpu")
    for name in ("bag", "coords", "mask", "genes", "clinical"):
        assert isinstance(fresh[name], torch.Tensor)
        assert np.array_equal(fresh[name].numpy(), getattr(batch, name))


def test_params_io_copy_equals_jax():
    tree = {"a": {"b": np.arange(3), "c": {"d": np.ones((2, 2))}},
            "e": np.zeros(1)}
    want, got = j_params_io.flatten_params(tree), \
        p_params_io.flatten_params(tree)
    assert list(want) == list(got) == ["a/b", "a/c/d", "e"]
    assert all(np.array_equal(want[k], got[k]) for k in want)
    back = p_params_io.unflatten_params(got)
    assert back.keys() == tree.keys() and \
        np.array_equal(back["a"]["c"]["d"], tree["a"]["c"]["d"])


VERBATIM = [("modaltune_tpu/utils/constants.py",
             "modaltune_tpu_torch/utils/constants.py"),
            ("modaltune_tpu/utils/logging.py",
             "modaltune_tpu_torch/utils/logging.py"),
            ("modaltune_tpu/native/bagcache.cpp",
             "modaltune_tpu_torch/native/bagcache.cpp"),
            ("modaltune_tpu/eval/pancancer.py",
             "modaltune_tpu_torch/eval/pancancer.py"),
            ("modaltune_tpu/data/extract.py",
             "modaltune_tpu_torch/data/extract.py")]


@pytest.mark.parametrize("jax_file,port_file", VERBATIM,
                         ids=[p for _, p in VERBATIM])
def test_verbatim_copies_equal_jax(jax_file, port_file):
    assert (REPO / port_file).read_text() == (REPO / jax_file).read_text()


def test_readout_numpy_code_equals_jax():
    """The readout's numpy-only names are the JAX package's code as it
    is; only the sklearn-backed fits and metrics are rebuilt."""
    import inspect
    from modaltune_tpu.eval import readout as j_readout
    from modaltune_tpu_torch.eval import readout as p_readout
    assert p_readout.TASK_NAMES == j_readout.TASK_NAMES
    for name in ("filter_labelset", "concordance_index", "CoxPH",
                 "perform_testing"):
        assert inspect.getsource(getattr(p_readout, name)) == \
            inspect.getsource(getattr(j_readout, name)), name


def test_params_npz_files_equal_jax(tmp_path):
    """Either package reads the other's ``.npz``; bf16 leaves come back
    from the port's reader as the float32 values they were saved as."""
    import ml_dtypes
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "c": np.asarray([1.5, -2.25], ml_dtypes.bfloat16)},
            "d": np.ones(2, np.int32)}
    j_params_io.save_params_npz(str(tmp_path / "j.npz"), tree)
    p_params_io.save_params_npz(str(tmp_path / "p.npz"), tree)
    for name in ("j.npz", "p.npz"):
        want = j_params_io.flatten_params(
            j_params_io.load_params_npz(str(tmp_path / name)))
        got = p_params_io.flatten_params(
            p_params_io.load_params_npz(str(tmp_path / name)))
        assert list(got) == list(want) == ["a/b", "a/c", "d"]
        assert want["a/c"].dtype == ml_dtypes.bfloat16
        assert got["a/c"].dtype == np.float32
        for k in want:
            np.testing.assert_array_equal(got[k],
                                          want[k].astype(got[k].dtype))
