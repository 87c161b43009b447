"""The port's tile extraction (``data/extract.py``, the JAX package's
numpy code copied as it is: ``tests/test_torch_imports.py`` holds the
text equal) against the JAX package's, on the CPU: the same slides and
encoders give equal tissue masks, tile plans, batches and feature bags,
the GigaPath driver's and the TITAN driver's (with a slide encoder), and
the port's loader reads the bag the port wrote. The slides are
``chip_smoke.synthetic_slide``'s, which make each window's pixels as it is
read; ``phase_prepare`` extracts from them on the card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from modaltune_tpu.data import extract as J
from modaltune_tpu_torch.data import extract as P
from modaltune_tpu_torch.data import load_feature_bag

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _encoder(out_dim, seed):
    """A stand-in tile encoder: 8x8 mean-pooled RGB through a seeded
    projection."""
    w = np.random.RandomState(seed).randn(8 * 8 * 3, out_dim) \
        .astype(np.float32)

    def encode(tiles):
        n, s = tiles.shape[:2]
        x = tiles.reshape(n, 8, s // 8, 8, s // 8, 3).mean(axis=(2, 4))
        return x.reshape(n, -1).astype(np.float32) / 255.0 @ w
    return encode


@pytest.mark.parametrize("seed,n_tiles", [(0, 60), (1, 150)])
def test_gigapath_extraction_matches_jax(cs, tmp_path, seed, n_tiles):
    read_region, thumb, ds = cs.synthetic_slide(seed, n_tiles)
    masks = [m.tissue_mask(thumb) for m in (J, P)]
    assert np.array_equal(masks[0], masks[1])
    assert np.array_equal(J.rgb_to_lab_l(thumb), P.rgb_to_lab_l(thumb))
    plans = [m.plan_patches(masks[0], ds, 256) for m in (J, P)]
    assert np.array_equal(plans[0].coords, plans[1].coords)
    assert 0.8 * n_tiles <= len(plans[1].coords) <= 1.2 * n_tiles
    want = J.extract_slide_features(read_region, masks[0], ds,
                                    _encoder(16, seed), batch_size=40,
                                    output_npz=str(tmp_path / "j.npz"))
    got = P.extract_slide_features(read_region, masks[1], ds,
                                   _encoder(16, seed), batch_size=40,
                                   output_npz=str(tmp_path / "p.npz"))
    for k in ("features", "coords"):
        assert np.array_equal(got[k], want[k]), k
    feats, coords = load_feature_bag(str(tmp_path / "p.npz"))
    assert np.array_equal(feats, want["features"])
    assert np.array_equal(coords, want["coords"])
    # tissue tiles carry the stain, not the glass
    tiles, _ = next(P.iter_tile_batches(read_region, plans[1], 8))
    assert tiles.shape == (8, 256, 256, 3) and tiles.mean() < 200


def test_titan_extraction_matches_jax(cs, tmp_path):
    read_region, thumb, ds = cs.synthetic_slide(2, 40, tile=512)
    mask = P.tissue_mask(thumb)

    def slide_encoder(feats, coords):
        return np.concatenate([feats.mean(0), coords.max(0)])
    out = {}
    for name, m in (("jax", J), ("port", P)):
        out[name] = m.extract_slide_features_titan(
            read_region, mask, ds, _encoder(12, 4),
            slide_encoder=slide_encoder, batch_size=16,
            output_npz=str(tmp_path / f"{name}.npz"))
    for k in ("features", "coords", "slide_embedding"):
        assert np.array_equal(out["port"][k], out["jax"][k]), k
    assert np.all(out["port"]["coords"] % 512 == 0)
    saved = np.load(tmp_path / "port.npz")
    assert sorted(saved.files) == ["coords", "features", "slide_embedding"]
