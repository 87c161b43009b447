"""WSI tile extraction + tile-feature encoding (offline pipeline).

Port of ``utils/extract_patches.py`` (LAB-space tissue mask, grid
patching, foreground-ratio filter) and the drivers
``data_utils/TCGA_extract_feats_GIGAPATH.py`` /
``TCGA_extract_feats_TITAN.py`` (tile batches -> tile encoder ->
``{features, coords}`` per-slide cache).

Environment notes: OpenSlide/dplabtools and the GigaPath/CONCH tile
encoders are external dependencies. This module therefore works on any
slide *array source* (a callable ``(x, y, size) -> RGB ndarray`` — an
OpenSlide handle adapts trivially) and any *tile encoder* (a callable
``(N, size, size, 3) uint8 -> (N, feat_dim)``) — e.g. a JAX ViT or a
timm model. The grid/tissue logic itself is pure numpy and fully
tested.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


def rgb_to_lab_l(rgb: np.ndarray) -> np.ndarray:
    """Approximate L channel of CIELAB from uint8 RGB (vectorized; no
    skimage dependency). Good enough for tissue/background thresholding.
    """
    x = rgb.astype(np.float32) / 255.0
    # linearize sRGB
    x = np.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    y = (0.2126 * x[..., 0] + 0.7152 * x[..., 1] + 0.0722 * x[..., 2])
    fy = np.where(y > 0.008856, np.cbrt(y), 7.787 * y + 16.0 / 116.0)
    return 116.0 * fy - 16.0


def tissue_mask(thumb: np.ndarray, l_threshold: float = 85.0
                ) -> np.ndarray:
    """Foreground = not-bright pixels in LAB L (tissue is darker than the
    white slide background)."""
    return rgb_to_lab_l(thumb) < l_threshold


@dataclasses.dataclass
class GridPatchPlan:
    """Tile grid for one slide: coordinates that pass the
    foreground-ratio filter."""

    coords: np.ndarray       # (N, 2) level-0 (x_row, y_col) pixel coords
    tile_size: int
    stride: int


def plan_patches(mask: np.ndarray, mask_downsample: int,
                 tile_size: int = 256, stride: Optional[int] = None,
                 min_foreground: float = 0.5) -> GridPatchPlan:
    """Grid tiling over the tissue mask: keep tiles whose mask window has
    >= ``min_foreground`` tissue fraction (the dplabtools
    foreground-ratio filter in ``extract_patches.py:17-158``)."""
    stride = stride or tile_size
    mh, mw = mask.shape
    mtile = max(1, tile_size // mask_downsample)
    mstride = max(1, stride // mask_downsample)
    coords = []
    # integral image for fast window sums
    ii = np.pad(mask.astype(np.int64), ((1, 0), (1, 0))).cumsum(0).cumsum(1)
    for i in range(0, mh - mtile + 1, mstride):
        for j in range(0, mw - mtile + 1, mstride):
            s = (ii[i + mtile, j + mtile] - ii[i, j + mtile]
                 - ii[i + mtile, j] + ii[i, j])
            if s / (mtile * mtile) >= min_foreground:
                coords.append((i * mask_downsample, j * mask_downsample))
    return GridPatchPlan(coords=np.asarray(coords, np.int64).reshape(-1, 2),
                         tile_size=tile_size, stride=stride)


def iter_tile_batches(read_region: Callable[[int, int, int], np.ndarray],
                      plan: GridPatchPlan, batch_size: int = 512
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (tiles (B, s, s, 3) uint8, coords (B, 2)) batches."""
    n = len(plan.coords)
    for start in range(0, n, batch_size):
        chunk = plan.coords[start:start + batch_size]
        tiles = np.stack([read_region(int(r), int(c), plan.tile_size)
                          for r, c in chunk])
        yield tiles.astype(np.uint8), chunk.astype(np.float32)


def extract_slide_features(read_region, mask: np.ndarray,
                           mask_downsample: int,
                           tile_encoder: Callable[[np.ndarray], np.ndarray],
                           tile_size: int = 256, batch_size: int = 512,
                           min_foreground: float = 0.5,
                           output_npz: Optional[str] = None) -> dict:
    """Full per-slide pipeline: plan -> read -> encode -> feature bag
    ``{"features": (N, D), "coords": (N, 2)}`` (the runtime dataset's
    cache format, see data/datasets.py::load_feature_bag)."""
    plan = plan_patches(mask, mask_downsample, tile_size,
                        min_foreground=min_foreground)
    feats, coords = [], []
    for tiles, cs in iter_tile_batches(read_region, plan, batch_size):
        feats.append(np.asarray(tile_encoder(tiles), np.float32))
        coords.append(cs)
    out = {
        "features": (np.concatenate(feats) if feats
                     else np.zeros((0, 1), np.float32)),
        "coords": (np.concatenate(coords) if coords
                   else np.zeros((0, 2), np.float32)),
    }
    if output_npz:
        np.savez(output_npz, **out)
    return out


def array_slide_reader(slide: np.ndarray) -> Callable:
    """Adapter: a full-resolution RGB array -> read_region callable (for
    tests and in-memory slides). With OpenSlide, the equivalent is
    ``lambda r, c, s: np.asarray(osr.read_region((c, r), 0, (s, s)))[..., :3]``.
    """
    def read_region(row: int, col: int, size: int) -> np.ndarray:
        tile = slide[row:row + size, col:col + size]
        if tile.shape[0] != size or tile.shape[1] != size:
            tile = np.pad(tile, ((0, size - tile.shape[0]),
                                 (0, size - tile.shape[1]), (0, 0)),
                          constant_values=255)
        return tile
    return read_region


def extract_slide_features_titan(read_region, mask: np.ndarray,
                                 mask_downsample: int,
                                 patch_encoder, slide_encoder=None,
                                 tile_size: int = 512,
                                 batch_size: int = 64,
                                 min_foreground: float = 0.5,
                                 output_npz: Optional[str] = None) -> dict:
    """TITAN-specific extraction driver
    (``data_utils/TCGA_extract_feats_TITAN.py``): 512-px tiles at 0.5
    MPP through a CONCH v1.5 patch encoder (pluggable — the weights are
    gated externally), optionally followed by the TITAN slide encoder
    for a whole-slide embedding. The reference runs the slide encoder
    under bf16 autocast (``TCGA_extract_feats_TITAN.py:111-118``); pass
    a ``slide_encoder`` that casts internally for the same behavior
    (our ``TitanViT`` with ``dtype=jnp.bfloat16``).

    Returns ``{"features": (N, D), "coords": (N, 2)[, "slide_embedding"
    : (D,)]}`` — the ``_titan`` feature-bag cache format.
    """
    bag = extract_slide_features(
        read_region, mask, mask_downsample, patch_encoder,
        tile_size=tile_size, batch_size=batch_size,
        min_foreground=min_foreground)
    if slide_encoder is not None:
        bag["slide_embedding"] = np.asarray(
            slide_encoder(bag["features"], bag["coords"]), np.float32)
    if output_npz:
        np.savez(output_npz, **bag)
    return bag
