"""Synthetic scene pair for tests and smoke runs.

Copy of ``make_usss_scene`` from the JAX package's ``data/synthetic.py``:
one bi-temporal GeoTIFF pair plus a {1,2}-coded reference raster (the
Demo_USSS input contract, Demo_USSS.py:47-50,64). Image Y is a smooth
band-mixed function of X outside the change rectangles and carries a strong
offset inside them. The same seed gives the same files as the JAX package.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from .tiff import TiffWriter

Rect = Tuple[int, int, int, int]  # (x, y, w, h)

GT = (300000.0, 10.0, 0.0, 5000000.0, 0.0, -10.0)
PROJ = "SYNTHETIC/UTM"


def _scene_pair(rng, ysize: int, xsize: int, nband: int, rects: Sequence[Rect]):
    """(x, y, change_mask): y is a smooth transform of x + change offsets."""
    base = rng.normal(100.0, 30.0, size=(ysize, xsize, nband))
    for _ in range(2):  # smooth spatial structure
        base[1:] = 0.5 * base[1:] + 0.5 * base[:-1]
        base[:, 1:] = 0.5 * base[:, 1:] + 0.5 * base[:, :-1]
    x = base
    mix = np.eye(nband) * 0.9 + 0.1 / nband
    y = x @ mix + 5.0 + rng.normal(0, 1.0, size=x.shape)
    mask = np.zeros((ysize, xsize), np.uint8)
    for rx, ry, rw, rh in rects:
        mask[ry: ry + rh, rx: rx + rw] = 1
        y[ry: ry + rh, rx: rx + rw] += 80.0
    return (np.clip(x, 1.0, None).astype(np.float32),
            np.clip(y, 1.0, None).astype(np.float32), mask)


def make_usss_scene(out_dir: str, xsize: int = 96, ysize: int = 96, nband: int = 3,
                    rects: Sequence[Rect] = ((20, 24, 18, 14), (60, 60, 16, 20)),
                    seed: int = 0, dtype=np.float32) -> dict:
    """Write T1.tif, T2.tif and ref.tif into ``out_dir``; returns their paths
    and the change ``mask``. An integer ``dtype`` (e.g. np.uint16, like real
    Sentinel-2 or aerial scenes) rounds the samples before writing."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    x, y, mask = _scene_pair(rng, ysize, xsize, nband, rects)
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        x = np.round(x).astype(dtype)
        y = np.round(y).astype(dtype)
    paths = {
        "x": os.path.join(out_dir, "T1.tif"),
        "y": os.path.join(out_dir, "T2.tif"),
        "ref": os.path.join(out_dir, "ref.tif"),
    }
    with TiffWriter(paths["x"], xsize, ysize, nband, dtype, GT, PROJ) as w:
        w.write_block(x)
    with TiffWriter(paths["y"], xsize, ysize, nband, dtype, GT, PROJ) as w:
        w.write_block(y)
    # reference coded {1 unchanged, 2 changed} (Demo_USSS.py:64 gt_map=[1,2])
    with TiffWriter(paths["ref"], xsize, ysize, 1, np.uint8, GT, PROJ) as w:
        w.write_block((mask + 1).astype(np.uint8))
    paths["mask"] = mask
    return paths
