"""Synthetic datasets for tests and smoke runs.

Copies of the JAX package's ``data/synthetic.py`` generators, in the exact
on-disk layouts the drivers read:

  * ``make_usss_scene``: one bi-temporal GeoTIFF pair plus a {1,2}-coded
    reference raster (the Demo_USSS input contract, Demo_USSS.py:47-50,64);
  * ``make_whu_dataset``: ``before/``, ``after/``, ``Label/`` slice dirs and
    ``label.txt`` (the BuildingProcess.py output contract,
    BuildingProcess.py:150-167), uint8 slices written as plain TIFFs;
  * ``make_oscd_dataset``: per-scene ``ImagePair/`` dirs with an ENVI image
    pair, ``{name}-cm.tif`` ({1, 2} coded) and ``{name}-region.tif``, plus
    the train/test scene lists (the OSCDProcess.py output contract,
    OSCDProcess.py:22-30, 75-78).

Image Y is a smooth band-mixed function of X outside the change rectangles
and carries a strong offset inside them. The same seed gives the same
pixels as the JAX package, which writes its WHU slices through PIL; with
its default arguments ``make_oscd_dataset`` writes the same files, byte for
byte.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from .envi import write_envi
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


def make_whu_dataset(out_dir: str, n_changed: int = 4, n_unchanged: int = 6,
                     size: int = 48, seed: int = 0) -> dict:
    """Write ``n_changed`` changed and ``n_unchanged`` unchanged RGB uint8
    ``size`` x ``size`` slice pairs, their 0/255 labels and label.txt
    (``{name},0,0,{1|0}``) into ``out_dir``; returns the paths."""
    dirs = {k: os.path.join(out_dir, k) for k in ("before", "after", "Label")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_changed + n_unchanged):
        changed = i < n_changed
        rects = [(size // 4, size // 4, size // 3, size // 3)] if changed else []
        x, y, mask = _scene_pair(rng, size, size, 3, rects)
        name = f"{i}_0.tif"
        for key, img in (("before", x), ("after", y)):
            with TiffWriter(os.path.join(dirs[key], name), size, size, 3, np.uint8) as w:
                w.write_block(np.clip(img, 0, 255).astype(np.uint8))
        with TiffWriter(os.path.join(dirs["Label"], name), size, size, 1, np.uint8) as w:
            w.write_block((mask * 255).astype(np.uint8))
        lines.append(f"{name},0,0,{1 if changed else 0}")
    with open(os.path.join(out_dir, "label.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"root": out_dir, **dirs, "label_txt": os.path.join(out_dir, "label.txt")}


def make_oscd_dataset(out_dir: str, train_scenes: Sequence[str] = ("alpha", "beta"),
                      test_scenes: Sequence[str] = ("gamma",),
                      xsize: int = 64, ysize: int = 64, nband: int = 4,
                      region_expand: int = 6, seed: int = 0,
                      rects: Sequence[Rect] = ((10, 12, 14, 12), (40, 36, 12, 16)),
                      dtype=np.float32) -> dict:
    """Write the OSCD layout of the scenes into ``out_dir``: each scene's
    change rectangles ``rects`` (the defaults fit a 64 px scene), its region
    raster (255 over each rectangle grown by ``region_expand`` px, clipped
    to the scene), and ``train.txt`` / ``test.txt``. An integer ``dtype``
    (np.uint16, like Sentinel-2 L1C) rounds the image samples before
    writing."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    for scene in list(train_scenes) + list(test_scenes):
        d = os.path.join(out_dir, scene, "ImagePair")
        os.makedirs(d, exist_ok=True)
        x, y, mask = _scene_pair(rng, ysize, xsize, nband, rects)
        if np.issubdtype(dtype, np.integer):
            x = np.round(x).astype(dtype)
            y = np.round(y).astype(dtype)
        write_envi(os.path.join(d, f"{scene}_20160120"), x, geotransform=GT)
        write_envi(os.path.join(d, f"{scene}_20180328"), y, geotransform=GT)
        # cm coded {1 unchanged, 2 changed} (OSCDProcess.py:57)
        with TiffWriter(os.path.join(d, f"{scene}-cm.tif"), xsize, ysize, 1, np.uint8, GT) as w:
            w.write_block((mask + 1).astype(np.uint8))
        region = np.zeros_like(mask)
        for rx, ry, rw, rh in rects:
            x0, y0 = max(rx - region_expand, 0), max(ry - region_expand, 0)
            x1, y1 = min(rx + rw + region_expand, xsize), min(ry + rh + region_expand, ysize)
            region[y0:y1, x0:x1] = 255
        with TiffWriter(os.path.join(d, f"{scene}-region.tif"), xsize, ysize, 1, np.uint8,
                        GT) as w:
            w.write_block(region)
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write(",".join(train_scenes) + "\n")
    with open(os.path.join(out_dir, "test.txt"), "w") as f:
        f.write(",".join(test_scenes) + "\n")
    return {"root": out_dir, "train_txt": "train.txt", "test_txt": "test.txt"}
