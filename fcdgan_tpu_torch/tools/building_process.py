"""WHU Building CD dataset slicer (JAX ``tools/building_process.py``;
reference BuildingProcess.py).

Slices the large before/after/change-label rasters into fixed tiles,
binarizes the labels, derives **regional** supervision maps by growing each
connected component's bounding box, and writes the ``before``, ``after``,
``Label`` and ``Region Label`` tile directories plus ``label.txt`` lines
``{x}_{y}{ext},0,0,{0|1}`` (BuildingProcess.py:88-167). Connected
components are cv2's with 8-connectivity (the reference's skimage
``connectivity=2``). The rasters are read through ``data/raster.open_raster``
and the tiles written with PIL, as the JAX tool writes them. Host code: it
runs on the CPU and touches no device.

Run: ``python -m fcdgan_tpu_torch.tools.building_process --in-path before.tif
--ref-path after.tif --label-path change_label.tif --out-path OutDir``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.raster import open_raster


def expand_regions(mask: np.ndarray, region_expand: int) -> np.ndarray:
    """0/255 uint8 region map: each 8-connected component's bounding box of
    the nonzero pixels of ``mask`` grown by ``region_expand`` px, clamped at
    the borders (BuildingProcess.py:131-145)."""
    import cv2

    out = np.zeros_like(mask, dtype=np.uint8)
    n, labels = cv2.connectedComponents((mask > 0).astype(np.uint8), connectivity=8)
    h, w = mask.shape
    for comp in range(1, n):
        ys, xs = np.where(labels == comp)
        y0, x0 = max(int(ys.min()) - region_expand, 0), max(int(xs.min()) - region_expand, 0)
        y1 = min(int(ys.max()) + 1 + region_expand, h)
        x1 = min(int(xs.max()) + 1 + region_expand, w)
        out[y0:y1, x0:x1] = 255
    return out


def run(in_path: str, ref_path: str, label_path: str, out_path: str,
        ref_ext: str = "before", tar_ext: str = "after", ext: str = ".tif",
        slice_x: int = 200, slice_y: int = 200, region_expand: int = 10) -> str:
    """Slice the three rasters into ``out_path``; returns the ``label.txt``
    path. Edge tiles are zero-padded to the full slice size."""
    from PIL import Image

    ds_x, ds_y, ds_ref = open_raster(in_path), open_raster(ref_path), open_raster(label_path)
    if (ds_x.xsize, ds_x.ysize, ds_x.nband) != (ds_y.xsize, ds_y.ysize, ds_y.nband):
        raise ValueError("Image sizes don't match")
    if (ds_ref.xsize, ds_ref.ysize, ds_ref.nband) != (ds_x.xsize, ds_x.ysize, 1):
        raise ValueError("Image sizes don't match")
    xsize, ysize, nband = ds_x.xsize, ds_x.ysize, ds_x.nband
    dirs = {"ref": os.path.join(out_path, ref_ext), "tar": os.path.join(out_path, tar_ext),
            "label": os.path.join(out_path, "Label"),
            "region": os.path.join(out_path, "Region Label")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    lines = []
    for xs in range(0, xsize, slice_x):
        for ys in range(0, ysize, slice_y):
            w, h = min(slice_x, xsize - xs), min(slice_y, ysize - ys)
            tile_x = np.zeros((slice_y, slice_x, nband), np.float64)
            tile_y = np.zeros((slice_y, slice_x, nband), np.float64)
            tile_ref = np.zeros((slice_y, slice_x), np.float64)
            tile_x[:h, :w] = ds_x.read_block(xs, ys, w, h)
            tile_y[:h, :w] = ds_y.read_block(xs, ys, w, h)
            tile_ref[:h, :w] = ds_ref.read_block(xs, ys, w, h)[..., 0]
            tile_ref[tile_ref > 0] = 255
            region = expand_regions(tile_ref.astype(np.uint8), region_expand)
            name = "{}_{}{}".format(xs, ys, ext)
            for key, tile in (("ref", tile_x), ("tar", tile_y), ("label", tile_ref),
                              ("region", region)):
                Image.fromarray(np.uint8(tile)).save(os.path.join(dirs[key], name))
            lines.append("{},0,0,{}".format(name, 1 if tile_ref.sum() > 0 else 0))

    label_txt = os.path.join(out_path, "label.txt")
    with open(label_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    return label_txt


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in-path", required=True)
    ap.add_argument("--ref-path", required=True)
    ap.add_argument("--label-path", required=True)
    ap.add_argument("--out-path", required=True)
    ap.add_argument("--slice-x", type=int, default=200)
    ap.add_argument("--slice-y", type=int, default=200)
    ap.add_argument("--region-expand", type=int, default=10)
    a = ap.parse_args(argv)
    return run(a.in_path, a.ref_path, a.label_path, a.out_path, slice_x=a.slice_x,
               slice_y=a.slice_y, region_expand=a.region_expand)


if __name__ == "__main__":
    main()
