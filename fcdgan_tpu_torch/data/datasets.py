"""Datasets: a tiled scene pair and the WHU slice sets.

Copies of the JAX package's ``data/datasets.py`` classes, trimmed to what
the port's drivers use:

  * ``ScenePairDataset`` (parity: GDALDataset, reference
    data_utils.py:28-236): numpy (h, w, nband) float32 tiles for the
    statistics pass and the streaming serving path, the whole-scene density
    write of the fused serving path and the per-tile stitched writes, of a
    patch-sized tile or one cropped to its interior on the device. Normalisation
    (``enhance``) applies to the raw read window *before* zero padding,
    exactly like the reference (data_utils.py:110-120), so the canvas
    padding stays zero.
  * ``RegionScenePairDataset`` (GDALDataset_RSS, data_utils.py:239-290) and
    ``OSCDDataset`` (OSCD_Dataset_RSS, data_utils.py:294-446): the RSSS
    scene lists, each scene with its own normalizer, a coarse region raster
    beside the reference, and per-(filter, scene) output rasters, written
    tile by tile or a whole scene at once (the ``oscd`` serving mode).
  * ``WHUDataset`` (parity: WHU_Dataset, data_utils.py:449-563) and
    ``WHUPairDataset`` (WHU_Dataset_WSS, data_utils.py:570-625): the slice
    lists selected through ``label.txt``, the changed slices' references
    binarized, and the changed/unchanged pairing of weak supervision. The
    augmentation ``transforms`` are not ported.
"""

from __future__ import annotations

import math
import os
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .raster import create_raster, open_raster, read_image
from .tile_grid import TileGrid

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".PNG", ".JPG", ".tif")


class ScenePairDataset:
    """Overlap-tiled bi-temporal scene pair (+ optional 1-band reference)."""

    def __init__(self, img_path_x, img_path_y, ref_path=None,
                 out_path: Optional[str] = None,
                 enhance: Optional[Callable] = None,
                 patch_size: Tuple[int, int] = (200, 200),
                 overlap_padding: Tuple[int, int] = (10, 10)):
        self.raster_x = open_raster(img_path_x)
        self.raster_y = open_raster(img_path_y)
        if (self.raster_x.xsize, self.raster_x.ysize, self.raster_x.nband) != (
                self.raster_y.xsize, self.raster_y.ysize, self.raster_y.nband):
            raise ValueError("Image sizes don't match")
        self.enhance = enhance
        self.patch_size = patch_size
        self.overlap_padding = overlap_padding
        self.grid = TileGrid(self.raster_x.xsize, self.raster_x.ysize,
                             patch_size, overlap_padding)
        self.raster_ref = None
        if ref_path is not None:
            self.raster_ref = open_raster(ref_path)
            if (self.raster_ref.xsize != self.raster_x.xsize
                    or self.raster_ref.ysize != self.raster_x.ysize
                    or self.raster_ref.nband != 1):
                raise ValueError("Reference sizes don't match image")
        self.out_path = out_path
        self._out = None

    def __len__(self) -> int:
        return len(self.grid)

    def size(self) -> Tuple[int, int, int]:
        return self.raster_x.xsize, self.raster_x.ysize, self.raster_x.nband

    def _canvas(self, read_window: np.ndarray, write) -> np.ndarray:
        h, w = self.patch_size[1], self.patch_size[0]
        canvas = np.zeros((h, w, read_window.shape[-1]), np.float32)
        canvas[write[1]: write[1] + write[3], write[0]: write[0] + write[2], :] = read_window
        return canvas

    def __getitem__(self, item: int):
        """(x, y, item, ref) canvases of one tile (data_utils.py:91-140)."""
        _, read, write = self.grid.slices(item)
        x = self.raster_x.read_block(*read).astype(np.float32)
        y = self.raster_y.read_block(*read).astype(np.float32)
        if self.enhance is not None:
            x = self.enhance(x, switch=1)
            y = self.enhance(y, switch=2)
        x = self._canvas(x, write)
        y = self._canvas(y, write)
        ref = np.zeros((self.patch_size[1], self.patch_size[0], 1), np.float32)
        if self.raster_ref is not None:
            r = self.raster_ref.read_block(*read).astype(np.float32)
            ref[write[1]: write[1] + write[3], write[0]: write[0] + write[2], :] = r
        return x, y, item, ref

    def _density_out(self):
        """The float32 density raster at ``out_path``, created at first use
        with image X's geo metadata (data_utils.py:190-198)."""
        if self._out is None:
            if self.out_path is None:
                raise ValueError("ScenePairDataset was built without an out_path")
            xs, ys, _ = self.size()
            self._out = create_raster(self.out_path, xs, ys, 1, np.float32,
                                      like=self.raster_x)
        return self._out

    def write_default(self, out_image: np.ndarray, item: int) -> None:
        """Stitch one tile's density into the ``out_path`` raster (parity:
        GDALwriteDefault, data_utils.py:178-213; JAX datasets.py:113-123)."""
        self._write_interior(self._density_out(), out_image, item)

    def write(self, out_image: np.ndarray, item: int, out_raster=None) -> None:
        """Write the interior of tile ``item`` of an (h, w) or (h, w, bands)
        canvas into ``out_raster`` at its core, or into the density raster
        when it is None (parity: GDALwrite, data_utils.py:215-236)."""
        if out_raster is None:
            self.write_default(out_image, item)
            return
        if out_image.ndim == 2:
            out_image = out_image[..., None]
        if out_image.shape[-1] != out_raster.nband:
            raise ValueError("The band of output image doesn't match the output raster")
        self._write_interior(out_raster, out_image, item)

    def _write_interior(self, raster, out_image: np.ndarray, item: int) -> None:
        """A tile canvas (patch-sized), or one already cropped to its
        ``patch - 2 * padding`` interior on the device (JAX datasets.py:
        139-156), written at the tile's core."""
        if out_image.ndim == 2:
            out_image = out_image[..., None]
        core, _, _ = self.grid.slices(item)
        padx, pady = self.overlap_padding
        ph, pw = self.patch_size[1], self.patch_size[0]
        if out_image.shape[:2] == (ph - 2 * pady, pw - 2 * padx):
            interior = out_image[:core[3], :core[2], :]
        else:
            interior = out_image[pady: pady + core[3], padx: padx + core[2], :]
        if interior.shape[-1] == 1:
            raster.write_block(interior[..., 0], core[0], core[1], band=0)
        else:
            raster.write_block(interior, core[0], core[1])

    def write_full(self, density: np.ndarray):
        """Write the whole stitched (ysize, xsize) density raster in one call,
        with the geo metadata copied from image X (data_utils.py:190-198)."""
        d = density[..., 0] if density.ndim == 3 else density
        self._density_out().write_block(d.astype(np.float32), 0, 0, band=0)

    def interior_sizes(self) -> np.ndarray:
        """(n_tiles, 2) core (h, w) per item."""
        return self.grid.interior_sizes()

    def close_outputs(self):
        if self._out is not None:
            self._out.close()
            self._out = None


class RegionScenePairDataset:
    """A scene pair with a coarse region raster: items (x, y, item, ref,
    region), the region canvas with values above 125 set to 1 and smaller
    ones kept (parity: GDALDataset_RSS, data_utils.py:273-282)."""

    def __init__(self, img_path_x, img_path_y, region_path=None, ref_path=None,
                 enhance: Optional[Callable] = None,
                 patch_size: Tuple[int, int] = (200, 200),
                 overlap_padding: Tuple[int, int] = (10, 10)):
        self.ds = ScenePairDataset(img_path_x, img_path_y, ref_path=ref_path, enhance=enhance,
                                   patch_size=patch_size, overlap_padding=overlap_padding)
        self.patch_size = patch_size
        self.raster_region = None
        if region_path is not None:
            self.raster_region = open_raster(region_path)
            if (self.raster_region.xsize != self.ds.raster_x.xsize
                    or self.raster_region.ysize != self.ds.raster_x.ysize
                    or self.raster_region.nband != 1):
                raise ValueError("Reference sizes don't match image")

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, item: int):
        x, y, item, ref = self.ds[item]
        region = np.zeros((self.patch_size[1], self.patch_size[0], 1), np.float32)
        if self.raster_region is not None:
            _, read, write = self.ds.grid.slices(item)
            r = self.raster_region.read_block(*read).astype(np.float32)
            region[write[1]: write[1] + write[3], write[0]: write[0] + write[2], :] = r
        region[region > 125] = 1
        return x, y, item, ref, region


class OSCDDataset:
    """The scenes of an OSCD list as one dataset (parity: OSCD_Dataset_RSS,
    data_utils.py:294-446).

    The list is a one-line comma-separated txt under ``img_dir``. Each scene
    directory ``{name}/ImagePair/`` holds two extension-less ENVI images
    whose names contain the scene name, a ``*-cm.tif`` reference and a
    ``*-region.tif`` region raster. ``scaler`` gives one normalizer per
    scene; ``transforms`` one sync transform per scene, of which the port
    runs none yet (the random eraser, ROADMAP.md queue A). Items are indexed
    globally by the cumulative scene lengths; ``write`` stitches into
    per-(filter, scene) rasters created at first use."""

    def __init__(self, img_dir: str, txt_name: str, scaler: Optional[Sequence] = None,
                 transforms: Optional[Sequence] = None,
                 patch_size: Tuple[int, int] = (200, 200),
                 overlap_padding: Tuple[int, int] = (10, 10)):
        self.img_dir = img_dir
        self.patch_size = patch_size
        self.overlap_padding = overlap_padding
        with open(os.path.join(img_dir, txt_name)) as f:
            filenames = [n for n in f.readline().strip().split(",") if n]
        # the length checks come before any scene is opened (datasets.py:245-252)
        if scaler is not None and len(scaler) != len(filenames):
            raise ValueError("The list of scaler doesn't match the file list")
        if transforms is not None and len(transforms) != len(filenames):
            raise ValueError("The list of transforms doesn't match the file list")
        if transforms is not None and any(t is not None for t in transforms):
            raise NotImplementedError("OSCD sync transforms (the random eraser) are not "
                                      "ported yet; see ROADMAP.md (queue A)")
        self.dslist: List[RegionScenePairDataset] = []
        self.numlist: List[int] = []
        self.namelist: List[str] = []
        self.pathlist: List[List[str]] = []
        for idx, name in enumerate(filenames):
            cur = os.path.join(img_dir, name, "ImagePair")
            files = os.listdir(cur)
            imgs = sorted(x for x in files if os.path.splitext(x)[-1] == "" and name in x)
            if len(imgs) != 2:
                raise ValueError(f"Error in finding image file {cur}")
            refs = [x for x in files if x.split("-")[-1] == "cm.tif"]
            if len(refs) != 1:
                raise ValueError(f"Error in finding reference file {cur}")
            regions = [x for x in files if x.split("-")[-1] == "region.tif"]
            if len(regions) != 1:
                raise ValueError(f"Error in finding region file {cur}")
            px, py, pr, pg = (os.path.join(cur, f) for f in (*imgs, refs[0], regions[0]))
            self.pathlist.append([px, py, pr, pg])
            ds = RegionScenePairDataset(
                px, py, region_path=pg, ref_path=pr,
                enhance=None if scaler is None else scaler[idx],
                patch_size=patch_size, overlap_padding=overlap_padding)
            self.dslist.append(ds)
            self.numlist.append(len(ds))
            self.namelist.append(name)
        self.cumlen = np.cumsum(self.numlist).tolist()
        self._writers = {}  # (filter_name, scene index) -> raster writer

    def __len__(self) -> int:
        return int(self.cumlen[-1]) if self.cumlen else 0

    def _locate(self, item: int) -> Tuple[int, int]:
        """Global item -> (scene index, item within the scene)."""
        if item >= len(self):
            raise IndexError("item exceeds the len")
        ds_idx = int(np.searchsorted(np.asarray(self.cumlen), item, side="right"))
        return ds_idx, (item - self.cumlen[ds_idx - 1] if ds_idx > 0 else item)

    def __getitem__(self, item: int):
        ds_idx, cur = self._locate(item)
        x, y, _, ref, region = self.dslist[ds_idx][cur]
        return x, y, item, ref, region

    def eff_range(self, item: int) -> Tuple[int, int, int, int]:
        """Interior eval window (y0, y1, x0, x1) of a global item (parity:
        EffRange, data_utils.py:390-405)."""
        ds_idx, cur = self._locate(item)
        return self.dslist[ds_idx].ds.grid.interior(cur)

    def interior_sizes(self) -> np.ndarray:
        """The scenes' (core_h, core_w) rows, indexed by global item."""
        return np.concatenate([d.ds.grid.interior_sizes() for d in self.dslist])

    def _writer(self, ds_idx: int, filter_name: str, nband: int):
        """The float32 raster ``{scene}/ImagePair/{filter_name}`` of scene
        ``ds_idx``, created at first use with image X's geo metadata."""
        key = (filter_name, ds_idx)
        if key not in self._writers:
            base = self.dslist[ds_idx].ds
            xs, ys, _ = base.size()
            path = os.path.join(self.img_dir, self.namelist[ds_idx], "ImagePair", filter_name)
            self._writers[key] = create_raster(path, xs, ys, nband, np.float32,
                                               like=base.raster_x)
        return self._writers[key]

    def write(self, out_image: np.ndarray, item: int, filter_name: str) -> None:
        """Stitch a tile (patch-sized or cropped to its interior) into its
        scene's ``filter_name`` raster (parity: GDALwrite,
        data_utils.py:408-446)."""
        ds_idx, cur = self._locate(item)
        if out_image.ndim == 2:
            out_image = out_image[..., None]
        writer = self._writer(ds_idx, filter_name, out_image.shape[-1])
        self.dslist[ds_idx].ds.write(out_image, cur, writer)

    def write_full_scene(self, ds_idx: int, array: np.ndarray, filter_name: str) -> None:
        """Write one whole (ysize, xsize[, bands]) scene raster of a filter in
        one call (the fused serving path; JAX datasets.py:338-358)."""
        if array.ndim == 2:
            array = array[..., None]
        writer = self._writer(ds_idx, filter_name, array.shape[-1])
        if array.shape[-1] == 1:
            writer.write_block(array[..., 0].astype(np.float32), 0, 0, band=0)
        else:
            writer.write_block(array.astype(np.float32), 0, 0)

    def close_outputs(self) -> None:
        for w in self._writers.values():
            w.close()
        self._writers = {}


class WHUDataset:
    """Slice-image dataset over before/after/Label dirs + label.txt.

    label_selected: '1' changed only, '0' unchanged only, '-1' all listed,
    '-2' everything. An item is (x, y, ref, item, label): float32 (h, w, C)
    slices (normalized when ``scale`` is given), the (h, w, 1) reference
    binarized ``> 0`` for a slice labeled changed and zero otherwise, and
    label.txt's three codes."""

    def __init__(self, img_dir_x: str, img_dir_y: str, ref_dir: str, label_dir: str,
                 label_selected: str = "-1", scale=None):
        with open(os.path.join(label_dir, "label.txt")) as f:
            self.label_list = [line.strip("\n").split(",") for line in f.readlines()]
        names_x = sorted(x for x in os.listdir(img_dir_x)
                         if self._is_image_file(x) and self._is_image_label(x, label_selected))
        names_y = sorted(y for y in os.listdir(img_dir_y)
                         if self._is_image_file(y) and self._is_image_label(y, label_selected))
        if names_x != names_y:
            raise ValueError("The multi-temporal images don't match")
        self.label_list = self._label_list_arrange(names_x)
        self.img_path_x = [os.path.join(img_dir_x, n) for n in names_x]
        self.img_path_y = [os.path.join(img_dir_y, n) for n in names_y]
        self.ref_path = [os.path.join(ref_dir, n) for n in names_x]
        self.scale = scale

    @staticmethod
    def _is_image_file(filename: str) -> bool:
        return any(filename.endswith(e) for e in IMAGE_EXTENSIONS)

    def _is_image_label(self, filename: str, label_selected: str) -> bool:
        if label_selected == "-2":
            return True
        for label_item in self.label_list:
            if filename in label_item:
                if label_selected == "-1":
                    return True
                return label_item[3] == label_selected
        return False

    def _label_list_arrange(self, filename_list):
        out = []
        for filename in filename_list:
            tmp = [filename, "-1", "-1", "-2"]
            for label_item in self.label_list:
                if filename in label_item:
                    tmp = label_item
                    break
            out.append(tmp)
        return out

    def __len__(self) -> int:
        return len(self.img_path_x)

    def get_file_name(self, item: int) -> str:
        return os.path.split(self.img_path_x[item])[1]

    def raw_ref(self, item: int, hw: Tuple[int, int]) -> np.ndarray:
        """(h, w, 1) uint8 reference: the label raster ``> 0`` for a changed
        slice, zeros of the slice's size ``hw`` otherwise
        (data_utils.py:501-508)."""
        if int(self.label_list[item][3]) == 1:
            return (read_image(self.ref_path[item])[..., :1] > 0).astype(np.uint8)
        return np.zeros(tuple(hw) + (1,), np.uint8)

    def __getitem__(self, item: int):
        x = read_image(self.img_path_x[item]).astype(np.float32)
        y = read_image(self.img_path_y[item]).astype(np.float32)
        ref = self.raw_ref(item, x.shape[:2]).astype(np.float32)
        if self.scale is not None:
            x = self.scale(x, switch=1)
            y = self.scale(y, switch=2)
        label = np.array([int(v) for v in self.label_list[item][1:]], np.int32)
        return x, y, ref, item, label


class WHUPairDataset:
    """Changed/unchanged pairing for weak supervision, with the JAX package's
    ``random_assign=False`` (the drivers' setting; a random partner per item
    is not ported).

    The class with the larger count is the base; the smaller one is repeated
    through shuffled orders that ``order_reset`` rebuilds each epoch. ``rng``
    is consumed exactly as in the JAX package, so the same
    ``random.Random(seed)`` gives the same pairs."""

    def __init__(self, img_dir_x, img_dir_y, ref_dir, label_dir, scale=None,
                 rng: Optional[random.Random] = None):
        self.c_ds = WHUDataset(img_dir_x, img_dir_y, ref_dir, label_dir, scale=scale,
                               label_selected="1")
        self.nc_ds = WHUDataset(img_dir_x, img_dir_y, ref_dir, label_dir, scale=scale,
                                label_selected="0")
        self.c_len = len(self.c_ds)
        self.nc_len = len(self.nc_ds)
        self.rng = rng or random.Random()
        self.order_reset()

    def order_reset(self):
        base, other = max(self.c_len, self.nc_len), min(self.c_len, self.nc_len)
        order_tmp = list(range(other))
        order = []
        for _ in range(math.ceil(base / other)):
            self.rng.shuffle(order_tmp)
            order = order + order_tmp
        if self.c_len > self.nc_len:
            self.nc_order, self.c_order = order[:self.c_len], list(range(self.c_len))
        else:
            self.c_order, self.nc_order = order[:self.nc_len], list(range(self.nc_len))

    def __len__(self) -> int:
        return max(self.c_len, self.nc_len)

    def __getitem__(self, item: int):
        return self.c_ds[self.c_order[item]], self.nc_ds[self.nc_order[item]]
