"""Overlap-tiled bi-temporal scene pair with a stitched output raster.

Copy of ``ScenePairDataset`` from the JAX package's ``data/datasets.py``
(parity: GDALDataset, reference data_utils.py:28-236), trimmed to what scene
serving uses: numpy (h, w, nband) float32 tiles for the statistics pass, and
the whole-scene density write of the fused serving path. Normalisation
(``enhance``) applies to the raw read window *before* zero padding, exactly
like the reference (data_utils.py:110-120), so the canvas padding stays zero.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .raster import create_raster, open_raster
from .tile_grid import TileGrid


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

    def write_full(self, density: np.ndarray):
        """Write the whole stitched (ysize, xsize) density raster in one call,
        with the geo metadata copied from image X (data_utils.py:190-198)."""
        if self._out is None:
            if self.out_path is None:
                raise ValueError("ScenePairDataset was built without an out_path")
            xs, ys, _ = self.size()
            self._out = create_raster(self.out_path, xs, ys, 1, np.float32,
                                      like=self.raster_x)
        d = density[..., 0] if density.ndim == 3 else density
        self._out.write_block(d.astype(np.float32), 0, 0, band=0)

    def close_outputs(self):
        if self._out is not None:
            self._out.close()
            self._out = None
