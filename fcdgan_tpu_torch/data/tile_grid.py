"""Overlap-padded tile grid over a large scene: pure index arithmetic.

Copy of the JAX package's ``data/tile_grid.py``, trimmed to what scene
serving and the RSSS scene lists use. Conventions (identical to the reference, data_utils.py:57-63,
91-97, 154-176):

  * the scene of size (xsize, ysize) is covered by core tiles of stride
    ``patch - 2*pad`` along each axis; the last tile is truncated at the
    scene border,
  * each read window extends the core tile by ``pad`` on every side, clamped
    to the scene,
  * every tile is materialised into a fixed ``patch``-sized zero canvas at a
    write offset so that the core interior always lives at
    ``canvas[pad : pad + core_h, pad : pad + core_w]``,
  * item index decomposes as ``item_x = item // ny``, ``item_y = item % ny``.

Coordinates are (x, y, w, h) tuples like the reference; array shapes are
row-major (y, x).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

Slice4 = Tuple[int, int, int, int]  # (x, y, w, h)


def _starts_ends(size: int, patch: int, pad: int) -> Tuple[List[int], List[int]]:
    """Grid starts/ends along one axis (parity: data_utils.py:57-63)."""
    stride = patch - 2 * pad
    if stride <= 0:
        raise ValueError(f"patch {patch} must exceed 2*pad {2 * pad}")
    starts = list(range(0, size, stride))
    ends = [s + stride for s in starts if s + stride < size]
    ends.append(size)
    return starts, ends


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Fixed-shape overlap-padded tiling of a (xsize, ysize) scene."""

    xsize: int
    ysize: int
    patch_size: Tuple[int, int] = (200, 200)  # (px, py)
    overlap_padding: Tuple[int, int] = (10, 10)  # (pad_x, pad_y)

    def __post_init__(self):
        xs, xe = _starts_ends(self.xsize, self.patch_size[0], self.overlap_padding[0])
        ys, ye = _starts_ends(self.ysize, self.patch_size[1], self.overlap_padding[1])
        object.__setattr__(self, "_xstart", xs)
        object.__setattr__(self, "_xend", xe)
        object.__setattr__(self, "_ystart", ys)
        object.__setattr__(self, "_yend", ye)

    def __len__(self) -> int:
        return len(self._xstart) * len(self._ystart)

    @property
    def patch_count(self) -> Tuple[int, int]:
        """(nx, ny) tiles along each axis."""
        return len(self._xstart), len(self._ystart)

    @property
    def ystarts(self) -> List[int]:
        """The core tiles' first rows, which are also their canvas origins'
        rows in the padded scene (the slab keys of the window cache)."""
        return list(self._ystart)

    def decompose(self, item: int) -> Tuple[int, int]:
        """item -> (item_x, item_y) (parity: data_utils.py:94-95)."""
        ny = len(self._ystart)
        return item // ny, item % ny

    def slices(self, item: int) -> Tuple[Slice4, Slice4, Slice4]:
        """(core, read-window, canvas-write-offset) of one tile.

        Parity with data_utils.py:154-176 including the border behaviour:
        the write offset is ``pad`` exactly when the padded read window was
        clamped at the low edge (``start - pad <= 0``)."""
        item_x, item_y = self.decompose(item)
        padx, pady = self.overlap_padding
        xs, xe = self._xstart[item_x], self._xend[item_x]
        ys, ye = self._ystart[item_y], self._yend[item_y]
        core = (xs, ys, xe - xs, ye - ys)
        x_ori = 0 if xs - padx > 0 else padx
        y_ori = 0 if ys - pady > 0 else pady
        rxs = xs - padx if xs - padx > 0 else 0
        rys = ys - pady if ys - pady > 0 else 0
        rxe = xe + padx if xe + padx < self.xsize else self.xsize
        rye = ye + pady if ye + pady < self.ysize else self.ysize
        read = (rxs, rys, rxe - rxs, rye - rys)
        write = (x_ori, y_ori, rxe - rxs, rye - rys)
        return core, read, write

    def interior(self, item: int) -> Tuple[int, int, int, int]:
        """(y0, y1, x0, x1) of the tile's core inside its canvas, the
        stitched region (parity: OSCD ``EffRange``, data_utils.py:390-405)."""
        padx, pady = self.overlap_padding
        core, _, _ = self.slices(item)
        return pady, pady + core[3], padx, padx + core[2]

    def interior_sizes(self) -> np.ndarray:
        """(n_tiles, 2) int32 (core_h, core_w) of every item: each tile's
        interior is ``canvas[pad_y : pad_y + core_h, pad_x : pad_x + core_w]``,
        so the train steps build its mask on the device from these sizes."""
        return np.array([(s[3], s[2]) for s in (self.slices(i)[0] for i in range(len(self)))],
                        np.int32).reshape(-1, 2)

    def canvas_shape(self) -> Tuple[int, int]:
        """(height, width) of the fixed zero-padded tile canvas."""
        return self.patch_size[1], self.patch_size[0]

    def write_windows(self) -> np.ndarray:
        """(n_tiles, 4) int32 canvas write windows (x0, y0, w, h)."""
        return np.array([self.slices(i)[2] for i in range(len(self))],
                        np.int32).reshape(-1, 4)

    def canvas_origins(self) -> np.ndarray:
        """(n_tiles, 2) int32 (row, col) origins into the zero-padded scene
        of :meth:`padded_shape`: every tile's canvas is exactly
        ``padded[row : row + patch_h, col : col + patch_w]``, which lets the
        tiles be gathered on the device from a resident scene."""
        out = np.zeros((len(self), 2), np.int32)
        for item in range(len(self)):
            ix, iy = self.decompose(item)
            out[item] = (self._ystart[iy], self._xstart[ix])
        return out

    def padded_shape(self) -> Tuple[int, int]:
        """(height, width) of the zero-padded scene for canvas_origins():
        top/left pad = overlap_padding, extent covering the last tile."""
        return (self._ystart[-1] + self.patch_size[1],
                self._xstart[-1] + self.patch_size[0])
