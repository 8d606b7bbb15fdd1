"""The reference's data preparation from raw rasters (data_utils.py,
CommonFunc.py:199-224, 373-500): per-band statistics, normalization, and the
overlap-padded tile canvases.

Statistics: over every pixel whose band sum in image X is not zero, the
pixel-weighted mean and the (n - 1) standard deviation of each band of each
date. A tile: the core of stride ``patch - 2 * pad``, read with ``pad`` more
on each side clamped to the scene, normalized, and written into a zero
canvas of ``patch`` at the offset that keeps the core at ``pad``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def meanstd(xs: List[np.ndarray], ys: List[np.ndarray]) -> Tuple[np.ndarray, ...]:
    """(mean_x, std_x, mean_y, std_y) float64 over (H, W, C) rasters."""
    valid = [x.sum(axis=-1, dtype=np.float64) != 0 for x in xs]
    n = sum(int(v.sum()) for v in valid)
    out = []
    for imgs in (xs, ys):
        mean = sum(img[v].sum(axis=0, dtype=np.float64) for img, v in zip(imgs, valid)) / n
        var = sum(((img[v].astype(np.float64) - mean) ** 2).sum(axis=0)
                  for img, v in zip(imgs, valid)) / (n - 1)
        out += [mean, np.sqrt(var)]
    return tuple(out)


def _starts_ends(size: int, patch: int, pad: int):
    stride = patch - 2 * pad
    starts = list(range(0, size, stride))
    ends = [s + stride for s in starts if s + stride < size] + [size]
    return starts, ends


class Tiles:
    """The tile grid of an (H, W) scene: item = ix * ny + iy."""

    def __init__(self, h: int, w: int, patch: int, pad: int):
        self.h, self.w, self.patch, self.pad = h, w, patch, pad
        self.xs, self.xe = _starts_ends(w, patch, pad)
        self.ys, self.ye = _starts_ends(h, patch, pad)

    def __len__(self) -> int:
        return len(self.xs) * len(self.ys)

    def core(self, item: int) -> Tuple[int, int, int, int]:
        """(y0, y1, x0, x1) of the tile's core in the scene."""
        ix, iy = divmod(item, len(self.ys))
        return self.ys[iy], self.ye[iy], self.xs[ix], self.xe[ix]

    def canvas(self, img: np.ndarray, item: int) -> np.ndarray:
        """The (patch, patch, C) float64 canvas of ``img`` (already
        normalized) for ``item``."""
        y0, y1, x0, x1 = self.core(item)
        p = self.pad
        ry0, rx0 = max(y0 - p, 0), max(x0 - p, 0)
        ry1, rx1 = min(y1 + p, self.h), min(x1 + p, self.w)
        oy = 0 if y0 - p > 0 else p
        ox = 0 if x0 - p > 0 else p
        out = np.zeros((self.patch, self.patch, img.shape[-1]), np.float64)
        out[oy:oy + ry1 - ry0, ox:ox + rx1 - rx0] = img[ry0:ry1, rx0:rx1]
        return out


def normalize(img: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (img.astype(np.float64) - mean) / std


def nchw(a: np.ndarray):
    """(B, H, W, C) numpy -> (B, C, H, W) float32 tensor."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2), np.float32))
