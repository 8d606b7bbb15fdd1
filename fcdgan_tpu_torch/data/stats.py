"""Dataset mean/std with resumable txt caches.

Copy of the JAX package's ``data/stats.py`` trimmed to ``dataset_meanstd``
(parity: Dataset_meanstd, reference CommonFunc.py:373-500): per-band
statistics over a bi-temporal dataset's tiles, ignoring pixels whose band
sum is zero, pixel-count weighted, with an (n-1) variance denominator. The
caches use the reference's text format (``mean: a b c`` / ``std: a b c``),
so a pair prepared by either package serves unchanged in the other.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def _write_two_rows(path: str, name_a: str, row_a: Sequence[float],
                    name_b: str, row_b: Sequence[float]) -> None:
    with open(path, "w") as f:
        f.write(name_a + ":")
        for v in row_a:
            f.write(" {}".format(v))
        f.write("\n")
        f.write(name_b + ":")
        for v in row_b:
            f.write(" {}".format(v))
        f.write("\n")


def _read_two_rows(path: str) -> Tuple[List[float], List[float]]:
    with open(path, "r") as f:
        contents = f.readlines()
    a = [float(x) for x in contents[0].split()[1:]]
    b = [float(x) for x in contents[1].split()[1:]]
    return a, b


def _tiles(dataset):
    for i in range(len(dataset)):
        item = dataset[i]
        x = np.asarray(item[0], np.float64)
        y = np.asarray(item[1], np.float64)
        idx = x.sum(axis=-1) != 0  # valid pixels (CommonFunc.py:446)
        yield x[idx], y[idx]


def dataset_mean(dataset) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-count-weighted per-band means (parity: CommonFunc.py:436-465)."""
    sums_x = sums_y = None
    npix = 0
    for xv, yv in _tiles(dataset):
        if sums_x is None:
            sums_x = np.zeros(xv.shape[-1])
            sums_y = np.zeros(yv.shape[-1])
        sums_x += xv.sum(axis=0)
        sums_y += yv.sum(axis=0)
        npix += len(xv)
    return sums_x / npix, sums_y / npix


def dataset_std(dataset, mean_x: np.ndarray, mean_y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted per-band stds, (n-1) denominator (CommonFunc.py:467-500)."""
    var_x = np.zeros_like(mean_x)
    var_y = np.zeros_like(mean_y)
    npix = 0
    for xv, yv in _tiles(dataset):
        var_x += ((xv - mean_x) ** 2).sum(axis=0)
        var_y += ((yv - mean_y) ** 2).sum(axis=0)
        npix += len(xv)
    return np.sqrt(var_x / (npix - 1)), np.sqrt(var_y / (npix - 1))


def dataset_meanstd(txt_path1: str, txt_path2: str, dataset):
    """Cached (meanX, stdX, meanY, stdY) float lists of a bi-temporal dataset."""
    if not (os.path.exists(txt_path1) and os.path.exists(txt_path2)):
        mean_x, mean_y = dataset_mean(dataset)
        std_x, std_y = dataset_std(dataset, mean_x, mean_y)
        _write_two_rows(txt_path1, "mean", mean_x.tolist(), "std", std_x.tolist())
        _write_two_rows(txt_path2, "mean", mean_y.tolist(), "std", std_y.tolist())
        return mean_x.tolist(), std_x.tolist(), mean_y.tolist(), std_y.tolist()
    mean_x, std_x = _read_two_rows(txt_path1)
    mean_y, std_y = _read_two_rows(txt_path2)
    return mean_x, std_x, mean_y, std_y
