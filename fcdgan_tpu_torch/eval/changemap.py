"""Change maps of a detection against a reference.

Copies of the JAX package's ``eval/changemap.py`` writers:
``write_changemap`` (parity: reference CommonFunc.py:39-57), the WSSS slice
map, RGB-coded FN blue, FP red, TP white, or grey {0, 255}; and
``write_changemap_gdal`` (CommonFunc.py:59-75), a single band coded {0 TN,
1 FN, 2 FP, 3 TP}, with gt/prediction value indirection.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def write_changemap(change_mask: np.ndarray, ref_mask: np.ndarray,
                    write_color: bool = False) -> np.ndarray:
    """(H, W) binary masks -> (3, H, W) RGB codes or the (H, W) grey map."""
    if write_color:
        out = np.zeros((3, change_mask.shape[0], change_mask.shape[1]))
        out[2, (change_mask == 0) & (ref_mask == 1)] = 255  # missed: blue
        out[0, (change_mask == 1) & (ref_mask == 0)] = 255  # false: red
        out[:, (change_mask == 1) & (ref_mask == 1)] = 255  # true: white
        return out
    out = np.zeros((change_mask.shape[0], change_mask.shape[1]))
    out[change_mask == 1] = 255
    return out


def write_changemap_gdal(change_mask: np.ndarray, ref_mask: np.ndarray,
                         write_color: bool = False,
                         ref_map: Sequence[int] = (0, 1),
                         dt_map: Sequence[int] = (0, 1)) -> np.ndarray:
    """(1, H, W) coded masks -> (1, H, W) {0 TN, 1 FN, 2 FP, 3 TP} raster
    (``write_color=False``: the binary {0, 1} detection)."""
    out = np.zeros((1, change_mask.shape[1], change_mask.shape[2]))
    if write_color:
        out[0, (change_mask[0] == dt_map[0]) & (ref_mask[0] == ref_map[1])] = 1
        out[0, (change_mask[0] == dt_map[1]) & (ref_mask[0] == ref_map[0])] = 2
        out[0, (change_mask[0] == dt_map[1]) & (ref_mask[0] == ref_map[1])] = 3
    else:
        out[0, change_mask[0] == dt_map[1]] = 1
    return out
