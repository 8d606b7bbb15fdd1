"""{TN, FN, FP, TP}-coded change map of a detection against a reference.

Copy of ``write_changemap_gdal`` from the JAX package's ``eval/changemap.py``
(parity: reference CommonFunc.py:59-75): a single band coded {0 TN, 1 FN,
2 FP, 3 TP}, with gt/prediction value indirection.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
