"""Per-band (x - mean) / std with separate stats per temporal image.

Copy of ``Normalize`` from the JAX package's ``data/normalize.py`` (parity:
NORMALIZE, reference CommonFunc.py:199-224); ``switch`` 1 selects image X,
2 image Y. Inputs/outputs are (h, w, nband) numpy arrays.
"""

from __future__ import annotations

import numpy as np


class Normalize:
    def __init__(self, meansX, stdX, meansY, stdY):
        self.meansX = [float(v) for v in meansX]
        self.stdX = [float(v) for v in stdX]
        self.meansY = [float(v) for v in meansY]
        self.stdY = [float(v) for v in stdY]

    def __call__(self, x: np.ndarray, switch: int = 1) -> np.ndarray:
        means = self.meansX if switch == 1 else self.meansY
        stds = self.stdX if switch == 1 else self.stdY
        if x.shape[-1] > len(means):
            raise ValueError(
                "The input channel doesn't match the stats list "
                f"(bands={x.shape[-1]}, stats={len(means)}, switch={switch})")
        m = np.array(means[: x.shape[-1]], x.dtype)
        s = np.array(stds[: x.shape[-1]], x.dtype)
        return (x - m) / s
