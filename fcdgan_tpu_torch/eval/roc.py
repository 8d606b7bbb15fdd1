"""ROC / AUC over change-density maps from threshold histograms.

Copy of ``RocCurve`` from the JAX package's ``eval/roc.py`` (numpy path
only): densities are bucketed into K bins, positive/negative counts
accumulate per bin, and the curve / AUC come from the cumulative counts.
Exact for densities quantized to the bin resolution; K=1024 gives about
1e-3 AUC resolution.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class RocCurve:
    def __init__(self, n_bins: int = 1024):
        self.n_bins = n_bins
        self.hist = np.zeros((2, n_bins), np.float64)

    def add_batch(self, density: np.ndarray, gt_positive: np.ndarray) -> None:
        d = np.clip(np.asarray(density).reshape(-1), 0.0, 1.0)
        pos = np.asarray(gt_positive).reshape(-1).astype(bool)
        idx = np.minimum((d * self.n_bins).astype(np.int64), self.n_bins - 1)
        self.hist[1] += np.bincount(idx[pos], minlength=self.n_bins)
        self.hist[0] += np.bincount(idx[~pos], minlength=self.n_bins)

    def curve(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(fpr, tpr, thresholds), thresholds descending from 1 to 0."""
        neg, pos = self.hist[0], self.hist[1]
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        p = max(pos.sum(), 1e-12)
        n = max(neg.sum(), 1e-12)
        tpr = np.concatenate([[0.0], tp / p])
        fpr = np.concatenate([[0.0], fp / n])
        thresholds = np.concatenate([[1.0], np.arange(self.n_bins)[::-1] / self.n_bins])
        return fpr, tpr, thresholds

    def auc(self) -> float:
        fpr, tpr, _ = self.curve()
        return float(np.trapezoid(tpr, fpr))
