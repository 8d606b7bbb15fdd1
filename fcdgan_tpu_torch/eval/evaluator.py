"""Confusion-matrix metrics on the host and on the device.

Copy of the JAX package's ``eval/evaluator.py`` (parity: reference
metrics.py:6-85), trimmed to what serving and USSS training report.
``add_batch_map`` carries the value indirection of the USSS references,
coded {1 unchanged, 2 changed} against {0, 1} predictions (metrics.py:67-72;
Demo_USSS.py:64-65). ``confusion_update`` is the on-device counterpart
(evaluator.py:109-135): the (C, C) matrix of one batch, so the train steps
add it up on the device and the host reads it once per epoch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Evaluator:
    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), dtype=np.float64)

    def Pixel_Accuracy(self) -> float:
        return np.diag(self.confusion_matrix).sum() / self.confusion_matrix.sum()

    def Pixel_Kappa(self) -> float:
        po = self.Pixel_Accuracy()
        cm = self.confusion_matrix
        pe = np.dot(cm.sum(axis=0), cm.sum(axis=1)) / np.square(cm.sum())
        return (po - pe) / (1 - pe)

    def Pixel_Precision_Rate(self) -> float:
        cm = self.confusion_matrix
        return cm[1, 1] / (cm[0, 1] + cm[1, 1])

    def Pixel_Recall_Rate(self) -> float:
        cm = self.confusion_matrix
        return cm[1, 1] / (cm[1, 0] + cm[1, 1])

    def Pixel_F1_score(self) -> float:
        rec = self.Pixel_Recall_Rate()
        pre = self.Pixel_Precision_Rate()
        return 2 * rec * pre / (rec + pre)

    def Mean_Intersection_over_Union(self) -> Tuple[float, float]:
        cm = self.confusion_matrix
        iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float(np.nanmean(iou)), float(iou[1])

    def add_batch_map(self, gt: np.ndarray, pre: np.ndarray,
                      gt_map: Sequence = (0, 1), pre_map: Sequence = (0, 1)) -> None:
        if gt.shape != pre.shape:
            raise ValueError(f"gt {gt.shape} and prediction {pre.shape} differ")
        if not len(gt_map) == len(pre_map) == self.num_class:
            raise ValueError("gt_map and pre_map need one code per class")
        for i, gv in enumerate(gt_map):
            for j, pv in enumerate(pre_map):
                self.confusion_matrix[i, j] += np.sum((gt == gv) & (pre == pv))

    def add_confusion(self, cm) -> None:
        """Merge an externally accumulated (C, C) matrix (device epoch totals)."""
        self.confusion_matrix += np.asarray(cm, dtype=np.float64)


def confusion_update(gt: torch.Tensor, pre: torch.Tensor, gt_map: Sequence[float],
                     pre_map: Sequence[float], valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(C, C) float32 confusion matrix of one batch, on ``gt``'s device:
    row i counts ``gt == gt_map[i]``, column j ``pre == pre_map[j]``, each
    position weighted by ``valid`` (a same-shape {0, 1} mask) when given."""
    if len(gt_map) != len(pre_map):
        raise ValueError("gt_map and pre_map need one code per class")
    gt = gt.reshape(-1)
    pre = pre.reshape(-1)
    w = torch.ones_like(gt, dtype=torch.float32) if valid is None else \
        valid.reshape(-1).to(torch.float32)
    rows = torch.stack([(gt == g).to(torch.float32) for g in gt_map])
    cols = torch.stack([(pre == p).to(torch.float32) for p in pre_map])
    return torch.einsum("in,jn,n->ij", rows, cols, w)
