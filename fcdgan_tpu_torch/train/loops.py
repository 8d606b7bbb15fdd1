"""Epoch-loop plumbing of the drivers (JAX ``train/loops.py``).

``EpochAverages`` keeps the weighted epoch averages of the per-batch metrics
(``aver += loss * bs / total``, e.g. Demo_USSS.py:161-165) as sums on the
device and reads them to the host once, when the epoch summary first asks
for a value: a ``float()`` per metric per batch would wait for the device
every step. PyTorch runs eagerly, so the JAX package's deferred
epoch-summary window (``DeferredEpochEnd``) has no counterpart here.
``Progress`` is the '\\r' ETA line (Demo_USSS.py:175-176) and
``accuracy_line`` the per-epoch accuracy print.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..eval.evaluator import Evaluator
from ..utils.timing import progress_line


class EpochAverages:
    """Weighted running averages of per-batch metrics, summed on the device.

    ``update`` adds ``metric * batch_weight / total`` to float64 sums (the
    confusion matrix to int64 counts) without a host sync; reading a value
    (``av[k]``, ``as_dict``, ``evaluator``) downloads the totals once."""

    def __init__(self, total_size: int):
        self.total = max(total_size, 1)
        self._dev: Dict[str, torch.Tensor] = {}
        self._host: Optional[Dict] = None

    def update(self, metrics: Dict[str, torch.Tensor], batch_weight_sum: float) -> None:
        scale = batch_weight_sum / self.total
        for k, v in metrics.items():
            v = v.detach()
            add = (v + 0.5).long() if k == "confusion" else v.double() * scale
            self._dev[k] = add if k not in self._dev else self._dev[k] + add
        self._host = None

    def _finalize(self) -> Dict:
        if self._host is None:
            self._host = {}
            for k, v in self._dev.items():
                v = v.cpu()
                self._host[k] = v.numpy() if k == "confusion" else float(v)
        return self._host

    @property
    def confusion(self):
        return self._finalize().get("confusion")

    def __getitem__(self, k: str) -> float:
        return self._finalize().get(k, 0.0)

    def as_dict(self) -> Dict[str, float]:
        return {k: v for k, v in self._finalize().items() if k != "confusion"}

    def evaluator(self, num_class: int = 2) -> Evaluator:
        ev = Evaluator(num_class)
        if self.confusion is not None:
            ev.add_confusion(self.confusion)
        return ev


class Progress:
    """Per-batch '\\r' progress/ETA line (format parity: Demo_USSS.py:175-176)."""

    def __init__(self, total_size: int, epochs_remaining_fn, enabled: bool = True):
        self.total = max(total_size, 1)
        self.enabled = enabled
        self.processed = 0
        self._epochs_remaining_fn = epochs_remaining_fn
        self._t0 = None

    def start_batch(self):
        self._t0 = time.time()

    def end_batch(self, batch_size: int):
        self.processed += batch_size
        if not self.enabled or self._t0 is None:
            return
        dt = time.time() - self._t0
        per_iter = dt / max(batch_size, 1) * self.total
        remaining = per_iter * (self._epochs_remaining_fn()
                                + (1 - self.processed / self.total))
        print(progress_line(self.processed, self.total, per_iter, remaining),
              end="", flush=True)

    def finish(self):
        if self.enabled:
            print("\r", end="", flush=True)


def accuracy_line(epoch: int, total_epochs: int, ev: Evaluator) -> str:
    miou, ciou = ev.Mean_Intersection_over_Union()
    return ("Epochs: {}/{}, Overall Accuracy: {:.4f}, Kappa: {:.4f}, "
            "Precision Rate: {:.4f}, Recall Rate: {:.4f}, F1:{:.4f}, "
            "mIOU:{:.4f}, cIoU:{:.4f}".format(
                epoch + 1, total_epochs, ev.Pixel_Accuracy(), ev.Pixel_Kappa(),
                ev.Pixel_Precision_Rate(), ev.Pixel_Recall_Rate(),
                ev.Pixel_F1_score(), miou, ciou))
