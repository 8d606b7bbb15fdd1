"""Run records: Para txt files and TensorBoard scalars.

Copy of the JAX package's ``io/records.py``: the ``Para_*.txt``
hyperparameter and metric record (Demo_USSS.py:485-501), the shared metrics
line, and a TensorBoard scalar writer that does nothing when
``tensorboardX`` is missing (records.py:50-75).
"""

from __future__ import annotations

import os
import time
from typing import Mapping, Optional


def segmentation_summary(acc) -> str:
    """The shared metrics line (format parity: Demo_USSS.py:494-498)."""
    miou, ciou = acc.Mean_Intersection_over_Union()
    return (
        "Overall Accuracy: {:.4f}, Kappa: {:.4f}, Precision Rate: {:.4f}, "
        "Recall Rate: {:.4f}, F1:{:.4f}, mIOU:{:.4f}, cIOU:{:.4f}".format(
            acc.Pixel_Accuracy(), acc.Pixel_Kappa(), acc.Pixel_Precision_Rate(),
            acc.Pixel_Recall_Rate(), acc.Pixel_F1_score(), miou, ciou))


def write_para_txt(path: str, hyperparams: Mapping[str, object], acc=None,
                   tips: str = "") -> str:
    """Write the Para txt record: ``key:value`` lines + final metrics + tips."""
    with open(path, "w") as f:
        for k, v in hyperparams.items():
            f.write("{}:{}\n".format(k, v))
        if acc is not None:
            f.write("Segmentation, " + segmentation_summary(acc) + "\n")
        f.write("tips:{}\n".format(tips))
    return path


def timestamped_para_path(out_dir: str, ext: str = "") -> str:
    """Para_{MonDDHHMM}{ext}.txt (parity: Demo_USSS.py:485)."""
    stamp = time.strftime("%b%d%H%M", time.localtime())
    return os.path.join(out_dir, "Para_{}{}.txt".format(stamp, ext))


class ScalarWriter:
    """TensorBoard scalar writer; silently no-ops without tensorboardX."""

    def __init__(self, comment: str = "", logdir: Optional[str] = None,
                 enabled: bool = True):
        self._w = None
        if not enabled:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._w = SummaryWriter(logdir=logdir, comment=comment)

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
