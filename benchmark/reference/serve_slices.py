"""The reference's final inference over WHU slices (Demo_WSSS.py:387-445):
the Segmentor in train mode ("train mode gets better performance",
:389-391), each batch normalized with its own statistics, batch after batch
in the order given, float32 without TF32."""

from __future__ import annotations

import numpy as np
import torch

from . import strict_fp32
from .data import meanstd, nchw, normalize


@torch.no_grad()
def densities(S, x_raw: np.ndarray, y_raw: np.ndarray, batch: int, device) -> np.ndarray:
    """The (N, H, W) float32 densities of the raw (N, H, W, C) slice pairs,
    normalized by the statistics of all N, ``batch`` pairs a forward."""
    strict_fp32()
    S.train()
    mx, sx, my, sy = meanstd(list(x_raw), list(y_raw))
    out = np.zeros(x_raw.shape[:3], np.float32)
    for i in range(0, len(x_raw), batch):
        bx = nchw(normalize(x_raw[i:i + batch], mx, sx)).to(device)
        by = nchw(normalize(y_raw[i:i + batch], my, sy)).to(device)
        out[i:i + batch] = S(bx, by)[:, 0].float().cpu().numpy()
    return out
