"""The reference's stitched scene density (Demo_USSS.py:404-473,
data_utils.py:154-236): every tile of the overlap-padded grid through the
eval-mode Segmentor, each tile's core written into the scene's density."""

from __future__ import annotations

import numpy as np
import torch

from . import strict_fp32
from .data import Tiles, meanstd, nchw, normalize


@torch.no_grad()
def density(S, x_raw: np.ndarray, y_raw: np.ndarray, patch: int, pad: int, device,
            block: int = 8) -> np.ndarray:
    """The (H, W) float32 density of a raw (H, W, C) scene pair, tiles run
    ``block`` at a time."""
    strict_fp32()
    S.eval()
    mx, sx, my, sy = meanstd([x_raw], [y_raw])
    xn, yn = normalize(x_raw, mx, sx), normalize(y_raw, my, sy)
    h, w = x_raw.shape[:2]
    grid = Tiles(h, w, patch, pad)
    out = np.zeros((h, w), np.float32)
    items = list(range(len(grid)))
    for i in range(0, len(items), block):
        ids = items[i:i + block]
        bx = nchw(np.stack([grid.canvas(xn, k) for k in ids])).to(device)
        by = nchw(np.stack([grid.canvas(yn, k) for k in ids])).to(device)
        d = S(bx, by)[:, 0].float().cpu().numpy()
        for j, k in enumerate(ids):
            y0, y1, x0, x1 = grid.core(k)
            out[y0:y1, x0:x1] = d[j, pad:pad + y1 - y0, pad:pad + x1 - x0]
    return out
