"""Random-erase augmentation with the two-image sync protocol.

A copy of the JAX package's ``data/erasers.py`` (numpy only), so the same
``np.random.Generator`` seed draws the same rectangles in both packages.
Parity with the reference's RANDOM_ERASER / RANDOM_ERASER_MULTI_REGION
(CommonFunc.py:78-141): zero a random rectangle (or 1..N rectangles) capped
at ``erase_thresh`` of the image, and return the region(s) so the **same**
mask can be re-applied to the second temporal image, the sync'd transform
call pattern of data_utils.py:126-128.

Tiles are (h, w, nband); regions are (x, y, w, h) like the reference."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

Region = Tuple[int, int, int, int]


class RandomEraser:
    """Single random rectangle (parity: CommonFunc.py:78-105)."""

    def __init__(self, erase_thresh: float = 0.3, origin_prob: float = 0.5,
                 rng: Optional[np.random.Generator] = None):
        self.erase_thresh = erase_thresh
        self.origin_prob = origin_prob
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray, region: Optional[Region] = None):
        if region is not None:
            x, y, w, h = region
            img = img.copy()
            img[y : y + h, x : x + w, :] = 0
            return img, region
        if self.rng.random() > self.origin_prob:
            ysize, xsize = img.shape[:2]
            x = int(self.rng.integers(0, xsize))
            y = int(self.rng.integers(0, ysize))
            w = int(self.rng.integers(1, xsize - x + 1))
            h = int(self.rng.integers(1, ysize - y + 1))
            if (w * h) / (xsize * ysize) > self.erase_thresh:
                h = math.floor(xsize * ysize * self.erase_thresh / w)
            region = (x, y, w, h)
            img = img.copy()
            img[y : y + h, x : x + w, :] = 0
        else:
            region = (0, 0, 0, 0)
        return img, region


class RandomEraserMultiRegion:
    """1..multi_region random rectangles (parity: CommonFunc.py:108-141)."""

    def __init__(self, erase_thresh: float = 0.3, origin_prob: float = 0.2,
                 multi_region: int = 5, rng: Optional[np.random.Generator] = None):
        self.erase_thresh = erase_thresh
        self.origin_prob = origin_prob
        self.multi_region = max(1, multi_region)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray, region: Optional[Sequence[Region]] = None):
        if region is not None:
            img = img.copy()
            for x, y, w, h in region:
                img[y : y + h, x : x + w, :] = 0
            return img, region
        regions: List[Region] = []
        ysize, xsize = img.shape[:2]
        if self.rng.random() > self.origin_prob:
            img = img.copy()
            for _ in range(int(self.rng.integers(1, self.multi_region + 1))):
                x = int(self.rng.integers(0, xsize))
                y = int(self.rng.integers(0, ysize))
                w = int(self.rng.integers(1, xsize - x + 1))
                h = int(self.rng.integers(1, ysize - y + 1))
                if (w * h) / (xsize * ysize) > self.erase_thresh:
                    h = math.floor(xsize * ysize * self.erase_thresh / w)
                img[y : y + h, x : x + w, :] = 0
                regions.append((x, y, w, h))
        return img, regions


def build_eraser(enabled: bool, regions: int = 1, erase_thresh: float = 0.3,
                 seed: Optional[int] = None):
    """Config-driven eraser factory for the drivers.

    ``regions <= 1`` builds :class:`RandomEraser` (the reference's commented
    wiring at Demo_RSSS.py:96); ``regions > 1`` builds
    :class:`RandomEraserMultiRegion` with that region cap (Demo_RSSS.py:128).
    Returns ``None`` when disabled so callers can pass it straight as the
    dataset ``transforms=``."""
    if not enabled:
        return None
    rng = np.random.default_rng(seed)
    if regions > 1:
        return RandomEraserMultiRegion(erase_thresh=erase_thresh,
                                       multi_region=regions, rng=rng)
    return RandomEraser(erase_thresh=erase_thresh, rng=rng)
