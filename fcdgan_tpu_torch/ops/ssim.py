"""SSIM and MS-SSIM of NHWC batches (parity: reference ssim.py, pytorch-msssim).

Copy of the JAX package's ``ops/ssim.py``: the 1-D Gaussian window built in
float64 then cast (:31-35); the depthwise VALID blur along H then W that
skips an axis shorter than the window (:38-61); the per-channel (ssim, cs)
means of ``_ssim_maps``; 5-scale MS-SSIM with a count-include-pad 2x2
average pool between levels, padded by the odd extent (:144-156, :194-196),
relu'd cs, the weighted product and the minimum-size ``ValueError``.

Each level whose H and W are at least the window runs through the fused
kernel wrapper ``ops.fused_ssim.ssim_level`` (the JAX package's own gate,
``use_pallas_ssim``'s H, W >= win_size). A smaller level takes the plain
composite below with the axis-skip rule, on any device. Tensors are NHWC
float32, as in the JAX package. The Gaussian window and the MS-SSIM level
weights are uploaded once per device and kept for good (``_window``,
``_level_weights``): a step captured in a CUDA graph may not copy from the
host, and reads their addresses for as long as it replays.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_DEFAULT_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def gaussian_window(win_size: int, sigma: float) -> np.ndarray:
    """Normalised 1-D Gaussian (parity: ssim.py:9-23)."""
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.cache
def _window(win_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """``gaussian_window(win_size, sigma)`` on ``device``, made once and kept."""
    return torch.from_numpy(gaussian_window(win_size, sigma)).to(device)


@functools.cache
def _level_weights(weights: Tuple[float, ...], dtype: torch.dtype, device: torch.device
                   ) -> torch.Tensor:
    """The MS-SSIM level weights on ``device``, made once and kept."""
    return torch.tensor(weights, dtype=dtype, device=device)


def gaussian_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise VALID blur of NHWC ``x``, along H then W; an axis
    shorter than the window is skipped (ssim.py:44-51)."""
    c = x.shape[-1]
    k = win.shape[0]
    h = x.permute(0, 3, 1, 2)
    if h.shape[2] >= k:
        h = F.conv2d(h, win.to(h.dtype).view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    if h.shape[3] >= k:
        h = F.conv2d(h, win.to(h.dtype).view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return h.permute(0, 2, 3, 1)


def _ssim_maps(x: torch.Tensor, y: torch.Tensor, data_range: float,
               win: torch.Tensor, k: Tuple[float, float] = (0.01, 0.03)
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel means (ssim, cs) over the valid map, two (N, C) tensors
    (parity: ssim.py:55-92)."""
    k1, k2 = k
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = gaussian_filter(x, win)
    mu2 = gaussian_filter(y, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = gaussian_filter(x * x, win) - mu1_sq
    sigma2_sq = gaussian_filter(y * y, win) - mu2_sq
    sigma12 = gaussian_filter(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2)), cs_map.mean(dim=(1, 2))


def _ssim_level(x, y, data_range, win_size, win_sigma, k):
    """One level: the fused kernel wrapper where H, W >= win_size, else the
    plain composite with the axis-skip rule."""
    if x.shape[1] >= win_size and x.shape[2] >= win_size:
        from .fused_ssim import ssim_level

        return ssim_level(x, y, float(data_range), win_size, win_sigma, k[0], k[1])
    win = _window(win_size, float(win_sigma), x.device)
    return _ssim_maps(x, y, data_range, win, k)


def _check(x: torch.Tensor, y: torch.Tensor, win_size: int) -> None:
    if x.shape != y.shape:
        raise ValueError("Input images should have the same dimensions.")
    if win_size % 2 != 1:
        raise ValueError("Window size should be odd.")


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
         size_average: bool = True, win_size: int = 11, win_sigma: float = 1.5,
         k: Tuple[float, float] = (0.01, 0.03), nonnegative_ssim: bool = False
         ) -> torch.Tensor:
    """Single-scale SSIM of NHWC batches (parity: ssim.py:95-150)."""
    _check(x, y, win_size)
    ssim_pc, _ = _ssim_level(x, y, data_range, win_size, win_sigma, k)
    if nonnegative_ssim:
        ssim_pc = torch.relu(ssim_pc)
    return ssim_pc.mean() if size_average else ssim_pc.mean(dim=1)


def _avg_pool2_count_include_pad(x: torch.Tensor, pad_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``avg_pool2d(kernel=2, padding=p)`` of NHWC ``x``, padded zeros
    counted (ssim.py:214-216)."""
    h = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, padding=pad_hw, count_include_pad=True)
    return h.permute(0, 2, 3, 1).contiguous()


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
            size_average: bool = True, win_size: int = 11, win_sigma: float = 1.5,
            weights: Optional[Sequence[float]] = None,
            k: Tuple[float, float] = (0.01, 0.03)) -> torch.Tensor:
    """Multi-scale SSIM of NHWC batches (parity: ssim.py:153-225)."""
    _check(x, y, win_size)
    if weights is None:
        weights = _DEFAULT_WEIGHTS
    levels = len(weights)
    smaller_side = min(x.shape[1], x.shape[2])
    min_side = (win_size - 1) * 2 ** (levels - 1)
    if smaller_side <= min_side:
        raise ValueError("Image size should be larger than %d due to the %d "
                         "downsamplings in ms-ssim" % (min_side, levels - 1))
    w = _level_weights(tuple(float(v) for v in weights), x.dtype, x.device).view(-1, 1, 1)
    mcs = []
    ssim_pc = None
    for i in range(levels):
        ssim_pc, cs_pc = _ssim_level(x, y, data_range, win_size, win_sigma, k)
        if i < levels - 1:
            mcs.append(torch.relu(cs_pc))
            pad = (x.shape[1] % 2, x.shape[2] % 2)
            x = _avg_pool2_count_include_pad(x, pad)
            y = _avg_pool2_count_include_pad(y, pad)
    stacked = torch.stack(mcs + [torch.relu(ssim_pc)], dim=0)  # (levels, N, C)
    val = torch.prod(stacked ** w, dim=0)
    return val.mean() if size_average else val.mean(dim=1)
