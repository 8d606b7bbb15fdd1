"""The reference's loss stacks on NCHW float32 tensors (Loss.py:17-124,
ssim.py), with sample weights as the reference divides by the batch.

``cnet_loss`` (USSS) and ``cgenerator_loss`` (WSSS) mask both images by
``1 - cmap``, rescale the per-sample reconstruction by ``pixels / unmasked
pixels``, and add the frozen-VGG perception MSE (per band, or RGB) and the
MS-SSIM loss (5 scales, Gaussian window 11, sigma 1.5, count-include-pad
2x2 average pooling between scales, as pytorch-msssim).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .models import VGG16

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    c = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(c ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    c, k = x.shape[1], win.numel()
    if x.shape[2] >= k:
        x = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    if x.shape[3] >= k:
        x = F.conv2d(x, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return x


def _ssim_cs(x, y, win, data_range=1.0, k=(0.01, 0.03)):
    """Per-channel means (N, C) of the SSIM and contrast-structure maps."""
    c1, c2 = (k[0] * data_range) ** 2, (k[1] * data_range) ** 2
    mu1, mu2 = _blur(x, win), _blur(y, win)
    s1 = _blur(x * x, win) - mu1 * mu1
    s2 = _blur(y * y, win) - mu2 * mu2
    s12 = _blur(x * y, win) - mu1 * mu2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    ssim = ((2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)) * cs
    return ssim.mean(dim=(2, 3)), cs.mean(dim=(2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor,
            weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Per-sample MS-SSIM (N,) of NCHW images with data range 1."""
    weights = MSSSIM_WEIGHTS if weights is None else tuple(weights)
    win = torch.from_numpy(_window()).to(x.device)
    mcs = []
    for i in range(len(weights)):
        ssim, cs = _ssim_cs(x, y, win)
        if i < len(weights) - 1:
            mcs.append(F.relu(cs))
            pad = (x.shape[2] % 2, x.shape[3] % 2)
            x = F.avg_pool2d(x, 2, padding=pad, count_include_pad=True)
            y = F.avg_pool2d(y, 2, padding=pad, count_include_pad=True)
    stacked = torch.stack(mcs + [F.relu(ssim)], dim=0)
    w = torch.tensor(weights, dtype=x.dtype, device=x.device).view(-1, 1, 1)
    return torch.prod(stacked ** w, dim=0).mean(dim=1)


def _wsum(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (v * w).sum() / torch.clamp(w.sum(), min=1.0)


def perception_loss(target, generated, mask, vgg: VGG16, tap: int, per_band: bool, w):
    """Frozen-VGG MSE over the unmasked images (Loss.py:17-61): every band
    as its own plane averaged over bands, or the first three bands as RGB;
    one pass over the stacked [target; generated]."""
    keep = 1.0 - mask
    if per_band:
        b, c = target.shape[:2]
        x = (target * keep).transpose(0, 1).reshape(b * c, 1, *target.shape[2:])
        y = (generated * keep).transpose(0, 1).reshape(b * c, 1, *target.shape[2:])
        n_rep = c
    else:
        x, y, n_rep = target[:, :3] * keep, generated[:, :3] * keep, 1
    n = x.shape[0]
    f = vgg.features(torch.cat([x, y], dim=0), tap)
    per = ((f[:n] - f[n:]) ** 2).mean(dim=(1, 2, 3)).reshape(n_rep, -1).mean(dim=0)
    return _wsum(per, w)


def _recon(target, generated, cmap, kind):
    npix = target.shape[2] * target.shape[3]
    unmasked = (1.0 - cmap).sum(dim=(1, 2, 3))
    tm, gm = target * (1.0 - cmap), generated * (1.0 - cmap)
    d = tm - gm
    per = (d.abs() if kind == "l1" else d.square()).mean(dim=(1, 2, 3))
    per = per * npix / torch.where(unmasked > 0, unmasked, torch.ones_like(unmasked))
    return per, unmasked, tm, gm


def _ssim_loss(tm, gm, w, msssim_weights):
    with torch.no_grad():  # weighted 0 in every reference demo: a metric
        return 1.0 - _wsum(ms_ssim(tm, gm, msssim_weights), w)


def cnet_loss(target, generated, cmap, vgg, tap, w, msssim_weights=None):
    """USSS (generator, l1, perception, ssim) (Loss.py:64-95)."""
    per, _, tm, gm = _recon(target, generated, cmap, "l1")
    gen = _wsum(per, w)
    l1 = _wsum(cmap.abs().mean(dim=(1, 2, 3)), w)
    perc = perception_loss(target, generated, cmap, vgg, tap, True, w)
    return gen, l1, perc, _ssim_loss(tm, gm, w, msssim_weights)


def cgenerator_loss(target, generated, cmap, vgg, tap, w, msssim_weights=None):
    """WSSS (generator, ssim, perception) (Loss.py:100-124): MSE, a sample
    masked whole is skipped."""
    per, unmasked, tm, gm = _recon(target, generated, cmap, "mse")
    gen = _wsum(per * (unmasked > 0).to(per.dtype), w)
    perc = perception_loss(target, generated, cmap, vgg, tap, False, w)
    return gen, _ssim_loss(tm, gm, w, msssim_weights), perc
