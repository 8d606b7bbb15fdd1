"""The USSS, WSSS and RSSS loss stacks over NHWC batches (parity: reference Loss.py:17-141).

Counterparts of the JAX package's ``ops/losses.py`` ``hard_mask``,
``perception_loss``, ``cnet_loss`` (USSS), ``cgenerator_loss`` (WSSS and
RSSS) and ``region_loss`` (RSSS). Every function takes an
optional ``sample_weight`` (B,): weighted terms divide by its sum, as the
reference divides by the batch size. ``cmap`` is the (B, H, W, 1) soft
change density; images are masked by ``1 - cmap`` broadcast over bands, and
per-sample reconstruction losses are rescaled by ``num_pixel / num_wnc``
(Loss.py:81-84). Everything runs in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models.vgg import VGG16Weights, vgg16_features
from . import ssim as ssim_mod


def _weights(x: torch.Tensor, sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    return sample_weight.to(x.dtype)


def hard_mask(cmap: torch.Tensor) -> torch.Tensor:
    """cmask = (sign(cmap - 0.5) + 1) / 2 (parity: Loss.py:75)."""
    return (torch.sign(cmap - 0.5) + 1.0) / 2.0


def perception_loss(target: torch.Tensor, generated: torch.Tensor, cmask: torch.Tensor,
                    vgg: VGG16Weights, feature_layers: Sequence[int] = (29,),
                    per_band: bool = False, sample_weight: Optional[torch.Tensor] = None,
                    dtype: Optional[torch.dtype] = None, target_grad: bool = True
                    ) -> torch.Tensor:
    """Frozen-VGG16 MSE over unchanged pixels (parity: Loss.py:17-61).

    RGB mode uses the first three bands; per-band mode feeds every band as a
    1-channel plane, stacked on the batch axis, and averages over bands.
    ``target_grad=False`` (G pretrain, where target and mask are data) runs
    the target branch as its own pass under ``no_grad``; otherwise one pass
    runs over the stacked ``[target; generated]`` (losses.py:109-125)."""
    w = _weights(target, sample_weight)
    if not per_band:
        x = target[..., :3] * (1.0 - cmask)
        y = generated[..., :3] * (1.0 - cmask)
        n_rep = 1
    else:
        def stack(img):  # (B, H, W, C) -> (C*B, H, W, 1)
            return img.permute(3, 0, 1, 2).reshape((-1,) + img.shape[1:3] + (1,))

        x = stack(target * (1.0 - cmask))
        y = stack(generated * (1.0 - cmask))
        n_rep = target.shape[-1]
    if target_grad:
        n = x.shape[0]
        feats = vgg16_features(torch.cat([x, y], dim=0), vgg, feature_layers, dtype)
        fx = [f[:n] for f in feats]
        fy = [f[n:] for f in feats]
    else:
        with torch.no_grad():
            fx = vgg16_features(x, vgg, feature_layers, dtype)
        fy = vgg16_features(y, vgg, feature_layers, dtype)
    wn = torch.clamp(w.sum(), min=1.0)
    loss = torch.zeros((), dtype=torch.float32, device=target.device)
    for a, b in zip(fx, fy):
        per_sample = ((a - b) ** 2).mean(dim=(1, 2, 3)).reshape(n_rep, -1).mean(dim=0)
        loss = loss + (per_sample * w).sum() / wn / len(feature_layers)
    return loss


def _masked_recon_terms(target: torch.Tensor, generated: torch.Tensor, cmap: torch.Tensor,
                        kind: str):
    """Per-sample reconstruction on the masked images, rescaled by
    ``num_pixel / num_wnc`` (losses.py:153-174): (per-sample loss, num_wnc,
    masked target, masked generated); ``kind`` is ``l1`` or ``mse``."""
    num_pixel = target.shape[1] * target.shape[2]
    num_wnc = (1.0 - cmap).sum(dim=(1, 2, 3))
    tm = target * (1.0 - cmap)
    gm = generated * (1.0 - cmap)
    diff = tm - gm
    per = (diff.abs() if kind == "l1" else diff.square()).mean(dim=(1, 2, 3))
    per = per * num_pixel / torch.where(num_wnc > 0, num_wnc, torch.ones_like(num_wnc))
    return per, num_wnc, tm, gm


def _ms_ssim_loss(tm, gm, w, wn, msssim_weights, ssim_grad):
    """1 - the weighted batch mean of MS-SSIM(tm, gm); without a graph when
    ``ssim_grad`` is off (losses.py:215-227)."""
    with torch.set_grad_enabled(ssim_grad and torch.is_grad_enabled()):
        ssim_per = ssim_mod.ms_ssim(tm, gm, data_range=1.0, size_average=False,
                                    weights=msssim_weights)
        return 1.0 - (ssim_per * w).sum() / wn


def cnet_loss(target: torch.Tensor, generated: torch.Tensor, cmap: torch.Tensor,
              vgg: VGG16Weights, feature_layers: Sequence[int] = (29,),
              perception_per_band: bool = True, generator_mask_switch: bool = False,
              msssim_weights: Optional[Sequence[float]] = None,
              sample_weight: Optional[torch.Tensor] = None, ssim_grad: bool = True,
              perception_dtype: Optional[torch.dtype] = None,
              perception_target_grad: bool = True, compute_ssim: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """USSS loss tuple (generator, l1, perception, ssim) (parity: Loss.py:64-95).

    With ``ssim_grad=False`` (SSIM weighted 0, as in every reference demo) the
    MS-SSIM value is computed without a graph; with ``compute_ssim=False`` it
    is skipped and reported as 0 (losses.py:215-227)."""
    w = _weights(target, sample_weight)
    wn = torch.clamp(w.sum(), min=1.0)
    per, _, tm, gm = _masked_recon_terms(target, generated, cmap, "l1")
    generator_loss = (per * w).sum() / wn
    l1_loss = (cmap.abs().mean(dim=(1, 2, 3)) * w).sum() / wn
    pmask = hard_mask(cmap) if generator_mask_switch else cmap
    p_loss = perception_loss(target, generated, pmask, vgg, feature_layers,
                             per_band=perception_per_band, sample_weight=sample_weight,
                             dtype=perception_dtype, target_grad=perception_target_grad)
    if not compute_ssim:
        return generator_loss, l1_loss, p_loss, torch.zeros_like(l1_loss)
    return (generator_loss, l1_loss, p_loss,
            _ms_ssim_loss(tm, gm, w, wn, msssim_weights, ssim_grad))


def cgenerator_loss(target: torch.Tensor, generated: torch.Tensor, cmap: torch.Tensor,
                    vgg: VGG16Weights, feature_layers: Sequence[int] = (29,),
                    perception_per_band: bool = False,
                    msssim_weights: Optional[Sequence[float]] = None,
                    sample_weight: Optional[torch.Tensor] = None, ssim_grad: bool = True,
                    perception_dtype: Optional[torch.dtype] = None,
                    perception_target_grad: bool = True, compute_ssim: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """WSSS loss tuple (generator, ssim, perception) (parity: Loss.py:100-124).

    ``cnet_loss`` with an MSE reconstruction; a sample whose mask covers
    everything (num_wnc == 0) is skipped while the denominator stays the
    weighted batch (Loss.py:116-119, losses.py:231-273)."""
    w = _weights(target, sample_weight)
    wn = torch.clamp(w.sum(), min=1.0)
    per, num_wnc, tm, gm = _masked_recon_terms(target, generated, cmap, "mse")
    keep = (num_wnc > 0).to(per.dtype)
    generator_loss = (per * keep * w).sum() / wn
    ssim_loss = (_ms_ssim_loss(tm, gm, w, wn, msssim_weights, ssim_grad) if compute_ssim
                 else torch.zeros_like(generator_loss))
    p_loss = perception_loss(target, generated, cmap, vgg, feature_layers,
                             per_band=perception_per_band, sample_weight=sample_weight,
                             dtype=perception_dtype, target_grad=perception_target_grad)
    return generator_loss, ssim_loss, p_loss


def region_loss(cmap: torch.Tensor, region: torch.Tensor, kind: str = "l1",
                sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The density inside ``region`` against zero, rescaled by the region's
    size (parity: Loss.py:127-141, losses.py:276-299): per sample
    ``criterion(cmap * region, 0) * num_pixel / num_region`` with ``kind``
    ``l1`` (mean |.|) or ``mse`` (mean square), a sample with an empty
    region skipped, the weighted batch mean."""
    w = _weights(cmap, sample_weight)
    wn = torch.clamp(w.sum(), min=1.0)
    num_pixel = cmap.shape[1] * cmap.shape[2]
    num_region = region.sum(dim=(1, 2, 3))
    masked = cmap * region
    per = (masked.abs() if kind == "l1" else masked.square()).mean(dim=(1, 2, 3))
    per = per * num_pixel / torch.where(num_region > 0, num_region, torch.ones_like(num_region))
    keep = (num_region > 0).to(per.dtype)
    return (per * keep * w).sum() / wn
