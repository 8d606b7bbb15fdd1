"""Train and inference steps of the unsupervised, weakly supervised and
regional supervised modes (JAX ``train/steps.py``).

``USSSSteps`` holds the Generator, the Segmentor, their optimizers and the
loss configuration, and runs one batch of each reference phase
(Demo_USSS.py:124-400) plus inference (:404-473). ``WSSSSteps`` does the
same for the G pretrain (Demo_WSSS.py:140-204), the adversarial S/D step
(:235-343) and the final train-mode-BN inference (:387-445); ``RSSSSteps``
for the G pretrain (Demo_RSSS.py:173-238), the adversarial step with a
region-synthesized unchanged pair (:244-397), the per-epoch test
evaluation (:399-447) and the final inference. Batches are NHWC float32
tensors on the models' device, as in the JAX package; the models see their
NCHW channels_last views. A step returns its metrics as device tensors (the
confusion matrix included), so the epoch loop reads them once per epoch.

Gradient flow, as in the JAX package:
  * G pretrain (:182-198): cmap is zero and the target is data, so the
    perception target branch runs forward only (``target_grad=False``).
  * S init (:200-224): G runs in train mode under ``no_grad``, which
    updates its BatchNorm running statistics without stepping it.
  * Joint (:226-253): the reference zeroes G's gradients before both of its
    backwards and S's between them, so gradG = d(A + NetLoss)/dG and
    gradS = d(NetLoss)/dS, with A = gen + pw*perc + sw*ssim and
    NetLoss = A + l1w*l1. l1 has no G dependence, so ONE forward and ONE
    backward of NetLoss give gradS and dA/dG; G's gradients are then
    doubled. Then both Adam updates run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..eval.evaluator import confusion_update
from ..models.vgg import VGG16Weights
from ..ops import losses as L
from .optim import set_lr


@dataclasses.dataclass(frozen=True)
class PerceptionConfig:
    feature_layers: Tuple[int, ...]
    per_band: bool
    dtype: Optional[torch.dtype] = None  # bfloat16 under mixed precision


def interior_valid_mask(item: torch.Tensor, interior_sizes: torch.Tensor,
                        canvas_hw: Tuple[int, int], pad: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) {0, 1} float mask of each tile's stitched interior, built on
    the device from the per-item core sizes (steps.py:57-76)."""
    h, w = canvas_hw
    padx, pady = pad
    sizes = interior_sizes[item]  # (B, 2) = (core_h, core_w)
    rows = torch.arange(h, device=item.device).view(1, h, 1)
    cols = torch.arange(w, device=item.device).view(1, 1, w)
    ch = sizes[:, 0].view(-1, 1, 1)
    cw = sizes[:, 1].view(-1, 1, 1)
    return ((rows >= pady) & (rows < pady + ch)
            & (cols >= padx) & (cols < padx + cw)).to(torch.float32)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class USSSSteps:
    def __init__(self, generator, segmentor, opt_g, opt_s, vgg: VGG16Weights,
                 perception: PerceptionConfig, perception_weight: float,
                 l1_weight: float, ssim_weight: float, interior_sizes: np.ndarray,
                 pad: Tuple[int, int], gt_map: Sequence[int] = (1, 2),
                 pre_map: Sequence[int] = (0, 1), prob_thresh: float = 0.5,
                 msssim_weights: Optional[Sequence[float]] = None,
                 ssim_metric: bool = True):
        if not ssim_metric and ssim_weight != 0:
            raise ValueError("ssim_metric=False requires ssim_weight == 0")
        self.G, self.S = generator, segmentor
        self.opt_g, self.opt_s = opt_g, opt_s
        self.vgg = vgg
        self.pc = perception
        self.pw, self.l1w, self.sw = perception_weight, l1_weight, ssim_weight
        self.interior = torch.as_tensor(np.asarray(interior_sizes, np.int64),
                                        device=vgg.device)
        self.pad = tuple(pad)
        self.gt_map, self.pre_map = tuple(gt_map), tuple(pre_map)
        self.prob_thresh = prob_thresh
        self.msw = tuple(msssim_weights) if msssim_weights is not None else None
        self.ssim_metric = ssim_metric

    def _cnet(self, y, y_fake, cmap, w, target_grad=True):
        return L.cnet_loss(
            y, y_fake, cmap, self.vgg, self.pc.feature_layers,
            perception_per_band=self.pc.per_band, msssim_weights=self.msw,
            sample_weight=w, ssim_grad=self.sw != 0, perception_dtype=self.pc.dtype,
            perception_target_grad=target_grad, compute_ssim=self.ssim_metric)

    def _confusion(self, cmap, ref, item, w):
        """Interior-only confusion of the thresholded map (strict ``>``,
        Demo_USSS.py:430-431), padded samples weighted out."""
        with torch.no_grad():
            cmask = (cmap[..., 0] > self.prob_thresh).to(torch.float32)
            valid = interior_valid_mask(item, self.interior, tuple(cmap.shape[1:3]),
                                        self.pad) * w.view(-1, 1, 1)
            return confusion_update(ref[..., 0], cmask, self.gt_map, self.pre_map, valid)

    @staticmethod
    def _metrics(loss, gen, l1, perc, ssim) -> Dict[str, torch.Tensor]:
        return {"NetLoss": loss.detach(), "generator_loss": gen.detach(),
                "l1_loss": l1.detach(), "perception_loss": perc.detach(),
                "ssim_loss": ssim.detach()}

    # -- phase 1: generator pretrain (Demo_USSS.py:124-189) -----------------
    def g_pretrain(self, x, y, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        cmap = torch.zeros(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
        y_fake = _nhwc(self.G(_nchw(x)))
        gen, l1, perc, ssim = self._cnet(y, y_fake, cmap, w, target_grad=False)
        loss = gen + self.pw * perc + self.sw * ssim
        self.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(self.opt_g, lr)
        self.opt_g.step()
        return self._metrics(loss, gen, l1, perc, ssim)

    # -- phase 2: segmentor init, G forwarded but not stepped (:192-286) ----
    def s_init(self, x, y, ref, item, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        self.S.train()
        with torch.no_grad():  # train-mode G forward: its BN running stats move
            y_fake = _nhwc(self.G(_nchw(x)))
        cmap = _nhwc(self.S(_nchw(x), _nchw(y)))
        gen, l1, perc, ssim = self._cnet(y, y_fake, cmap, w)
        loss = gen + self.l1w * l1 + self.pw * perc + self.sw * ssim
        self.opt_s.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(self.opt_s, lr)
        self.opt_s.step()
        m = self._metrics(loss, gen, l1, perc, ssim)
        m["confusion"] = self._confusion(cmap.detach(), ref, item, w)
        return m

    # -- phase 3: joint alternating with G-gradient accumulation (:289-400) --
    def joint(self, x, y, ref, item, w, lr_g, lr_s) -> Dict[str, torch.Tensor]:
        self.G.train()
        self.S.train()
        y_fake = _nhwc(self.G(_nchw(x)))
        cmap = _nhwc(self.S(_nchw(x), _nchw(y)))
        gen, l1, perc, ssim = self._cnet(y, y_fake, cmap, w)
        a = gen + self.pw * perc + self.sw * ssim  # == LossG
        net_loss = a + self.l1w * l1
        self.opt_g.zero_grad(set_to_none=True)
        self.opt_s.zero_grad(set_to_none=True)
        net_loss.backward()
        with torch.no_grad():  # dLossG/dG + dNetLoss/dG
            for p in self.G.parameters():
                if p.grad is not None:
                    p.grad.mul_(2.0)
        set_lr(self.opt_g, lr_g)
        set_lr(self.opt_s, lr_s)
        self.opt_g.step()
        self.opt_s.step()
        m = self._metrics(net_loss, gen, l1, perc, ssim)
        m["confusion"] = self._confusion(cmap.detach(), ref, item, w)
        return m

    # -- inference (:404-473) -------------------------------------------------
    @torch.no_grad()
    def infer(self, x, y) -> torch.Tensor:
        """Eval-mode change density of NCHW tiles, (B, 1, H, W) float32."""
        self.S.eval()
        return self.S(x, y)


def _wmean(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted batch mean of per-sample values (steps.py:84-86)."""
    return (v * w).sum() / torch.clamp(w.sum(), min=1.0)


class WSSSSteps:
    """Steps of the weakly supervised mode (JAX ``WSSSSteps``, :265-458).

    Gradient flow, as in the JAX package:
      * G pretrain on unchanged pairs: cmap is zero and the target is data,
        so the perception target branch runs forward only.
      * Adversarial: ONE pair of train-mode S forwards (changed pair, then
        unchanged pair; S's BN statistics move on both, in order) keeps its
        graph. The D update sees the detached masks, the unchanged pair
        masked by the CHANGED pair's mask (:367-373), with loss
        ``1 + wmean(D(nc)) - wmean(D(c))``, then RMSprop. The frozen G runs in
        eval mode under ``no_grad``. The S loss
        ``dw*s_d + l1w*l1 + gw*g + ncw*nc`` re-evaluates the UPDATED D on
        the changed pair masked by the live map; its gradients go into S's
        parameters only (``torch.autograd.grad``), so it never steps D, and
        D's BN statistics move on all three of its forwards.
    Each step leaves each stepped net's gradients in ``.grad``."""

    def __init__(self, generator, segmentor, discriminator, opt_g, opt_s, opt_d,
                 vgg: VGG16Weights, perception: PerceptionConfig, perception_weight: float,
                 ssim_weight: float, g_weight: float, l1_weight: float, d_weight: float,
                 nc_weight: float, prob_thresh: float = 0.6,
                 discriminator_continuous: bool = True,
                 msssim_weights: Optional[Sequence[float]] = None, ssim_metric: bool = True):
        if not ssim_metric and ssim_weight != 0:
            raise ValueError("ssim_metric=False requires ssim_weight == 0")
        self.G, self.S, self.D = generator, segmentor, discriminator
        self.opt_g, self.opt_s, self.opt_d = opt_g, opt_s, opt_d
        self.vgg = vgg
        self.pc = perception
        self.pw, self.sw = perception_weight, ssim_weight
        self.gw, self.l1w, self.dw, self.ncw = g_weight, l1_weight, d_weight, nc_weight
        self.prob_thresh = prob_thresh
        self.continuous = discriminator_continuous
        self.msw = tuple(msssim_weights) if msssim_weights is not None else None
        self.ssim_metric = ssim_metric

    def _cgen(self, y, y_fake, cmap, w, target_grad=True):
        return L.cgenerator_loss(
            y, y_fake, cmap, self.vgg, self.pc.feature_layers,
            perception_per_band=self.pc.per_band, msssim_weights=self.msw,
            sample_weight=w, ssim_grad=self.sw != 0, perception_dtype=self.pc.dtype,
            perception_target_grad=target_grad, compute_ssim=self.ssim_metric)

    def _d(self, x, y):
        return self.D(_nchw(x), _nchw(y))

    # -- G pretrain on unchanged pairs, cmap = 0 (Demo_WSSS.py:140-204) -----
    def g_pretrain(self, x, y, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        cmap = torch.zeros(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
        y_fake = _nhwc(self.G(_nchw(x)))
        gen, ssim, perc = self._cgen(y, y_fake, cmap, w, target_grad=False)
        loss = gen + self.pw * perc + self.sw * ssim
        self.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(self.opt_g, lr)
        self.opt_g.step()
        return {"g_loss": loss.detach(), "generator_loss": gen.detach(),
                "perception_loss": perc.detach(), "ssim_loss": ssim.detach()}

    # -- adversarial D-then-S step (Demo_WSSS.py:235-343) -------------------
    def adversarial(self, c_x, c_y, c_ref, nc_x, nc_y, w, lr_s, lr_d
                    ) -> Dict[str, torch.Tensor]:
        self.G.eval()
        self.S.train()
        self.D.train()
        cmap = _nhwc(self.S(_nchw(c_x), _nchw(c_y)))
        ncmap = _nhwc(self.S(_nchw(nc_x), _nchw(nc_y)))

        # D update: the masks are data, the gradients go into D only
        cmask = (cmap if self.continuous else L.hard_mask(cmap)).detach()
        keep = 1 - cmask
        c_out = self._d(c_x * keep, c_y * keep)  # D's BN statistics: c, then nc
        nc_out = self._d(nc_x * keep, nc_y * keep)
        d_loss = 1.0 + _wmean(nc_out, w) - _wmean(c_out, w)
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        set_lr(self.opt_d, lr_d)
        self.opt_d.step()

        # the frozen G (eval mode, Demo_WSSS.py:206)
        y_fake = None
        if self.gw != 0:
            with torch.no_grad():
                y_fake = _nhwc(self.G(_nchw(c_x)))

        # S loss against the updated D
        keep = 1 - (cmap if self.continuous else L.hard_mask(cmap))
        s_d_loss = _wmean(self._d(c_x * keep, c_y * keep), w)
        nc_loss = _wmean(ncmap.square().mean(dim=(1, 2, 3)), w)
        if y_fake is not None:
            gen, ssim, perc = self._cgen(c_y, y_fake, cmap, w)
        else:
            gen = ssim = perc = torch.zeros((), dtype=c_x.dtype, device=c_x.device)
        g_loss = gen + self.pw * perc + self.sw * ssim
        l1_loss = _wmean(cmap.abs().mean(dim=(1, 2, 3)), w)
        s_loss = (self.dw * s_d_loss + self.l1w * l1_loss + self.gw * g_loss
                  + self.ncw * nc_loss)
        params = [p for p in self.S.parameters() if p.requires_grad]
        grads = torch.autograd.grad(s_loss, params, allow_unused=True)
        self.opt_s.zero_grad(set_to_none=True)
        for p, g in zip(params, grads):
            p.grad = g
        set_lr(self.opt_s, lr_s)
        self.opt_s.step()

        # in-training eval on the changed pair, full patch (Demo_WSSS.py:337-343)
        with torch.no_grad():
            cmask_t = (cmap[..., 0] > self.prob_thresh).to(torch.float32)
            valid = w.view(-1, 1, 1).expand_as(cmask_t)
            cm = confusion_update(c_ref[..., 0], cmask_t, (0, 1), (0, 1), valid)
        return {"d_loss": d_loss.detach(), "s_loss": s_loss.detach(),
                "s_d_loss": s_d_loss.detach(), "l1_loss": l1_loss.detach(),
                "nc_loss": nc_loss.detach(), "g_loss": g_loss.detach(),
                "generator_loss": gen.detach(), "ssim_loss": ssim.detach(),
                "perception_loss": perc.detach(), "confusion": cm}

    # -- final inference, train-mode BN (Demo_WSSS.py:387-445) --------------
    @torch.no_grad()
    def infer_train_mode(self, x, y) -> torch.Tensor:
        """The change density (B, H, W, 1) f32 of NHWC pairs with S in train
        mode, as the reference ("train mode gets better performance",
        Demo_WSSS.py:389-391): S's BN running statistics move on every call,
        before SModel is saved."""
        self.S.train()
        return _nhwc(self.S(_nchw(x), _nchw(y)))


class RSSSSteps:
    """Steps of the regional supervised mode (JAX ``RSSSSteps``, :466-662).

    Gradient flow, as in the JAX package:
      * G pretrain with the REGION raster as the mask (Demo_RSSS.py:200-205):
        the mask and the target are data, so the perception target branch
        runs forward only.
      * Adversarial: ONE train-mode S forward keeps its graph. The D update
        sees the detached mask, on the pair (x, y) and on the unchanged pair
        synthesized from the region, (x, y*(1-region) + x*region), both
        masked by the same ``1 - cmask`` (:296-301), with loss
        ``1 + wmean(D(nc)) - wmean(D(c))``, then RMSprop. The frozen G runs
        in eval mode under ``no_grad``. The S loss ``dw*s_d + l1w*l1 + gw*g +
        rw*r``, with ``l1 = region_loss(cmap, region, l1)`` and ``r =
        region_loss(cmap, 1 - region, mse)``, re-evaluates the UPDATED D on
        the pair masked by the live map; its gradients go into S's
        parameters only, so D's BN statistics move on all three of its
        forwards and D is stepped once.
      * The per-epoch test evaluation thresholds the map over each tile's
        interior (``test_interior_sizes``): in eval mode
        (``eval_confusion``), or in train mode under ``no_grad``
        (``eval_confusion_train``, reference parity: the test batches move
        S's BN running statistics, Demo_RSSS.py:415).
    Each training step leaves each stepped net's gradients in ``.grad``."""

    def __init__(self, generator, segmentor, discriminator, opt_g, opt_s, opt_d,
                 vgg: VGG16Weights, perception: PerceptionConfig, perception_weight: float,
                 ssim_weight: float, g_weight: float, l1_weight: float, d_weight: float,
                 r_weight: float, interior_sizes: np.ndarray, pad: Tuple[int, int],
                 gt_map: Sequence[int] = (1, 2), pre_map: Sequence[int] = (0, 1),
                 prob_thresh: float = 0.5, discriminator_continuous: bool = True,
                 msssim_weights: Optional[Sequence[float]] = None,
                 test_interior_sizes: Optional[np.ndarray] = None, ssim_metric: bool = True):
        if not ssim_metric and ssim_weight != 0:
            raise ValueError("ssim_metric=False requires ssim_weight == 0")
        self.G, self.S, self.D = generator, segmentor, discriminator
        self.opt_g, self.opt_s, self.opt_d = opt_g, opt_s, opt_d
        self.vgg = vgg
        self.pc = perception
        self.pw, self.sw = perception_weight, ssim_weight
        self.gw, self.l1w, self.dw, self.rw = g_weight, l1_weight, d_weight, r_weight

        def sizes(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=vgg.device)

        self.interior = sizes(interior_sizes)
        self.test_interior = (self.interior if test_interior_sizes is None
                              else sizes(test_interior_sizes))
        self.pad = tuple(pad)
        self.gt_map, self.pre_map = tuple(gt_map), tuple(pre_map)
        self.prob_thresh = prob_thresh
        self.continuous = discriminator_continuous
        self.msw = tuple(msssim_weights) if msssim_weights is not None else None
        self.ssim_metric = ssim_metric

    def _cgen(self, y, y_fake, cmap, w, target_grad=True):
        return L.cgenerator_loss(
            y, y_fake, cmap, self.vgg, self.pc.feature_layers,
            perception_per_band=self.pc.per_band, msssim_weights=self.msw,
            sample_weight=w, ssim_grad=self.sw != 0, perception_dtype=self.pc.dtype,
            perception_target_grad=target_grad, compute_ssim=self.ssim_metric)

    def _d(self, x, y):
        return self.D(_nchw(x), _nchw(y))

    def _s(self, x, y):
        return _nhwc(self.S(_nchw(x), _nchw(y)))

    def _confusion(self, cmap, ref, item, w, interior):
        """Interior-only confusion of the thresholded map (strict ``>``),
        padded samples weighted out (steps.py:638-643)."""
        with torch.no_grad():
            cmask = (cmap[..., 0] > self.prob_thresh).to(torch.float32)
            valid = interior_valid_mask(item, interior, tuple(cmap.shape[1:3]),
                                        self.pad) * w.view(-1, 1, 1)
            return confusion_update(ref[..., 0], cmask, self.gt_map, self.pre_map, valid)

    # -- G pretrain with the region raster as mask (Demo_RSSS.py:173-238) ---
    def g_pretrain(self, x, y, region, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        y_fake = _nhwc(self.G(_nchw(x)))
        gen, ssim, perc = self._cgen(y, y_fake, region, w, target_grad=False)
        loss = gen + self.pw * perc + self.sw * ssim
        self.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(self.opt_g, lr)
        self.opt_g.step()
        return {"g_loss": loss.detach(), "generator_loss": gen.detach(),
                "perception_loss": perc.detach(), "ssim_loss": ssim.detach()}

    # -- adversarial D-then-S step with the synthesized pair (:266-397) ------
    def adversarial(self, x, y, ref, region, item, w, lr_s, lr_d
                    ) -> Dict[str, torch.Tensor]:
        self.G.eval()
        self.S.train()
        self.D.train()
        cmap = self._s(x, y)

        # D update: the mask is data, the gradients go into D only
        cmask = (cmap if self.continuous else L.hard_mask(cmap)).detach()
        keep = 1 - cmask
        y_unc = y * (1 - region) + x * region  # inside regions x replaces y
        c_out = self._d(x * keep, y * keep)  # D's BN statistics: c, then nc
        nc_out = self._d(x * keep, y_unc * keep)
        d_loss = 1.0 + _wmean(nc_out, w) - _wmean(c_out, w)
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        set_lr(self.opt_d, lr_d)
        self.opt_d.step()

        with torch.no_grad():  # the frozen G, eval mode (Demo_RSSS.py:240)
            y_fake = _nhwc(self.G(_nchw(x)))

        # S loss against the updated D
        keep = 1 - (cmap if self.continuous else L.hard_mask(cmap))
        s_d_loss = _wmean(self._d(x * keep, y * keep), w)
        gen, ssim, perc = self._cgen(y, y_fake, cmap, w)
        g_loss = gen + self.pw * perc + self.sw * ssim
        l1_loss = L.region_loss(cmap, region, "l1", sample_weight=w)
        r_loss = L.region_loss(cmap, 1 - region, "mse", sample_weight=w)
        s_loss = (self.dw * s_d_loss + self.l1w * l1_loss + self.gw * g_loss
                  + self.rw * r_loss)
        params = [p for p in self.S.parameters() if p.requires_grad]
        grads = torch.autograd.grad(s_loss, params, allow_unused=True)
        self.opt_s.zero_grad(set_to_none=True)
        for p, g in zip(params, grads):
            p.grad = g
        set_lr(self.opt_s, lr_s)
        self.opt_s.step()
        return {"d_loss": d_loss.detach(), "s_loss": s_loss.detach(),
                "s_d_loss": s_d_loss.detach(), "l1_loss": l1_loss.detach(),
                "r_loss": r_loss.detach(), "g_loss": g_loss.detach(),
                "generator_loss": gen.detach(), "ssim_loss": ssim.detach(),
                "perception_loss": perc.detach(),
                "confusion": self._confusion(cmap.detach(), ref, item, w, self.interior)}

    # -- inference and the per-epoch test evaluation (:399-504) --------------
    @torch.no_grad()
    def infer(self, x, y) -> torch.Tensor:
        """Eval-mode change density (B, H, W, 1) f32 of NHWC pairs."""
        self.S.eval()
        return self._s(x, y)

    def eval_confusion(self, x, y, ref, item, w):
        """Eval-mode test confusion over the tiles' interiors, and the map."""
        cmap = self.infer(x, y)
        return self._confusion(cmap, ref, item, w, self.test_interior), cmap

    @torch.no_grad()
    def eval_confusion_train(self, x, y, ref, item, w):
        """The same with S in train mode (reference parity: the reference
        never calls ``netS.eval()`` in its adversarial loop, so its test
        forward, Demo_RSSS.py:415, normalizes with the batch statistics and
        moves S's BN running statistics, which the final eval-mode inference
        then uses)."""
        self.S.train()
        cmap = self._s(x, y)
        return self._confusion(cmap, ref, item, w, self.test_interior), cmap
