"""The reference's training steps and optimizers in plain PyTorch.

USSS joint step (Demo_USSS.py:289-400): the reference zeroes G's gradients
before both of its backwards and S's between them, so G takes
d(LossG + NetLoss)/dG = 2 dNetLoss/dG (the perception, reconstruction and
SSIM terms are LossG; l1 has no G dependence) and S takes dNetLoss/dS;
then both Adam steps.

WSSS adversarial step (Demo_WSSS.py:235-343): S in train mode on the
changed and then the unchanged pair; D on both pairs masked by the changed
pair's detached map, loss ``1 + mean D(nc) - mean D(c)``, an RMSprop step;
the frozen G in eval mode; S's loss ``dw*D(c masked by the live map) +
l1w*l1 + gw*(gen + pw*perc) + ncw*mean(ncmap^2)`` against the updated D,
its gradient into S alone, an RMSprop step.

Adam: betas (0.9, 0.99), eps 1e-8 outside the root, bias-corrected.
RMSprop: alpha 0.99, eps 1e-8 outside the root, no momentum.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import losses as L

BETAS = (0.9, 0.99)
RMS_ALPHA = 0.99
EPS = 1e-8


class Adam:
    def __init__(self, params: List[torch.Tensor]):
        self.params = list(params)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        b1, b2 = BETAS
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g * g, alpha=1 - b2)
            mh = m / (1 - b1 ** self.t)
            vh = v / (1 - b2 ** self.t)
            p.sub_(lr * mh / (vh.sqrt() + EPS))


class RMSprop:
    def __init__(self, params: List[torch.Tensor]):
        self.params = list(params)
        self.sq = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        for p, s in zip(self.params, self.sq):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            s.mul_(RMS_ALPHA).addcmul_(g, g, value=1 - RMS_ALPHA)
            p.sub_(lr * g / (s.sqrt() + EPS))


def _zero(*nets):
    for net in nets:
        for p in net.parameters():
            p.grad = None


def _wmean(v, w):
    return (v * w).sum() / torch.clamp(w.sum(), min=1.0)


def usss_joint(G, S, opt_g, opt_s, vgg, cfg: Dict, b: Dict, lr: float) -> Dict[str, float]:
    """One joint step on the NCHW batch ``b`` (x, y, weight); returns its
    losses and leaves each net's gradient in ``.grad``."""
    G.train()
    S.train()
    y_fake = G(b["x"])
    cmap = S(b["x"], b["y"])
    gen, l1, perc, ssim = L.cnet_loss(b["y"], y_fake, cmap, vgg, cfg["vgg_tap"], b["weight"],
                                      cfg.get("msssim_weights"))
    a = gen + cfg["perception_weight"] * perc + cfg["ssim_weight"] * ssim
    net_loss = a + cfg["l1_weight"] * l1
    _zero(G, S)
    net_loss.backward()
    with torch.no_grad():
        for p in G.parameters():
            if p.grad is not None:
                p.grad.mul_(2.0)
    opt_g.step(lr)
    opt_s.step(lr)
    return {"NetLoss": float(net_loss.detach()), "ssim_loss": float(ssim)}


def wsss_adversarial(G, S, D, opt_s, opt_d, vgg, cfg: Dict, b: Dict, lr_s: float,
                     lr_d: float) -> Dict[str, float]:
    """One adversarial step on the NCHW batch ``b`` (c_x, c_y, nc_x, nc_y,
    weight); returns its losses."""
    G.eval()
    S.train()
    D.train()
    w = b["weight"]
    cmap = S(b["c_x"], b["c_y"])
    ncmap = S(b["nc_x"], b["nc_y"])
    keep = 1 - cmap.detach()
    c_out = D(b["c_x"] * keep, b["c_y"] * keep)
    nc_out = D(b["nc_x"] * keep, b["nc_y"] * keep)
    d_loss = 1.0 + _wmean(nc_out, w) - _wmean(c_out, w)
    _zero(D)
    d_loss.backward()
    opt_d.step(lr_d)
    with torch.no_grad():
        y_fake = G(b["c_x"])
    keep = 1 - cmap
    s_d_loss = _wmean(D(b["c_x"] * keep, b["c_y"] * keep), w)
    nc_loss = _wmean(ncmap.square().mean(dim=(1, 2, 3)), w)
    gen, ssim, perc = L.cgenerator_loss(b["c_y"], y_fake, cmap, vgg, cfg["vgg_tap"], w,
                                        cfg.get("msssim_weights"))
    g_loss = gen + cfg["perception_weight"] * perc + cfg["ssim_weight"] * ssim
    l1 = _wmean(cmap.abs().mean(dim=(1, 2, 3)), w)
    s_loss = (cfg["d_weight"] * s_d_loss + cfg["l1_weight"] * l1 + cfg["g_weight"] * g_loss
              + cfg["nc_weight"] * nc_loss)
    params = list(S.parameters())
    grads = torch.autograd.grad(s_loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = g
    opt_s.step(lr_s)
    return {"d_loss": float(d_loss.detach()), "s_loss": float(s_loss.detach()),
            "ssim_loss": float(ssim)}
