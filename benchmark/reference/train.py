"""The reference's first training steps of a configuration from the same
raw data, weights and batch rows as the program: the normalized batches
worked out again from the raw rasters, the networks built and loaded here,
each step's losses, every leaf's first gradient, and the parameters after
the last step."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import models, steps, strict_fp32
from .data import Tiles, meanstd, nchw, normalize


def lr_at(schedule: Dict, epoch: float) -> float:
    """The reference's warm-up / sustain / exponential-decay learning rate
    (CommonFunc.py:23-37)."""
    w, s = schedule["warmup_epochs"], schedule.get("sustain_epochs", 0)
    lo, hi, end = schedule["lr_start"], schedule["lr_max"], schedule["lr_min"]
    if epoch < w:
        return (hi - lo) / w * epoch + lo
    if epoch < w + s:
        return hi
    return (hi - end) * schedule.get("exp_decay", 0.8) ** (epoch - w - s) + end


class SceneTiles:
    """USSS batches from a raw scene pair: (H, W, C) arrays."""

    def __init__(self, x_raw: np.ndarray, y_raw: np.ndarray, patch: int, pad: int):
        mx, sx, my, sy = meanstd([x_raw], [y_raw])
        self.x, self.y = normalize(x_raw, mx, sx), normalize(y_raw, my, sy)
        self.grid = Tiles(x_raw.shape[0], x_raw.shape[1], patch, pad)

    def batch(self, rows: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
        items = [int(i) for i in rows["item"]]
        return {"x": nchw(np.stack([self.grid.canvas(self.x, i) for i in items])).to(device),
                "y": nchw(np.stack([self.grid.canvas(self.y, i) for i in items])).to(device),
                "weight": torch.as_tensor(np.asarray(rows["weight"], np.float32), device=device)}


class SlicePairs:
    """WSSS batches from raw slice stacks: (N, H, W, C) arrays of the
    changed and of the unchanged pairs, each in file-name order."""

    def __init__(self, c_x, c_y, nc_x, nc_y):
        mx, sx, my, sy = meanstd(list(c_x) + list(nc_x), list(c_y) + list(nc_y))
        self.c = (c_x, c_y)
        self.nc = (nc_x, nc_y)
        self.stats = (mx, sx, my, sy)

    def batch(self, rows: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
        mx, sx, my, sy = self.stats
        ci, ni = np.asarray(rows["c_item"]), np.asarray(rows["nc_item"])

        def t(a, m, s):
            return nchw(normalize(a, m, s)).to(device)

        return {"c_x": t(self.c[0][ci], mx, sx), "c_y": t(self.c[1][ci], my, sy),
                "nc_x": t(self.nc[0][ni], mx, sx), "nc_y": t(self.nc[1][ni], my, sy),
                "weight": torch.as_tensor(np.asarray(rows["weight"], np.float32), device=device)}


def half(b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first half of a batch (a fault: half of the batch left out)."""
    n = len(b["weight"])
    return {k: v[:max(n // 2, 1)] for k, v in b.items()}


def first_steps(cfg: Dict, init: Dict[str, Dict[str, torch.Tensor]], data,
                rows: Sequence[Dict[str, np.ndarray]], vgg_params: Dict[str, np.ndarray],
                device, precision: str = "fp32", halve: bool = False) -> Dict:
    """The reference's steps over ``rows`` (one dict of batch rows a step)
    from the state ``init`` ({net: state dict}): {"losses": [per step],
    "grads": {leaf: step 1's gradient}, "params": {leaf: tensor after the
    last step}}, on the host, with leaves named ``<net>.<parameter>``."""
    strict_fp32()
    quant = models.QUANT[precision]
    nets = models.nets(list(init), cfg["bands"], quant, device)
    for k, net in nets.items():
        net.load_state_dict(init[k])
    vgg = models.VGG16(vgg_params, device, quant)
    mode = cfg["mode"]
    trained = {"usss": ("G", "S"), "wsss": ("S", "D")}[mode]
    opt = {k: (steps.Adam if mode == "usss" else steps.RMSprop)(list(nets[k].parameters()))
           for k in trained}
    losses, grads = [], {}
    for i, r in enumerate(rows):
        b = data.batch(r, device)
        if halve:
            b = half(b)
        if mode == "usss":
            lr = lr_at(cfg["schedules"]["joint"], 0)
            losses.append(steps.usss_joint(nets["G"], nets["S"], opt["G"], opt["S"], vgg, cfg, b,
                                           lr))
        else:
            losses.append(steps.wsss_adversarial(
                nets["G"], nets["S"], nets["D"], opt["S"], opt["D"], vgg, cfg, b,
                lr_at(cfg["schedules"]["s_adversarial"], 0),
                lr_at(cfg["schedules"]["d_adversarial"], 0)))
        if i == 0:
            grads = {f"{k}.{n}": (p.grad if p.grad is not None else torch.zeros_like(p))
                     .detach().cpu().clone()
                     for k in trained for n, p in nets[k].named_parameters()}
    params = {f"{k}.{n}": p.detach().cpu().clone()
              for k in trained for n, p in nets[k].named_parameters()}
    return {"losses": losses, "grads": grads, "params": params}
