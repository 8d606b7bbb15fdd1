"""The reference's WSSS adversarial steps, each taken again from a state the
program held: the nets' parameters and BatchNorm buffers and RMSprop's
``square_avg``, on the step's own rows, in float32 without TF32 (or with
the fp8 control's rounding, or on half of the batch)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import models, steps, strict_fp32
from .train import half, lr_at

TRAINED = ("S", "D")


def _leaves(nets) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p.detach().cpu().clone() for k in TRAINED
            for n, p in nets[k].named_parameters()}


def wsss_steps(cfg: Dict, g_state: Dict[str, torch.Tensor], states: Sequence[Dict],
               rows: Sequence[Dict[str, np.ndarray]], data, vgg_params: Dict[str, np.ndarray],
               device, epoch: float = 0, precision: str = "fp32", halve: bool = False
               ) -> List[Dict]:
    """One reference step a state: ``states[k]`` is {"nets": {net: state
    dict}, "sq": {net: {parameter: square_avg}}} before the step on
    ``rows[k]``; G is frozen at ``g_state``. Each step's {"losses",
    "grads" (what it left in ``.grad``), "change" (parameters after less
    before)}, on the host, leaves named ``<net>.<parameter>``."""
    strict_fp32()
    quant = models.QUANT[precision]
    nets = models.nets(("G",) + TRAINED, cfg["bands"], quant, device)
    nets["G"].load_state_dict(g_state)
    vgg = models.VGG16(vgg_params, device, quant)
    lr_s = lr_at(cfg["schedules"]["s_adversarial"], epoch)
    lr_d = lr_at(cfg["schedules"]["d_adversarial"], epoch)
    out = []
    for st, r in zip(states, rows):
        opt = {}
        for k in TRAINED:
            nets[k].load_state_dict(st["nets"][k])
            opt[k] = steps.RMSprop(list(nets[k].parameters()))
            opt[k].sq = [st["sq"][k][n].to(device, torch.float32).clone()
                         for n, _ in nets[k].named_parameters()]
        before = _leaves(nets)
        b = data.batch(r, device)
        if halve:
            b = half(b)
        losses = steps.wsss_adversarial(nets["G"], nets["S"], nets["D"], opt["S"], opt["D"],
                                        vgg, cfg, b, lr_s, lr_d)
        grads = {f"{k}.{n}": (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().cpu().clone() for k in TRAINED for n, p in nets[k].named_parameters()}
        after = _leaves(nets)
        out.append({"losses": losses, "grads": grads,
                    "change": {k: after[k].double() - before[k].double() for k in after}})
    return out
