"""Adam with the reference's settings, its learning rate set per epoch.

The JAX package builds a unit-LR torch-semantics Adam (bias correction, eps
outside the square root; betas (0.9, 0.99), eps 1e-8, Demo_USSS.py:121,
optim.py:193) and multiplies the update by the epoch's learning rate. The
port uses ``torch.optim.Adam`` with the same settings and sets the param
group's learning rate once per epoch, which is the same arithmetic.
"""

from __future__ import annotations

from typing import Iterable

import torch

BETAS = (0.9, 0.99)
EPS = 1e-8


def adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """torch Adam over ``params``; its learning rate comes from ``set_lr``."""
    return torch.optim.Adam(params, lr=0.0, betas=BETAS, eps=EPS)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)
