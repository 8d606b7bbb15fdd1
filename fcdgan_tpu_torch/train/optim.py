"""Adam and RMSprop with the reference's settings, the learning rate set per epoch.

The JAX package builds unit-LR torch-semantics optimizers and multiplies the
update by the epoch's learning rate: Adam with bias correction and eps
outside the square root, betas (0.9, 0.99), eps 1e-8 (Demo_USSS.py:121,
optim.py:193), and RMSprop with alpha 0.99, eps 1e-8 outside the square
root, no momentum, not centered (Demo_WSSS.py:121-122, optim.py:210-249).
The port uses ``torch.optim.Adam`` and ``torch.optim.RMSprop`` with the
same settings and sets the param group's learning rate once per epoch,
which is the same arithmetic.
"""

from __future__ import annotations

from typing import Iterable

import torch

BETAS = (0.9, 0.99)
EPS = 1e-8
RMS_ALPHA = 0.99


def adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """torch Adam over ``params``; its learning rate comes from ``set_lr``."""
    return torch.optim.Adam(params, lr=0.0, betas=BETAS, eps=EPS)


def rmsprop(params: Iterable[torch.nn.Parameter]) -> torch.optim.RMSprop:
    """torch RMSprop over ``params``; its learning rate comes from ``set_lr``."""
    return torch.optim.RMSprop(params, lr=0.0, alpha=RMS_ALPHA, eps=EPS, momentum=0.0,
                               centered=False)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)
