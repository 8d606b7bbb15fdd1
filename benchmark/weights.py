"""Network weights from a seed, made on the device in one draw a network.

The names and shapes come from the reference's modules (the published
state-dict keys, which the program's networks load strictly). Schemes:

* ``torch_default``: what ``nn.Conv2d`` draws at construction, weights and
  biases uniform in +-1/sqrt(fan_in); the state a training run starts from.
* ``he_uniform``: conv weights uniform in +-sqrt(6/fan_in) and zero biases,
  so that an eval-mode network whose BatchNorms hold the identity statistics
  keeps its activations at unit scale and serves a density that varies over
  the scene, as a trained network's does.

BatchNorm scales start at 1, shifts and running means at 0, running
variances at 1; PReLU slopes at 0.25.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

SEED_MOD = (1 << 63) - 1
DATA_SALT = 1000  # the synthetic rasters' stream; networks take 0, 1, 2


def generator(seed: int, salt: int, device) -> torch.Generator:
    """The stream ``salt`` of ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % SEED_MOD)
    return g


def init_state(net: nn.Module, seed: int, salt: int, device,
               scheme: str = "torch_default") -> Dict[str, torch.Tensor]:
    """A float32 state dict for ``net``'s keys on ``device``; ``net`` may
    live on the meta device."""
    state = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in net.state_dict().items()}
    convs = [(name, m) for name, m in net.named_modules() if isinstance(m, nn.Conv2d)]
    sizes = [m.weight.numel() + (m.bias.numel() if m.bias is not None else 0)
             for _, m in convs]
    u = torch.rand(sum(sizes), generator=generator(seed, salt, device), device=device) * 2 - 1
    off = 0
    for (name, m), size in zip(convs, sizes):
        fan_in = m.weight[0].numel()
        gain = math.sqrt(6.0 / fan_in) if scheme == "he_uniform" else 1.0 / math.sqrt(fan_in)
        k = m.weight.numel()
        state[f"{name}.weight"] = (u[off:off + k] * gain).view(m.weight.shape).clone()
        if m.bias is not None:
            b = u[off + k:off + size] / math.sqrt(fan_in)
            state[f"{name}.bias"] = (b * 0 if scheme == "he_uniform" else b).clone()
        off += size
    for name, m in net.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            state[f"{name}.weight"].fill_(1.0)
            state[f"{name}.bias"].zero_()
            state[f"{name}.running_mean"].zero_()
            state[f"{name}.running_var"].fill_(1.0)
            state[f"{name}.num_batches_tracked"].zero_()
        elif isinstance(m, nn.PReLU):
            state[f"{name}.weight"].fill_(0.25)
    return state
