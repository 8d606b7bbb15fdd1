"""Eval-mode U-Net building blocks of the Segmentor (reference Module.py:18-90).

Counterparts of the JAX package's ``models/layers.py`` ``DoubleConv``,
``Down``, ``Up`` (bilinear only) and ``OutConv``, written as torch modules
whose parameter names are the reference's, so a reference state_dict loads
strictly. The TPU layout rewrites of that file (space-to-depth convs, split
concatenations, grouped BatchNorm, W-split pools) compute the same math and
are not ported.

Tensors are NCHW in ``channels_last`` memory. Parameters stay f32; each
layer computes in the model's ``compute_dtype`` with weights cast once and
cached (as Flax ``dtype=bf16`` casts per layer). Routing: a 3x3, stride-1,
pad-1 conv whose shapes pass the JAX gate (C_in <= 64, C_out <= 128,
H, W >= 8) runs on the ``ops.conv3x3`` kernel and adds its bias after; every
other conv calls ``F.conv2d``.

BatchNorm is eval-mode with torch semantics (eps 1e-5): the per-channel
scale ``gamma / sqrt(var + eps)`` and the shift, which absorbs the conv bias,
are computed in f32 and then cast (JAX layers.py:355-358).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3, gate, pack_weight


def _memo(owner: nn.Module, key, make: Callable):
    """Tensors derived from ``owner``'s parameters (cast or packed weights),
    rebuilt only when ``key`` (dtype, device, parameter versions) changes."""
    hit = owner.__dict__.get("_derived")
    if hit is None or hit[0] != key:
        hit = (key, make())
        owner.__dict__["_derived"] = hit
    return hit[1]


def _versions(*tensors: torch.Tensor) -> Tuple:
    return tuple((t.data_ptr(), t._version) for t in tensors)


def uses_kernel(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """The routing rule: 3x3 stride-1 pad-1 convs inside the kernel's gate."""
    return (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.padding == (1, 1) and conv.dilation == (1, 1)
            and conv.groups == 1
            and gate(x.shape[2], x.shape[3], conv.in_channels, conv.out_channels))


def conv_nobias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` without its bias on ``x`` (channels_last NCHW, compute dtype)."""
    dt = x.dtype
    key = (dt, x.device, _versions(conv.weight))
    if uses_kernel(conv, x):
        w = _memo(conv, ("hwio",) + key, lambda: pack_weight(conv.weight, dt))
        return conv3x3(x.permute(0, 2, 3, 1), w).permute(0, 3, 1, 2)
    w = _memo(conv, ("oihw",) + key, lambda: conv.weight.detach().to(
        dt, memory_format=torch.channels_last))
    return F.conv2d(x, w, None, conv.stride, conv.padding)


def conv_bn_relu(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """relu(bn(conv(x) + bias)) in eval mode, as one affine after the conv."""
    y = conv_nobias(conv, x)

    def affine():
        mul = bn.weight.detach() * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias.detach() + (conv.bias.detach() - bn.running_mean) * mul
        return (mul.to(x.dtype).view(1, -1, 1, 1), shift.to(x.dtype).view(1, -1, 1, 1))

    key = (x.dtype, x.device, _versions(conv.bias, bn.weight, bn.bias,
                                        bn.running_mean, bn.running_var))
    mul, shift = _memo(bn, key, affine)
    return torch.addcmul(shift, y, mul).relu_()


class DoubleConv(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x2 (parity: Module.py:18-35)."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int = 0):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1), nn.BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.double_conv
        return conv_bn_relu(s[3], s[4], conv_bn_relu(s[0], s[1], x))


class Down(nn.Module):
    """MaxPool2 (floor, like XLA VALID) -> DoubleConv (parity: Module.py:38-49)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv[1](F.max_pool2d(x, 2))


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """F.pad(x1, [dx//2, dx-dx//2, dy//2, dy-dy//2]) (Module.py:70-74)."""
    dy = x2.shape[2] - x1.shape[2]
    dx = x2.shape[3] - x1.shape[3]
    if dy == 0 and dx == 0:
        return x1
    return F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])


class Up(nn.Module):
    """Bilinear x2 upsample (align_corners), pad to the skip's size, concat
    [*skips, x1], DoubleConv with mid = in/2 (parity: Module.py:52-79)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, in_channels // 2)

    def forward(self, x1: torch.Tensor, skips: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        x1 = F.interpolate(x1, size=(2 * x1.shape[2], 2 * x1.shape[3]),
                           mode="bilinear", align_corners=True)
        x1 = pad_to_match(x1, skips[0])
        return self.conv(torch.cat([*skips, x1], dim=1))


class OutConv(nn.Module):
    """Conv1x1 -> sigmoid (parity: Module.py:82-90)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        key = (x.dtype, x.device, _versions(self.conv.weight, self.conv.bias))
        w, b = _memo(self.conv, key, lambda: (
            self.conv.weight.detach().to(x.dtype, memory_format=torch.channels_last),
            self.conv.bias.detach().to(x.dtype)))
        return torch.sigmoid(F.conv2d(x, w, b))
