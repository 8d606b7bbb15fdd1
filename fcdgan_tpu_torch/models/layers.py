"""U-Net and residual building blocks, in eval and train mode (reference
Module.py:18-90, 174-190).

Counterparts of the JAX package's ``models/layers.py`` ``DoubleConv``,
``Down``, ``Up`` (bilinear only), ``OutConv``, ``ResidualBlock``, ``PReLU``
and ``BatchNorm``, written as torch modules whose parameter names are the
reference's, so a reference state_dict loads strictly. The TPU layout
rewrites of that file (space-to-depth convs, split concatenations, grouped
BatchNorm, W-split pools) compute the same math and are not ported.

Tensors are NCHW in ``channels_last`` memory. Parameters stay f32; each
layer computes in the input's dtype (the model's ``compute_dtype``), as Flax
``dtype=bf16`` casts per layer. In eval mode or under ``no_grad`` the cast
and packed weights are built once and cached; with gradients on they are
built per forward, with autograd, from the f32 parameters. Routing: a 3x3,
stride-1, pad-1 conv whose shapes pass the JAX gate (C_in <= 64,
C_out <= 128, H, W >= 8) runs on the ``ops.conv3x3`` kernel (its gradient
through ``ops.conv3x3.conv3x3_backward``); every other conv calls
``F.conv2d``. Max pools are ``ops.pool_bwd.max_pool_2x2``: its forward is
the ``phase_pool`` kernel, its backward the ``pool_bwd`` kernel.

BatchNorm follows the JAX package's default (layers.py:291-358), not
``F.batch_norm``: momentum 0.1, eps 1e-5; train mode normalises with the
batch mean and the biased variance ``E[x^2] - E[x]^2`` (clamped at 0),
computed in f32 whatever the compute dtype, and the running variance stores
that biased value. Every train-mode BN is ``ops.fused_bn.bn_train``, whose
statistics forward and backward are the ``channel_sums`` kernels. The bias
of the conv before a BN is folded (``bn_fold_enabled``, layers.py:32-54): in
train mode it is never added, so it gets no gradient (``grad is None``) and
only shifts the running-mean update; in eval mode it enters the BN shift.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3, conv3x3_backward, gate, pack_weight
from ..ops.fused_bn import bn_train
from ..ops.pool_bwd import max_pool_2x2

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _memo(owner: nn.Module, tag: str, key, make: Callable):
    """Tensors derived from ``owner``'s parameters (cast or packed weights),
    one per ``tag``, rebuilt only when ``key`` (dtype, device, parameter
    versions) changes."""
    cache = owner.__dict__.setdefault("_derived", {})
    hit = cache.get(tag)
    if hit is None or hit[0] != key:
        hit = cache[tag] = (key, make())
    return hit[1]


def _versions(*tensors: torch.Tensor) -> Tuple:
    return tuple((t.data_ptr(), t._version) for t in tensors)


def _grad_into(*params: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in params)


def _derived(owner: nn.Module, param: torch.Tensor, x: torch.Tensor, tag: str,
             make: Callable) -> torch.Tensor:
    """``make()`` with autograd when gradients flow into ``param``, else the
    cached, detached result (eval, ``no_grad``)."""
    if _grad_into(param):
        return make()
    key = (x.dtype, x.device, _versions(param))
    return _memo(owner, tag, key, lambda: make().detach())


def uses_kernel(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """The routing rule: 3x3 stride-1 pad-1 convs inside the kernel's gate."""
    return (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.padding == (1, 1) and conv.dilation == (1, 1)
            and conv.groups == 1
            and gate(x.shape[2], x.shape[3], conv.in_channels, conv.out_channels))


class _Conv3x3(torch.autograd.Function):
    """The conv3x3 kernel forward (NHWC x, HWIO w) with the XLA-conv-style
    backward of the JAX package's custom VJP (conv3x3.py:140-143)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return conv3x3_backward(x, w, dy, ctx.needs_input_grad[:2])


def _conv(conv: nn.Conv2d, x: torch.Tensor, with_bias: bool) -> torch.Tensor:
    dt = x.dtype
    b = (_derived(conv, conv.bias, x, "bias", lambda: conv.bias.to(dt))
         if with_bias else None)
    if uses_kernel(conv, x):
        w = _derived(conv, conv.weight, x, "hwio", lambda: pack_weight(conv.weight, dt))
        y = _Conv3x3.apply(x.permute(0, 2, 3, 1), w).permute(0, 3, 1, 2)
        return y if b is None else y + b.view(1, -1, 1, 1)
    w = _derived(conv, conv.weight, x, "oihw",
                 lambda: conv.weight.to(dt, memory_format=torch.channels_last))
    return F.conv2d(x, w, b, conv.stride, conv.padding)


def conv_nobias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` without its bias on ``x`` (channels_last NCHW, compute dtype)."""
    return _conv(conv, x, with_bias=False)


def conv_bias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with its bias (a conv that no BatchNorm follows)."""
    return _conv(conv, x, with_bias=True)


def batch_norm(bn: nn.BatchNorm2d, y: torch.Tensor, fold_bias: torch.Tensor) -> torch.Tensor:
    """BatchNorm of ``y`` (the conv output without the folded ``fold_bias``)
    with the JAX package's semantics (layers.py:337-358)."""
    dt = y.dtype
    if bn.training:
        out, mean, var = bn_train(y, bn.weight, bn.bias, BN_EPS)
        with torch.no_grad():
            bn.running_mean.mul_(1 - BN_MOMENTUM).add_(mean + fold_bias, alpha=BN_MOMENTUM)
            bn.running_var.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            bn.num_batches_tracked.add_(1)
        return out

    def affine():
        mul = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        shift = bn.bias - (bn.running_mean - fold_bias) * mul
        return mul.to(dt).view(1, -1, 1, 1), shift.to(dt).view(1, -1, 1, 1)

    if _grad_into(bn.weight, bn.bias):
        mul, shift = affine()
    else:
        key = (dt, y.device, _versions(bn.weight, bn.bias, bn.running_mean,
                                       bn.running_var, fold_bias))
        mul, shift = _memo(bn, "affine", key, lambda: tuple(t.detach() for t in affine()))
    return torch.addcmul(shift, y, mul)


def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """bn(conv(x) + conv.bias), the bias folded into the BatchNorm."""
    return batch_norm(bn, conv_nobias(conv, x), conv.bias.detach())


def prelu(act: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    """torch-default PReLU with one slope (JAX layers.py:387-394)."""
    alpha = act.weight.to(x.dtype)
    return torch.where(x >= 0, x, alpha * x)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``flax.linen.leaky_relu``: x where x >= 0, else slope * x."""
    return torch.where(x >= 0, x, slope * x)


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
        return torch.relu(conv_bn(s[3], s[4], torch.relu(conv_bn(s[0], s[1], x))))


class Down(nn.Module):
    """MaxPool2 (floor, like XLA VALID) -> DoubleConv (parity: Module.py:38-49)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv[1](max_pool_2x2(x))


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
        return torch.sigmoid(conv_bias(self.conv, x))


class ResidualBlock(nn.Module):
    """Conv3x3-BN-PReLU-Conv3x3-BN + identity (parity: Module.py:174-190)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.prelu = nn.PReLU()
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = prelu(self.prelu, conv_bn(self.conv1, self.bn1, x))
        return x + conv_bn(self.conv2, self.bn2, r)
