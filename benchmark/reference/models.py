"""The reference's networks in plain PyTorch (Module.py, Loss.py:17-61).

Segmentor: the siamese bilinear U-Net (Module.py:18-140), both dates
stacked on the batch axis so that a train-mode BatchNorm normalizes over
both. Generator: the SRGAN translator (Module.py:142-190). Discriminator:
the siamese feature-difference classifier (Module.py:192-223). VGG16: the
frozen torchvision ``features`` up to a tap (Loss.py:17-61), with a band
fed as its own plane replicated to RGB.

State-dict keys are the reference's. BatchNorm follows the flax default
that the trained models use: the batch mean and the biased variance in
train mode, and the biased variance in the running buffer (momentum 0.1,
eps 1e-5). A conv before a BatchNorm keeps its bias, as the published
modules do; in train mode the batch mean cancels it.

``quant`` is the precision of every convolution: ``identity`` for the
float32 reference; ``fp8`` for the control, whose convolutions take their
input and weight in e4m3, store their result in e4m3 (as a bfloat16
program stores its activations in bfloat16) and, in the backward, take
their result's gradient in e5m2, each at one scale per tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.1
BN_EPS = 1e-5
E4M3_MAX = 448.0  # the largest float8 values
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to a float8 type at one scale per tensor."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    """An operand of a convolution in e4m3; the gradient passes."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Result(torch.autograd.Function):
    """A convolution's result stored in e4m3; the gradient into it in e5m2,
    as both gradient convolutions of an fp8 step take it."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def conv2d(x, w, b, quant: Callable, stride=1, padding=0) -> torch.Tensor:
    """``F.conv2d`` in the precision ``quant`` names."""
    if quant is identity:
        return F.conv2d(x, w, b, stride, padding)
    y = F.conv2d(_Fp8Operand.apply(x), _Fp8Operand.apply(w), b, stride, padding)
    return _Fp8Result.apply(y)


def conv(m: nn.Conv2d, x: torch.Tensor, quant: Callable) -> torch.Tensor:
    return conv2d(x, m.weight, m.bias, quant, m.stride, m.padding)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8Operand.apply(t)


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


QUANT = {"fp32": identity, "fp8": fp8}


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with the biased variance in train mode and in the
    running buffer."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        r = torch.rsqrt(var + BN_EPS)
        return ((x - mean.view(1, -1, 1, 1)) * (self.weight * r).view(1, -1, 1, 1)
                + self.bias.view(1, -1, 1, 1))


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, mid: int = 0, quant: Callable = identity):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, padding=1), BatchNorm(mid), nn.ReLU(),
            nn.Conv2d(mid, cout, 3, padding=1), BatchNorm(cout), nn.ReLU())
        self.quant = quant

    def forward(self, x):
        s, q = self.double_conv, self.quant
        return F.relu(s[4](conv(s[3], F.relu(s[1](conv(s[0], x, q))), q)))


class Down(nn.Module):
    def __init__(self, cin: int, cout: int, quant: Callable = identity):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout, quant=quant))

    def forward(self, x):
        return self.maxpool_conv[1](F.max_pool2d(x, 2))


class Up(nn.Module):
    def __init__(self, cin: int, cout: int, quant: Callable = identity):
        super().__init__()
        self.conv = DoubleConv(cin, cout, cin // 2, quant=quant)

    def forward(self, x1, skips):
        x1 = F.interpolate(x1, scale_factor=2, mode="bilinear", align_corners=True)
        dy = skips[0].shape[2] - x1.shape[2]
        dx = skips[0].shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([*skips, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int, quant: Callable = identity):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)
        self.quant = quant

    def forward(self, x):
        return torch.sigmoid(conv(self.conv, x, self.quant))


class Segmentor(nn.Module):
    """(B, C, H, W) x2 -> (B, 1, H, W) change density."""

    def __init__(self, n_channels: int, quant: Callable = identity):
        super().__init__()
        q = dict(quant=quant)
        self.inc = DoubleConv(n_channels, 64, **q)
        self.down1, self.down2 = Down(64, 128, **q), Down(128, 256, **q)
        self.down3, self.down4 = Down(256, 512, **q), Down(512, 512, **q)
        self.up1, self.up2 = Up(2048, 512, **q), Up(1024, 256, **q)
        self.up3, self.up4 = Up(512, 128, **q), Up(256, 128, **q)
        self.outc = OutConv(128, 1, **q)

    def forward(self, x1, x2):
        n = x1.shape[0]
        f = [self.inc(torch.cat([x1, x2], dim=0))]
        for down in (self.down1, self.down2, self.down3, self.down4):
            f.append(down(f[-1]))
        pairs = [(t[:n], t[n:]) for t in f]
        h = torch.cat(pairs[4], dim=1)
        for up, level in ((self.up1, 3), (self.up2, 2), (self.up3, 1), (self.up4, 0)):
            h = up(h, pairs[level])
        return self.outc(h)


class ResidualBlock(nn.Module):
    def __init__(self, c: int, quant: Callable = identity):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(c, c, 3, padding=1), BatchNorm(c)
        self.prelu = nn.PReLU()
        self.conv2, self.bn2 = nn.Conv2d(c, c, 3, padding=1), BatchNorm(c)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        r = self.prelu(self.bn1(conv(self.conv1, x, q)))
        return x + self.bn2(conv(self.conv2, r, q))


class Generator(nn.Module):
    """(B, C, H, W) -> (B, C, H, W), no output activation (Module.py:171)."""

    def __init__(self, n_channels: int, quant: Callable = identity):
        super().__init__()
        self.block1 = nn.Sequential(nn.Conv2d(n_channels, 64, 9, padding=4), nn.PReLU())
        for i in range(2, 7):
            setattr(self, f"block{i}", ResidualBlock(64, quant))
        self.block7 = nn.Sequential(nn.Conv2d(64, 64, 3, padding=1), BatchNorm(64))
        self.block8 = nn.Conv2d(64, n_channels, 9, padding=4)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        stem = self.block1[1](conv(self.block1[0], x, q))
        h = stem
        for i in range(2, 7):
            h = getattr(self, f"block{i}")(h)
        h = self.block7[1](conv(self.block7[0], h, q))
        return conv(self.block8, stem + h, q)


class Discriminator(nn.Module):
    """(B, C, H, W) x2 -> (B,) probability that the pair differs."""

    def __init__(self, n_channels: int, quant: Callable = identity):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(n_channels, 64, 3, stride=2, padding=1), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 128, 3, stride=2, padding=1), BatchNorm(128), nn.LeakyReLU(0.2),
            nn.Conv2d(128, 256, 3, stride=2, padding=1), BatchNorm(256), nn.LeakyReLU(0.2),
            nn.Conv2d(256, 512, 3, stride=2, padding=1), BatchNorm(512), nn.LeakyReLU(0.2))
        self.classifier = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(512, 1024, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(1024, 1, 1))
        self.quant = quant

    def forward(self, x, y):
        n, q, net = x.shape[0], self.quant, self.net
        h = _lrelu(conv(net[0], torch.cat([x, y], dim=0), q))
        for c, bn in ((net[2], net[3]), (net[5], net[6]), (net[8], net[9])):
            h = _lrelu(bn(conv(c, h, q)))
        d = (h[:n] - h[n:]).mean(dim=(2, 3), keepdim=True)
        d = _lrelu(conv(self.classifier[1], d, q))
        return torch.sigmoid(conv(self.classifier[3], d, q).reshape(n))


# (out_channels per conv, "M" for a 2x2 max pool) of torchvision's vgg16().features
VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M")


def vgg16_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """The fixed-seed He-normal VGG16 (HWIO kernels, zero biases) that stands
    in for the pretrained network, which no run can fetch."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for li, c in enumerate(c for c in VGG_CFG if c != "M"):
        std = float(np.sqrt(2.0 / (cin * 9)))
        params[f"conv{li}_kernel"] = rng.normal(0, std, (3, 3, cin, c)).astype(np.float32)
        params[f"conv{li}_bias"] = np.zeros((c,), np.float32)
        cin = c
    return params


class VGG16:
    """Frozen VGG16 ``features`` on one device (OIHW float32)."""

    def __init__(self, params: Dict[str, np.ndarray], device, quant: Callable = identity):
        n = sum(1 for c in VGG_CFG if c != "M")
        self.w = [torch.from_numpy(np.ascontiguousarray(
            params[f"conv{i}_kernel"].transpose(3, 2, 0, 1))).to(device) for i in range(n)]
        self.b = [torch.from_numpy(params[f"conv{i}_bias"]).to(device) for i in range(n)]
        self.quant = quant

    def features(self, x: torch.Tensor, tap: int) -> torch.Tensor:
        """NCHW RGB input -> the post-ReLU activation at torchvision index
        ``tap``; a 1-channel input is the band replicated to RGB."""
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        seq, li, h = 0, 0, x
        for c in VGG_CFG:
            if c == "M":
                h = F.max_pool2d(h, 2)
                seq += 1
                continue
            h = F.relu(conv2d(h, self.w[li], self.b[li], self.quant, padding=1))
            if seq + 1 == tap:
                return h
            seq += 2
            li += 1
        raise ValueError(f"tap {tap} is past VGG16's features")


def nets(names: Sequence[str], n_channels: int, quant: Callable = identity,
         device: Optional[torch.device] = None) -> Dict[str, nn.Module]:
    """The named networks ("G", "S", "D") of a configuration."""
    classes = {"G": Generator, "S": Segmentor, "D": Discriminator}
    return {k: classes[k](n_channels, quant).to(device) for k in names}
