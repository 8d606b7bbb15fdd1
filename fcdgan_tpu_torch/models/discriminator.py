"""Siamese feature-difference discriminator (parity: reference Module.py:192-223).

Counterpart of the JAX package's ``models/discriminator.py``. With
``siamese_stats='joint'`` (the default) the two masked images run through
the shared trunk stacked on the batch axis (train-mode BatchNorm statistics
joint over both); with ``'split'`` (discriminator.py:55-60) the whole trunk
runs on x and then on y, each pass with its own batch statistics. The trunk
is four stride-2 3x3 convolutions (64, 128, 256, 512), the last three
with BatchNorm (conv bias folded, as ``models/layers.py`` does), LeakyReLU
0.2 after each; then the mean over H and W of the feature difference
fx - fy, a 1x1 conv to 1024, LeakyReLU, a 1x1 conv to 1 and a sigmoid: one
probability per sample, (B,) float32.

Key names are the reference's (``net.{0,2,5,8}`` convs, ``net.{3,6,9}``
BatchNorms, ``classifier.{1,3}``), so a reference ``DModel.pkl`` loads
strictly. The stride-2 convolutions are outside the conv3x3 kernel's gate and
go to ``F.conv2d``. Inputs are NCHW float tensors; the model computes in
``compute_dtype`` in ``channels_last`` memory.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import conv_bias, conv_bn, leaky_relu


class Discriminator(nn.Module):
    def __init__(self, n_channels: int, compute_dtype: torch.dtype = torch.float32,
                 siamese_stats: str = "joint"):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        if siamese_stats not in ("joint", "split"):
            raise ValueError(f"siamese_stats must be joint or split, not {siamese_stats!r}")
        self.compute_dtype = compute_dtype
        self.siamese_stats = siamese_stats
        self.net = nn.Sequential(
            nn.Conv2d(n_channels, 64, 3, stride=2, padding=1), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 128, 3, stride=2, padding=1), nn.BatchNorm2d(128), nn.LeakyReLU(0.2),
            nn.Conv2d(128, 256, 3, stride=2, padding=1), nn.BatchNorm2d(256), nn.LeakyReLU(0.2),
            nn.Conv2d(256, 512, 3, stride=2, padding=1), nn.BatchNorm2d(512), nn.LeakyReLU(0.2))
        self.classifier = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(512, 1024, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(1024, 1, 1))

    def _trunk(self, h: torch.Tensor) -> torch.Tensor:
        net = self.net
        h = leaky_relu(conv_bias(net[0], h.to(self.compute_dtype).contiguous(
            memory_format=torch.channels_last)))
        for conv, bn in ((net[2], net[3]), (net[5], net[6]), (net[8], net[9])):
            h = leaky_relu(conv_bn(conv, bn, h))
        return h

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if self.siamese_stats == "joint":
            h = self._trunk(torch.cat([x, y], dim=0))
            fx, fy = h[:n], h[n:]
        else:
            fx, fy = self._trunk(x), self._trunk(y)
        d = (fx - fy).mean(dim=(2, 3), keepdim=True)
        d = leaky_relu(conv_bias(self.classifier[1], d))
        d = conv_bias(self.classifier[3], d)
        return torch.sigmoid(d.reshape(n)).float()
