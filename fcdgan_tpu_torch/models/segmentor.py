"""Siamese U-Net change segmentor (parity: reference Module.py:93-140).

Counterpart of the JAX package's ``models/segmentor.py``. With
``siamese_stats='joint'`` (the default) the shared-weight encoder sees both
temporal images stacked on the batch axis in one pass (segmentor.py:43-58),
so in train mode the BatchNorm statistics are joint over both dates. With
``'split'`` (the reference's per-branch statistics, segmentor.py:59-66) the
encoder runs once per date, level by level in the JAX order (inc on x1,
inc on x2, down1 on each, ...), each pass normalizing with its own batch
statistics and updating the running ones in turn. The two modes are the
same function in eval mode and share the state_dict keys, so a checkpoint
of either loads into both. Each level's two halves are concatenated on
channels for the decoder skips; the decoder
is bilinear (channels 64-128-256-512-512, Up 2048/1024/512/256 -> 512/256/
128/128) and a 1-channel sigmoid gives the change density in [0, 1].

``compute_dtype`` is bfloat16 for serving and float32 for parity; the
parameters stay float32 either way. Inputs are NCHW float tensors; the
model computes in ``channels_last`` memory and returns float32 (N, 1, H, W).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import DoubleConv, Down, OutConv, Up


class Segmentor(nn.Module):
    def __init__(self, n_channels: int, n_outchannels: int = 1,
                 compute_dtype: torch.dtype = torch.float32, siamese_stats: str = "joint"):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        if siamese_stats not in ("joint", "split"):
            raise ValueError(f"siamese_stats must be joint or split, not {siamese_stats!r}")
        self.compute_dtype = compute_dtype
        self.siamese_stats = siamese_stats
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 512)
        self.up1 = Up(2048, 512)
        self.up2 = Up(1024, 256)
        self.up3 = Up(512, 128)
        self.up4 = Up(256, 128)
        self.outc = OutConv(128, n_outchannels)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        downs = (self.down1, self.down2, self.down3, self.down4)
        if self.siamese_stats == "joint":
            n = x1.shape[0]
            f = [self.inc(self._cast(torch.cat([x1, x2], dim=0)))]
            for down in downs:
                f.append(down(f[-1]))
            pairs = [(t[:n], t[n:]) for t in f]
        else:
            a, b = self.inc(self._cast(x1)), self.inc(self._cast(x2))
            pairs = [(a, b)]
            for down in downs:
                a, b = down(a), down(b)
                pairs.append((a, b))
        h = torch.cat(pairs[4], dim=1)
        h = self.up1(h, pairs[3])
        h = self.up2(h, pairs[2])
        h = self.up3(h, pairs[1])
        h = self.up4(h, pairs[0])
        return self.outc(h).float()
