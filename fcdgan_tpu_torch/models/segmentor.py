"""Siamese U-Net change segmentor, eval mode (parity: reference Module.py:93-140).

Counterpart of the JAX package's ``models/segmentor.py``. The shared-weight
encoder sees both temporal images stacked on the batch axis in one pass
(segmentor.py:43-58; in eval mode identical to two passes); each level's
two halves are concatenated on channels for the decoder skips; the decoder
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
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        self.compute_dtype = compute_dtype
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

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode Segmentor (training, --bn-mode train) is not ported "
                "yet (ROADMAP.md); call .eval()")
        n = x1.shape[0]
        x = torch.cat([x1, x2], dim=0).to(
            self.compute_dtype).contiguous(memory_format=torch.channels_last)
        f1 = self.inc(x)
        f2 = self.down1(f1)
        f3 = self.down2(f2)
        f4 = self.down3(f3)
        f5 = self.down4(f4)
        h = torch.cat([f5[:n], f5[n:]], dim=1)
        h = self.up1(h, (f4[:n], f4[n:]))
        h = self.up2(h, (f3[:n], f3[n:]))
        h = self.up3(h, (f2[:n], f2[n:]))
        h = self.up4(h, (f1[:n], f1[n:]))
        return self.outc(h).float()
