"""SRGAN-style image translator x -> y_hat (parity: reference Module.py:142-172).

Counterpart of the JAX package's ``models/generator.py``: Conv9x9 + PReLU
stem, five residual blocks, Conv3x3 + BN, the long skip
``block8(stem + trunk)``, Conv9x9 back to ``n_channels``, no output
activation (the reference's tanh is commented out, Module.py:171). The JAX
package's whole-trunk W-axis space-to-depth layout is an exact TPU layout
rewrite (generator.py:32-48) and is not ported.

Key names are the reference's (``block1.0``, ``block2.conv1``, ...,
``block7.1``, ``block8``), so a reference ``GModel.pkl`` loads strictly.
Inputs are NCHW float tensors; the model computes in ``compute_dtype`` in
``channels_last`` memory and returns float32 NCHW. The eleven 64 -> 64 3x3
convs of the trunk run on the ``ops.conv3x3`` kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import ResidualBlock, conv_bias, conv_bn, prelu


class Generator(nn.Module):
    def __init__(self, n_channels: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.block1 = nn.Sequential(nn.Conv2d(n_channels, 64, 9, padding=4), nn.PReLU())
        self.block2 = ResidualBlock(64)
        self.block3 = ResidualBlock(64)
        self.block4 = ResidualBlock(64)
        self.block5 = ResidualBlock(64)
        self.block6 = ResidualBlock(64)
        self.block7 = nn.Sequential(nn.Conv2d(64, 64, 3, padding=1), nn.BatchNorm2d(64))
        self.block8 = nn.Conv2d(64, n_channels, 9, padding=4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)
        stem = prelu(self.block1[1], conv_bias(self.block1[0], x))
        h = stem
        for block in (self.block2, self.block3, self.block4, self.block5, self.block6):
            h = block(h)
        h = conv_bn(self.block7[0], self.block7[1], h)
        return conv_bias(self.block8, stem + h).float()
