"""Explicit device choice for every entry point of the port.

The port runs on the GPU unless the caller asks for the CPU by name, as the
tests do. Nothing falls back: asking for ``cuda`` on a host without a card
raises instead of quietly computing on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(name: Optional[str] = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> that CUDA device (raises when CUDA
    is unavailable); ``"cpu"`` -> the CPU. Anything else raises."""
    dev = torch.device(name or "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} does not exist "
                           f"({torch.cuda.device_count()} CUDA devices)")
    return dev
