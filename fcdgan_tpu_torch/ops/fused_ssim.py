"""One fused MS-SSIM level: a hand-written Hopper kernel.

Port of ``fcdgan_tpu/ops/pallas/fused_ssim.py::ssim_level_pallas`` (the
kernel ``_ssim_kernel``): per (image, channel) plane the means of the SSIM
and contrast-structure maps, two (N, C) float32 tables. The kernel is
``csrc/fused_ssim.cu``; its note says what bounds it and what its design
does about that. As in the JAX package (``_bwd``, fused_ssim.py:142-150)
the backward recomputes through the plain composite ``ops.ssim._ssim_maps``
with autograd: there is no backward kernel.

The gate is the JAX package's: H, W >= ``win_size`` (``ops/ssim.py`` routes
smaller levels to the composite). Inputs are NHWC float32, as there.

``ssim_level`` launches the kernel for CUDA tensors and runs the plain
composite for CPU tensors; it raises on anything else.
``ssim_level.launches`` counts kernel launches (one per level, each a tile
pass and a per-plane reduction).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .ssim import _ssim_maps, gaussian_window

SOURCE = "fused_ssim"
TILE = 32        # output tile side of the kernel (kTile)
MAX_WIN = 11     # largest window the kernel takes (kMaxWin)


def ssim_level_plain(x, y, data_range=1.0, win_size=11, win_sigma=1.5,
                     k1=0.01, k2=0.03) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: the composite ``_ssim_maps``."""
    win = torch.from_numpy(gaussian_window(win_size, win_sigma)).to(x.device)
    return _ssim_maps(x, y, data_range, win, (k1, k2))


def _check(x: torch.Tensor, y: torch.Tensor, win_size: int) -> None:
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"ssim_level expects two NHWC tensors of one shape; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"ssim_level takes float32; got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"ssim_level: x on {x.device}, y on {y.device}")
    if win_size % 2 != 1 or min(x.shape[1], x.shape[2]) < win_size:
        raise ValueError(f"ssim_level gate: odd win_size <= H, W; got win_size "
                         f"{win_size} for {tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel():
    from .build import load

    fn = load(SOURCE).fcd_ssim_level_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _taps(win_size: int, win_sigma: float):
    return (ctypes.c_float * win_size)(*gaussian_window(win_size, win_sigma).tolist())


def _launch(x, y, data_range, win_size, win_sigma, k1, k2):
    if win_size > MAX_WIN:
        raise ValueError(f"the fused_ssim kernel takes win_size <= {MAX_WIN}, "
                         f"not {win_size}")
    n, h, w, c = x.shape
    if n * c > 65535:
        raise ValueError(f"ssim_level: {n * c} planes exceed the kernel's grid")
    fn = _kernel()
    x, y = x.contiguous(), y.contiguous()
    vh, vw = h - win_size + 1, w - win_size + 1
    tiles = -(-vh // TILE) * -(-vw // TILE)
    # the two (N, C) tables, then the per-tile partial sums: one allocation
    buf = torch.empty(2 * n * c * (1 + tiles), dtype=torch.float32, device=x.device)
    ssim_pc, cs_pc = buf[:2 * n * c].view(2, n, c)
    c1 = float(np.float32((k1 * data_range) ** 2))
    c2 = float(np.float32((k2 * data_range) ** 2))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), y.data_ptr(), ssim_pc.data_ptr(), cs_pc.data_ptr(),
                    buf[2 * n * c:].data_ptr(), n, h, w, c, win_size,
                    _taps(win_size, win_sigma), c1, c2, stream)
    if status != 0:
        raise RuntimeError(f"fused_ssim kernel launch failed: cudaError_t {status}")
    ssim_level.launches += 1
    return ssim_pc, cs_pc


class _SSIMLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, data_range, win_size, win_sigma, k1, k2):
        ctx.save_for_backward(x, y)
        ctx.args = (data_range, win_size, win_sigma, k1, k2)
        if x.device.type == "cuda":
            return _launch(x, y, data_range, win_size, win_sigma, k1, k2)
        if x.device.type == "cpu":
            return ssim_level_plain(x, y, data_range, win_size, win_sigma, k1, k2)
        raise ValueError(f"ssim_level: unsupported device {x.device}")

    @staticmethod
    def backward(ctx, g_ssim, g_cs):
        x, y = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            yd = y.detach().requires_grad_(ctx.needs_input_grad[1])
            grads = iter(torch.autograd.grad(ssim_level_plain(xd, yd, *ctx.args),
                                             [t for t in (xd, yd) if t.requires_grad],
                                             (g_ssim, g_cs)))
        dx = next(grads) if xd.requires_grad else None
        dy = next(grads) if yd.requires_grad else None
        return dx, dy, None, None, None, None, None


def ssim_level(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
               win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
               k2: float = 0.03) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (ssim, cs) means of one scale of NHWC float32 ``x``, ``y``:
    two (N, C) tensors, differentiable through the composite."""
    _check(x, y, win_size)
    return _SSIMLevel.apply(x, y, data_range, win_size, win_sigma, k1, k2)


ssim_level.launches = 0
