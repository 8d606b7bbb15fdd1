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
``ssim_level.launches`` counts kernel launches: one per level, which tiles
the level (``tile_plan``) and forms the per-plane means in its last block.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .ssim import _ssim_maps, gaussian_window
from .tickets import sm_count, stream_and_counter

SOURCE = "fused_ssim"
TILE_W = 32          # output columns of a tile (kTW)
TILE_HEIGHTS = (8, 4, 2, 1)  # output rows of a tile, the largest that fills the card
MAX_WIN = 11         # largest window the kernel takes (kMaxWin)
MAX_IMAGES = 65535   # images of a level: the grid's y extent (kMaxImages)


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


class TilePlan(NamedTuple):
    """Output tiles of one level: ``th`` x ``tw`` valid positions,
    ``tiles_y`` x ``tiles_x`` of them per image, one block each."""
    th: int
    tw: int
    tiles_y: int
    tiles_x: int


@functools.lru_cache(maxsize=256)
def tile_plan(n: int, h: int, w: int, win_size: int, sms: int) -> TilePlan:
    """Tiles ``TILE_W`` wide (or the valid width), as tall as
    ``TILE_HEIGHTS`` allows while the launch still has a block per SM."""
    vh, vw = h - win_size + 1, w - win_size + 1
    tw = min(TILE_W, vw)
    tiles_x = -(-vw // tw)
    th = next((t for t in TILE_HEIGHTS if n * tiles_x * -(-vh // t) >= sms), TILE_HEIGHTS[-1])
    return TilePlan(th, tw, -(-vh // th), tiles_x)


@functools.lru_cache(maxsize=None)
def _kernel():
    from .build import load

    fn = load(SOURCE).fcd_ssim_level_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _taps(win_size: int, win_sigma: float):
    return (ctypes.c_float * win_size)(*gaussian_window(win_size, win_sigma).tolist())


@functools.lru_cache(maxsize=None)
def _constants(data_range: float, k1: float, k2: float) -> Tuple[float, float]:
    """c1, c2 rounded to f32, as the JAX kernel's."""
    return (float(np.float32((k1 * data_range) ** 2)),
            float(np.float32((k2 * data_range) ** 2)))


def _launch(x, y, data_range, win_size, win_sigma, k1, k2):
    if win_size > MAX_WIN:
        raise ValueError(f"the fused_ssim kernel takes win_size <= {MAX_WIN}, "
                         f"not {win_size}")
    n, h, w, c = x.shape
    if n > MAX_IMAGES:
        raise ValueError(f"ssim_level: the kernel's grid takes at most {MAX_IMAGES} images, "
                         f"not {n}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not y.is_contiguous():
        y = y.contiguous()
    dev = x.device
    plan = tile_plan(n, h, w, win_size, sm_count(dev.index))
    tiles = plan.tiles_y * plan.tiles_x
    # the two (N, C) tables, then the per-tile partial sums: one allocation
    buf = torch.empty(2 * n * c * (1 + tiles), dtype=torch.float32, device=dev)
    c1, c2 = _constants(data_range, k1, k2)
    stream, counter = stream_and_counter(dev, n)  # one ticket counter per image
    ptr = buf.data_ptr()
    status = _kernel()(x.data_ptr(), y.data_ptr(), ptr, ptr + 4 * n * c, ptr + 8 * n * c,
                       counter, n, h, w, c, win_size, plan.th, plan.tw,
                       _taps(win_size, win_sigma), c1, c2, stream)
    if status != 0:
        raise RuntimeError(f"fused_ssim kernel launch failed: cudaError_t {status}")
    ssim_level.launches += 1
    ssim_pc, cs_pc = buf[:2 * n * c].view(2, n, c)
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
