"""2x2/2 max pool whose backward is a hand-written Hopper kernel.

Port of ``fcdgan_tpu/ops/pallas/pool_bwd.py``: ``pool_bwd`` (the kernel
``_pool_bwd_kernel``) and ``max_pool_2x2_fused`` (its custom VJP). The JAX
package keeps XLA's select_and_scatter by default and gates its kernel to
the TPU, bf16 and C >= 128 for Mosaic's sake; none of those limits exist on
Hopper, and the port has no select_and_scatter to fall back on, so every
max-pool backward of the port (the Segmentor's ``Down`` pools and the VGG
pools of the perception loss) is this kernel. It is ``csrc/pool_bwd.cu``;
its note says what bounds it and what its design does about that.

Layouts stay the JAX package's at this boundary: ``x`` and ``dx`` are NHWC
(the memory of a channels_last NCHW tensor), ``dy`` is (N, H//2, W//2, C).
Routing is the row-major first maximum of each window (W first-wins, then H
first-wins); the trailing row/column of an odd extent gets exactly 0.

``max_pool_2x2`` is the port's 2x2 max pool: its forward is the
``ops.phase_pool`` kernel, its backward this one; a ``dy`` that is not
channels_last is copied first (``ops.layout.nhwc``).

``pool_bwd`` launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor; it raises on anything else. ``pool_bwd.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .layout import nhwc
from .phase_pool import phase_pool

SOURCE = "pool_bwd"


def pool_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, step for step the JAX package's
    ``pool_bwd_reference`` (pool_bwd.py:135-155)."""
    n, h, w, c = x.shape
    ho, wo = dy.shape[1], dy.shape[2]
    xr = x[:, :2 * ho, :2 * wo, :].reshape(n, 2 * ho, wo, 2, c)
    a, b = xr[..., 0, :], xr[..., 1, :]
    wsel = a >= b
    m = torch.where(wsel, a, b).reshape(n, ho, 2, wo, c)
    hsel = m[:, :, 0] >= m[:, :, 1]
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    dm = torch.stack([torch.where(hsel, dy, zero), torch.where(hsel, zero, dy)],
                     dim=2).reshape(n, 2 * ho, wo, c)
    dx = torch.stack([torch.where(wsel, dm, zero), torch.where(wsel, zero, dm)],
                     dim=3).reshape(n, 2 * ho, 2 * wo, c)
    return F.pad(dx, (0, 0, 0, w - 2 * wo, 0, h - 2 * ho)).to(x.dtype)


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"pool_bwd expects NHWC x and dy; got {tuple(x.shape)} "
                         f"and {tuple(dy.shape)}")
    n, h, w, c = x.shape
    if tuple(dy.shape) != (n, h // 2, w // 2, c):
        raise ValueError(f"pool_bwd: dy {tuple(dy.shape)} is not the 2x2 pool of "
                         f"x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != x.dtype:
        raise TypeError(f"pool_bwd takes float32 or bfloat16 x and dy of the same "
                        f"type; got {x.dtype} and {dy.dtype}")
    if x.device != dy.device:
        raise ValueError(f"pool_bwd: x on {x.device}, dy on {dy.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("pool_bwd needs contiguous NHWC x and dy "
                         "(channels_last NCHW permuted to NHWC is contiguous)")


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    from .build import load

    lib = load(SOURCE)
    fn = lib.fcd_pool_bwd_bf16 if dtype == torch.bfloat16 else lib.fcd_pool_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    fn = _kernel(x.dtype)
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, h, w, c, stream)
    if status != 0:
        raise RuntimeError(f"pool_bwd kernel launch failed: cudaError_t {status}")
    pool_bwd.launches += 1
    return dx


def pool_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx of the 2x2/2 max pool of NHWC ``x`` given the pooled gradient ``dy``."""
    _check(x, dy)
    if x.device.type == "cuda":
        return _launch(x, dy)
    if x.device.type == "cpu":
        return pool_bwd_plain(x, dy)
    raise ValueError(f"pool_bwd: unsupported device {x.device}")


pool_bwd.launches = 0


class _MaxPool2x2(torch.autograd.Function):
    """Forward the ``phase_pool`` kernel (floor extents, like XLA's VALID
    reduce_window, first-wins routing); backward the ``pool_bwd`` kernel,
    from the saved ``x`` alone."""

    @staticmethod
    def forward(ctx, x):
        x_nhwc = nhwc(x)
        ctx.save_for_backward(x_nhwc)
        return phase_pool(x_nhwc).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, dy):
        (x_nhwc,) = ctx.saved_tensors
        return pool_bwd(x_nhwc, nhwc(dy)).permute(0, 3, 1, 2)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of an NCHW (channels_last) tensor: the ``phase_pool``
    kernel forward, the ``pool_bwd`` kernel backward."""
    return _MaxPool2x2.apply(x)
