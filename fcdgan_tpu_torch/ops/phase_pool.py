"""Forward of the 2x2/2 max pool on a hand-written Hopper kernel.

Port of ``fcdgan_tpu/ops/pallas/phase_pool.py``: ``phase_pool_forward`` (the
kernel ``_phase_pool_kernel``). The JAX function takes the W-space-to-depth
view (N, H, W/2, 2C) of an activation and returns the first-wins maximum of
its two channel halves (the even and the odd column), then of each pair of
rows, as (N, H/2, W/2, C). The port keeps every activation in NHWC memory
(channels_last), where that view is free: ``x.view(N, H, W//2, 2C)`` for an
even W; for an odd W the last column is left out and the row stride stays
W*C. So ``phase_pool`` is the port's 2x2 max-pool forward, with the routing
of its backward ``pool_bwd``: first-wins on W, then on H. The JAX package
runs its kernel only under ``FCDGAN_PHASE_POOL=pallas`` in its s2d VGG
layout; every max pool of the port (the Segmentor's ``Down`` pools and the
VGG pools) runs this one. It is ``csrc/phase_pool.cu``; its note says what
bounds it and what its design does about that.

``phase_pool`` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; it raises on anything else, and on a layout the
kernel does not take: a non-contiguous tensor, a channel count whose row is
not a whole number of 16-byte vectors, or an unaligned base.
``phase_pool.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "phase_pool"


def phase_pool_plain(x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, step for step the JAX package's
    ``phase_pool_reference`` (phase_pool.py:137-144) on the phase view."""
    n, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    v = x[:, :, :2 * wo, :].reshape(n, h, wo, 2 * c)  # the (N, H, W/2, 2C) view
    a, b = v[..., :c], v[..., c:]
    m = torch.where(a >= b, a, b)
    return m[:, :2 * ho].reshape(n, ho, 2, wo, c).amax(dim=2)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"phase_pool expects NHWC x; got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"phase_pool takes float32 or bfloat16; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("phase_pool needs contiguous NHWC x "
                         "(channels_last NCHW permuted to NHWC is contiguous)")
    if x.device.type != "cuda":
        return
    if x.data_ptr() % 16:
        raise ValueError("phase_pool needs a 16-byte aligned x")
    if (x.shape[-1] * x.element_size()) % 16:
        raise ValueError(f"phase_pool: a row of {x.shape[-1]} {x.dtype} channels is not "
                         "a whole number of 16-byte vectors")


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    from .build import load

    lib = load(SOURCE)
    fn = lib.fcd_phase_pool_bf16 if dtype == torch.bfloat16 else lib.fcd_phase_pool_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor) -> torch.Tensor:
    fn = _kernel(x.dtype)
    n, h, w, c = x.shape
    y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), y.data_ptr(), n, h, w, c, stream)
    if status != 0:
        raise RuntimeError(f"phase_pool kernel launch failed: cudaError_t {status}")
    phase_pool.launches += 1
    return y


def phase_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool (floor extents) of NHWC ``x``: (N, H//2, W//2, C)."""
    _check(x)
    if x.device.type == "cuda":
        return _launch(x)
    if x.device.type == "cpu":
        return phase_pool_plain(x)
    raise ValueError(f"phase_pool: unsupported device {x.device}")


phase_pool.launches = 0
