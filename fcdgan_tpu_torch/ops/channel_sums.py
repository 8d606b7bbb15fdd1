"""Per-channel f32 sums of NHWC activations on hand-written Hopper kernels:
the BatchNorm statistics.

Port of ``fcdgan_tpu/ops/pallas/channel_sums.py``: ``channel_sums`` (the
kernel ``_sum_kernel``) and ``channel_sums_pair`` (``_pair_kernel``). Both
reduce over every leading axis of a contiguous (..., C) tensor, the memory
of a channels_last NCHW activation, and return f32 per-channel sums:

  * ``channel_sums(x, square)``: sum x, and sum x^2 when ``square`` is set
    (the forward statistics of a train-mode BN);
  * ``channel_sums_pair(a, b)``: (sum a, sum a*b) (the backward's sum dy and
    sum dy*x).

The JAX kernels' lane-phase packing (``_flat_view``, C = 64 packed two
pixels per 128-lane row) is a TPU layout and not ported; the port's ``bn``
has no W-space-to-depth ``phases`` and no cross-device ``axis_name`` yet.
The kernel is ``csrc/channel_sums.cu``, one launch per call; its note says
what bounds it and what its design does about it. ``reduction_plan`` sizes
the launch to the input; each stream's ticket counter comes from
``ops.tickets``.

Each function launches its kernel for a CUDA tensor and runs the plain
version (the JAX package's ``_moment_sums`` / ``_pair_sums`` jnp branches,
fused_bn.py:52-70) for a CPU tensor; it raises on anything else, and on a
layout the kernel does not take: a non-contiguous tensor, a channel count
whose row is not a whole number of 16-byte vectors, or an unaligned base.
``channel_sums.launches`` and ``channel_sums_pair.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple, Union

import torch

from .tickets import MAX_TICKETS, sm_count, stream_and_counter

SOURCE = "channel_sums"
BLOCKS_PER_SM = 1      # resident cap of the grid (the kernel's launch bounds)
BLOCK_BYTES = 32 << 10  # input bytes a block reads, where the cap allows
THREADS = 512
MAX_CTILE = 8           # 16-byte channel vectors of a channel tile (kMaxCtile)


def channel_sums_plain(x: torch.Tensor, square: bool = False
                       ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The same function in plain PyTorch (fused_bn.py:52-59)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    if square:
        return xf.sum(0), xf.square().sum(0)
    return xf.sum(0)


def channel_sums_pair_plain(a: torch.Tensor, b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch (fused_bn.py:62-70)."""
    af = a.reshape(-1, a.shape[-1]).float()
    bf = b.reshape(-1, b.shape[-1]).float()
    return af.sum(0), (af * bf).sum(0)


def _check(name: str, *ts: torch.Tensor) -> None:
    x = ts[0]
    if x.dim() < 2:
        raise ValueError(f"{name} expects a (..., C) tensor; got {tuple(x.shape)}")
    for t in ts:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: inputs differ in shape, type or device: "
                             f"{[(tuple(u.shape), u.dtype, str(u.device)) for u in ts]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16; got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    if x.device.type != "cuda":
        return
    c = x.shape[-1]
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous (..., C) inputs "
                             "(channels_last NCHW permuted to NHWC is contiguous)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned inputs")
    if (c * x.element_size()) % 16:
        raise ValueError(f"{name}: a row of {c} {x.dtype} channels is not a whole "
                         "number of 16-byte vectors")


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    from .build import load

    lib = load(SOURCE)
    fn = lib.fcd_channel_sums_bf16 if dtype == torch.bfloat16 else lib.fcd_channel_sums_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class Plan(NamedTuple):
    """The launch of one call: per channel tile of ``ctile`` 16-byte vectors
    (``ctiles`` of them), ``blocks`` row blocks of ``rows_per_block``
    contiguous rows (the last may be shorter, none is empty), each block's
    threads ``ctile`` x ``row_lanes``; ``partial`` f32 of scratch."""
    blocks: int
    rows_per_block: int
    ctiles: int
    ctile: int
    row_lanes: int
    partial: int


@functools.lru_cache(maxsize=4096)
def reduction_plan(rows: int, c: int, itemsize: int, sms: int, inputs: int = 1,
                   nstat: int = 2) -> Plan:
    """The grid of one call over ``inputs`` (R, C) matrices: channel tiles of
    the largest power of two of vectors up to ``MAX_CTILE``, about
    ``BLOCK_BYTES`` of input per block, at most ``BLOCKS_PER_SM`` blocks per
    SM over all tiles, and each block one contiguous row range."""
    vec = 16 // itemsize
    groups = c // vec
    ctile = 1 << (min(groups, MAX_CTILE).bit_length() - 1)
    ctiles = -(-groups // ctile)
    cap = max(1, BLOCKS_PER_SM * sms // ctiles)
    want = -(-rows * ctile * 16 * inputs // BLOCK_BYTES)
    blocks = max(1, min(cap, want, rows))
    rows_per_block = -(-rows // blocks)
    blocks = -(-rows // rows_per_block)
    return Plan(blocks, rows_per_block, ctiles, ctile, THREADS // ctile,
                ctiles * blocks * nstat * ctile * vec)


def _launch(mode: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(nstat, C) f32 sums; mode 0 sum, 1 sum + sum of squares, 2 pair."""
    c = a.shape[-1]
    rows = a.numel() // c
    nstat = 1 if mode == 0 else 2
    dev = a.device
    plan = reduction_plan(rows, c, a.element_size(), sm_count(dev.index),
                          2 if mode == 2 else 1, nstat)
    if plan.ctiles > MAX_TICKETS:
        raise ValueError(f"channel_sums: {c} channels exceed the kernel's "
                         f"{MAX_TICKETS} channel tiles")
    # the sums, then the per-block partial rows: one allocation
    buf = torch.empty(nstat * c + plan.partial, dtype=torch.float32, device=dev)
    stream, counter = stream_and_counter(dev)
    status = _kernel(a.dtype)(a.data_ptr(), b.data_ptr(), buf.data_ptr(),
                              buf.data_ptr() + 4 * nstat * c, counter, rows,
                              plan.rows_per_block, c, plan.blocks, mode, stream)
    if status != 0:
        raise RuntimeError(f"channel_sums kernel launch failed: cudaError_t {status}")
    return buf[:nstat * c].view(nstat, c)


def channel_sums(x: torch.Tensor, square: bool = False
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """f32 per-channel sum over all leading axes of ``x``; with ``square``
    also the sum of squares: ``sum`` or ``(sum, sum_sq)``, each f32[C]."""
    _check("channel_sums", x)
    if x.device.type == "cuda":
        out = _launch(1 if square else 0, x, x)
        channel_sums.launches += 1
        return (out[0], out[1]) if square else out[0]
    if x.device.type == "cpu":
        return channel_sums_plain(x, square)
    raise ValueError(f"channel_sums: unsupported device {x.device}")


def channel_sums_pair(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 per-channel ``(sum(a), sum(a*b))`` over all leading axes."""
    _check("channel_sums_pair", a, b)
    if a.device.type == "cuda":
        out = _launch(2, a, b)
        channel_sums_pair.launches += 1
        return out[0], out[1]
    if a.device.type == "cpu":
        return channel_sums_pair_plain(a, b)
    raise ValueError(f"channel_sums_pair: unsupported device {a.device}")


channel_sums.launches = 0
channel_sums_pair.launches = 0
