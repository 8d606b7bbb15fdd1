"""3x3, stride-1, SAME convolution forward: hand-written Hopper kernels.

Port of ``fcdgan_tpu/ops/pallas/conv3x3.py::conv3x3_pallas`` (forward
``_conv3x3_pallas_fwd``). The JAX package kept that kernel out of its model
because Mosaic pads 64 channels to 128 on the TPU; Hopper has no such cost,
so the port routes the narrow full-resolution convolutions of the Segmentor
and the Generator through it (``models/layers.py``). The kernels are in
``csrc/conv3x3.cu``; its note says what bounds them and what their design
does about that.

Layouts stay the JAX package's at this boundary: ``x`` is NHWC (the memory
of a channels_last NCHW tensor, so the model passes ``t.permute(0, 2, 3, 1)``
with no copy), ``w`` is HWIO (3, 3, C_in, C_out), which is the
(9*C_in, C_out) im2col weight matrix when contiguous. No bias; products are
summed in f32 and the result is rounded once to ``x.dtype``.

One kernel per type (``variant``): bf16 runs ``wgmma``, an implicit GEMM on
the tensor cores (TMA loads of the activations when C_in % 8 == 0, an im2col
gather otherwise), for which the wrapper packs the weights into the kernel's
shared-memory image (``wgmma_plan``, ``pack_wgmma_weight``, kept on the
weight tensor by ``wgmma_weight_image``); f32 runs
``fma_f32`` on the CUDA cores, whose products stay full f32 for the parity
paths.

``conv3x3`` launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor; it raises on anything else. ``conv3x3.launches`` counts
kernel launches, ``conv3x3.launches_by_variant`` the launches of each
variant.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

SOURCE = "conv3x3"
MAX_C_IN = 64
MAX_C_OUT = 128
MIN_HW = 8


def gate(h: int, w: int, c_in: int, c_out: int) -> bool:
    """The JAX package's shape gate (``use_conv3x3_pallas``, conv3x3.py:64):
    narrow channels at a spatial size worth a kernel."""
    return c_in <= MAX_C_IN and c_out <= MAX_C_OUT and h >= MIN_HW and w >= MIN_HW


def variant(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel that takes a gated conv: ``wgmma`` for bf16 (every gated
    shape), ``fma_f32`` for f32."""
    if not gate(MIN_HW, MIN_HW, c_in, c_out) or c_in < 1 or c_out < 1:
        raise ValueError(f"conv3x3: C_in={c_in}, C_out={c_out} outside the gate")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fma_f32"
    raise TypeError(f"conv3x3 takes float32 or bfloat16, not {dtype}")


class WgmmaPlan(NamedTuple):
    """How the wgmma kernel walks K for one (C_in, C_out): the N tile
    ``nt`` (C_out zero-padded to 64 or 128), the loader (TMA per tap, or the
    im2col ``gather`` when C_in is not a multiple of 8, which TMA cannot
    stride) and ``n_kb`` K blocks of 64 (4 k16 steps each)."""
    nt: int
    gather: bool
    n_kb: int


def wgmma_plan(c_in: int, c_out: int) -> WgmmaPlan:
    nt = 64 if c_out <= 64 else 128
    if c_in % 8 == 0:  # one block per tap: C_in channels, TMA zero-fills to 64
        return WgmmaPlan(nt, False, 9)
    return WgmmaPlan(nt, True, -(-9 * c_in // 64))  # flat im2col K, zero-padded


@functools.lru_cache(maxsize=None)
def wgmma_weight_index(c_in: int, c_out: int, device: str = "cpu") -> torch.Tensor:
    """For each bf16 of the kernel's weight image, shape (n_kb, nt, 64): the
    flat index into the HWIO weights it holds, or 9*C_in*C_out (a zero
    appended by ``pack_wgmma_weight``). Block b, row n (output channel),
    element k of the block sits at 16-byte group (k // 8) ^ (n % 8), the
    128-byte swizzle that wgmma's K-major descriptor reads. Row k of block b
    is input channel k of tap b (TMA loader) or the flat im2col index
    64*b + k = tap*C_in + ci (gather loader)."""
    plan = wgmma_plan(c_in, c_out)
    b = torch.arange(plan.n_kb).view(-1, 1, 1)
    n = torch.arange(plan.nt).view(1, -1, 1)
    pos = torch.arange(64).view(1, 1, -1)
    k = ((pos // 8) ^ (n % 8)) * 8 + pos % 8  # logical K column held at pos
    if plan.gather:
        row, valid = 64 * b + k, 64 * b + k < 9 * c_in
    else:
        row, valid = b * c_in + k, k < c_in
    valid = valid & (n < c_out)
    return torch.where(valid, row * c_out + n, 9 * c_in * c_out).to(device)


def pack_wgmma_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO bf16 weights -> the wgmma kernel's shared-memory image
    (n_kb, nt, 64), zero-padded in K and N."""
    c_in, c_out = w.shape[2], w.shape[3]
    idx = wgmma_weight_index(c_in, c_out, str(w.device))
    return F.pad(w.detach().reshape(-1), (0, 1))[idx]


def wgmma_weight_image(w: torch.Tensor) -> torch.Tensor:
    """``pack_wgmma_weight(w)``, kept on ``w`` for as long as its storage
    and version counter stay the same: weights that do not change between
    calls (the frozen Generator, eval) are packed once. An in-place update
    (an optimizer step) bumps the version and repacks; a write through
    ``w.data`` bypasses the counter, as it does for autograd. An inference
    tensor has no counter and is packed on every call."""
    if w.is_inference():
        return pack_wgmma_weight(w)
    key = (w.data_ptr(), w._version)
    kept = getattr(w, "_wgmma_image", None)
    if kept is None or kept[0] != key:
        kept = w._wgmma_image = (key, pack_wgmma_weight(w))
    return kept[1]


def pack_weight(weight_oihw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch (C_out, C_in, 3, 3) conv weight -> contiguous HWIO in ``dtype``
    (differentiable: the caller detaches it where no gradient is wanted)."""
    return weight_oihw.permute(2, 3, 1, 0).to(dtype).contiguous()


def conv3x3_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     needs: Tuple[bool, bool] = (True, True)):
    """(dx, dw) of ``conv3x3(x, w)`` for NHWC ``x`` and ``dy`` and HWIO
    ``w`` (None where ``needs`` says so): one ``aten.convolution_backward``
    on the channels_last NCHW views, the counterpart of the XLA-conv backward
    of the JAX package's custom VJP (conv3x3.py:140-143). No kernel of the
    port: the JAX package wrote none for it either."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last),
        x.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [bool(needs[0]), bool(needs[1]), False])
    return (None if dx is None else dx.permute(0, 2, 3, 1),
            None if dw is None else dw.permute(2, 3, 1, 0))


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, mirroring the Pallas body: pad,
    nine shifted views concatenated into (N*H*W, 9*C_in), one matmul in f32."""
    n, h, wd, c_in = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + wd, :] for dy in range(3) for dx in range(3)]
    patches = torch.cat(cols, dim=-1).reshape(n * h * wd, 9 * c_in)
    wm = w.reshape(9 * c_in, w.shape[-1])
    out = patches.float() @ wm.float()
    return out.reshape(n, h, wd, -1).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3 expects x (N,H,W,C_in) and w (3,3,C_in,C_out); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c_in = x.shape
    if w.shape[2] != c_in:
        raise ValueError(f"conv3x3: x has {c_in} channels, w expects {w.shape[2]}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"conv3x3 takes float32 or bfloat16 x and w of the same "
                        f"type; got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 needs contiguous NHWC x and HWIO w "
                         "(channels_last NCHW permuted to NHWC is contiguous)")
    if not gate(h, wd, c_in, w.shape[3]):
        raise ValueError(f"conv3x3 gate: C_in <= {MAX_C_IN}, C_out <= {MAX_C_OUT}, "
                         f"H, W >= {MIN_HW}; got H={h} W={wd} C_in={c_in} "
                         f"C_out={w.shape[3]}")
    if n == 0:
        raise ValueError("conv3x3: empty batch")


_STATUS = {1001: "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint",
           1002: "the kernel does not take this plan"}


@functools.lru_cache(maxsize=None)
def _entry_points():
    """The library's two entry points with their ctypes signatures."""
    from .build import load

    lib = load(SOURCE)
    wgmma, f32 = lib.fcd_conv3x3_wgmma, lib.fcd_conv3x3_f32
    wgmma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    wgmma.restype = f32.restype = ctypes.c_int
    return wgmma, f32


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    wgmma_fn, f32_fn = _entry_points()
    n, h, wd, c_in = x.shape
    c_out = w.shape[3]
    kind = variant(x.dtype, c_in, c_out)
    y = torch.empty((n, h, wd, c_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "wgmma":
            plan = wgmma_plan(c_in, c_out)
            if not plan.gather and x.data_ptr() % 16:
                raise ValueError("conv3x3: TMA needs x.data_ptr() 16-byte aligned")
            if n * 9 * -(-h // 8) * -(-wd // 8) >= 2 ** 31:  # 8x8 tiles x K blocks
                raise ValueError(f"conv3x3: batch {n} exceeds the kernel's tile count")
            wimg = wgmma_weight_image(w)
            status = wgmma_fn(x.data_ptr(), wimg.data_ptr(), y.data_ptr(), n, h, wd, c_in,
                              c_out, plan.nt, int(plan.gather), plan.n_kb, stream)
        else:
            if n * -(-c_out // 64) > 65535:
                raise ValueError(f"conv3x3: batch {n} exceeds the kernel's grid")
            status = f32_fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c_in, c_out,
                            stream)
    if status != 0:
        what = _STATUS.get(status) or (f"cuTensorMapEncodeTiled returned CUresult {status - 2000}"
                                       if status >= 2000 else f"cudaError_t {status}")
        raise RuntimeError(f"conv3x3 {kind} kernel launch failed: {what}")
    conv3x3.launches += 1
    conv3x3.launches_by_variant[kind] += 1
    return y


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv of NHWC ``x`` with HWIO ``w``, no bias."""
    _check(x, w)
    if x.device.type == "cuda":
        return _launch(x, w)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    raise ValueError(f"conv3x3: unsupported device {x.device}")


conv3x3.launches = 0
conv3x3.launches_by_variant = {"wgmma": 0, "fma_f32": 0}
