"""3x3, stride-1, SAME convolution forward: a hand-written Hopper kernel.

Port of ``fcdgan_tpu/ops/pallas/conv3x3.py::conv3x3_pallas`` (forward
``_conv3x3_pallas_fwd``). The JAX package kept that kernel out of its model
because Mosaic pads 64 channels to 128 on the TPU; Hopper has no such cost,
so the port routes the narrow full-resolution convolutions of the Segmentor
through it (``models/layers.py``). The kernel is ``csrc/conv3x3.cu``; its
note says what bounds it and what its design does about that.

Layouts stay the JAX package's at this boundary: ``x`` is NHWC (the memory
of a channels_last NCHW tensor, so the model passes ``t.permute(0, 2, 3, 1)``
with no copy), ``w`` is HWIO (3, 3, C_in, C_out), which is the kernel's
(9*C_in, C_out) im2col weight matrix when contiguous. No bias; products are
summed in f32 and the result is rounded once to ``x.dtype``.

``conv3x3`` launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor; it raises on anything else. ``conv3x3.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

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


def pack_weight(weight_oihw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch (C_out, C_in, 3, 3) conv weight -> contiguous HWIO in ``dtype``."""
    return weight_oihw.detach().permute(2, 3, 1, 0).to(dtype).contiguous()


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


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    from .build import load

    lib = load(SOURCE)
    fn = lib.fcd_conv3x3_bf16 if x.dtype == torch.bfloat16 else lib.fcd_conv3x3_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, h, wd, c_in = x.shape
    c_out = w.shape[3]
    if n * -(-c_out // 64) > 65535:
        raise ValueError(f"conv3x3: batch {n} exceeds the kernel's grid")
    y = torch.empty((n, h, wd, c_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c_in,
                    c_out, stream)
    if status != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError_t {status}")
    conv3x3.launches += 1
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
