"""Synthetic bi-temporal rasters from a seed, and the few TIFF files the
benchmark writes and reads itself.

``scene_pair`` and ``slices`` follow the generator of the program's
``data/synthetic.py``, drawn on the device from a ``torch.Generator`` in a
few large calls: image Y is a smooth band mix of image X plus noise, with a
strong offset inside the change rectangles. ``write_tiff`` writes a classic
little-endian, uncompressed, chunky TIFF (one strip, with a north-up
GeoTIFF pixel scale and tie point); ``read_tiff`` reads such a file, or the
one-strip-a-row files the program writes.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np
import torch

Rect = Tuple[int, int, int, int]  # (x, y, w, h)

_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}
_DTYPES = {(1, 8): np.uint8, (1, 16): np.uint16, (2, 16): np.int16, (3, 32): np.float32,
           (3, 64): np.float64}


def _pairs(gen: torch.Generator, shape, nband: int, device):
    """(x, y) float32 of ``shape`` + (nband,): x smoothed Gaussian noise
    around 100, y its band mix plus 5 and unit noise (the change offsets
    not yet added)."""
    base = torch.randn((*shape, nband), generator=gen, device=device) * 30.0 + 100.0
    h, w = len(shape) - 2, len(shape) - 1  # the row and column axes
    for _ in range(2):  # smooth spatial structure
        base.narrow(h, 1, shape[h] - 1).copy_(
            0.5 * base.narrow(h, 1, shape[h] - 1) + 0.5 * base.narrow(h, 0, shape[h] - 1))
        base.narrow(w, 1, shape[w] - 1).copy_(
            0.5 * base.narrow(w, 1, shape[w] - 1) + 0.5 * base.narrow(w, 0, shape[w] - 1))
    mix = torch.eye(nband, device=device) * 0.9 + 0.1 / nband
    y = base @ mix + 5.0 + torch.randn(base.shape, generator=gen, device=device)
    return base, y


def scene_pair(gen: torch.Generator, ysize: int, xsize: int, nband: int,
               rects: Sequence[Rect], dtype=np.uint16):
    """(x, y, change_mask): images rounded to ``dtype`` and a uint8 mask,
    on the host, made on the generator's device."""
    x, y = _pairs(gen, (ysize, xsize), nband, gen.device)
    mask = np.zeros((ysize, xsize), np.uint8)
    for rx, ry, rw, rh in rects:
        mask[ry:ry + rh, rx:rx + rw] = 1
        y[ry:ry + rh, rx:rx + rw] += 80.0
    return as_type(x, dtype), as_type(y, dtype), mask


def slices(gen: torch.Generator, n: int, size: int, nband: int, changed: bool,
           dtype=np.uint8, chunk: int = 100):
    """``n`` WHU-shaped slice pairs (x, y, masks) as ``scene_pair`` makes a
    scene, each slice with a brightness offset of its own (uniform in +-40)
    and, when ``changed``, one change rectangle of its own (sides from a
    tenth to half the slice, anywhere in it); made ``chunk`` at a time."""
    xs, ys, masks = [], [], []
    dev = gen.device
    grid = torch.arange(size, device=dev)
    for start in range(0, n, chunk):
        k = min(chunk, n - start)
        x, y = _pairs(gen, (k, size, size), nband, dev)
        off = (torch.rand((k, 1, 1, 1), generator=gen, device=dev) - 0.5) * 80.0
        x += off
        y += off
        mask = torch.zeros((k, size, size), dtype=torch.bool, device=dev)
        if changed:
            side = (size * (0.1 + 0.4 * torch.rand((k, 2), generator=gen, device=dev))).long()
            corner = ((size - side) * torch.rand((k, 2), generator=gen, device=dev)).long()
            rows = (grid.view(1, -1) >= corner[:, :1]) & (grid.view(1, -1) < corner[:, :1] + side[:, :1])
            cols = (grid.view(1, -1) >= corner[:, 1:]) & (grid.view(1, -1) < corner[:, 1:] + side[:, 1:])
            mask = rows[:, :, None] & cols[:, None, :]
            y += 80.0 * mask[..., None]
        xs.append(as_type(x, dtype))
        ys.append(as_type(y, dtype))
        masks.append(mask.cpu().numpy().astype(np.uint8))
    return np.concatenate(xs), np.concatenate(ys), np.concatenate(masks)


def as_type(img: torch.Tensor, dtype) -> np.ndarray:
    """Rounded and clipped to an integer type, as stored rasters are, on the
    host."""
    info = np.iinfo(dtype)
    return img.round().clamp(info.min, info.max).cpu().numpy().astype(dtype)


def write_tiff(path: str, arr: np.ndarray, geo: Tuple[float, float, float, float] = (
        300000.0, 5000000.0, 10.0, 10.0)) -> None:
    """(H, W) or (H, W, C) array -> TIFF; ``geo`` = (x0, y0, dx, dy)."""
    a = np.ascontiguousarray(arr if arr.ndim == 3 else arr[..., None])
    h, w, c = a.shape
    bits = a.dtype.itemsize * 8
    sf = _SAMPLE_FORMAT[a.dtype.kind]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c), (259, 3, [1]),
               (262, 3, [2 if c == 3 else 1]), (273, 4, [0]), (277, 3, [c]),
               (278, 4, [h]), (279, 4, [a.nbytes]), (284, 3, [1]), (339, 3, [sf] * c),
               (33550, 12, [geo[2], geo[3], 0.0]),
               (33922, 12, [0.0, 0.0, 0.0, geo[0], geo[1], 0.0])]
    fmt = {3: "H", 4: "I", 12: "d"}
    ifd_off = 8
    heap_off = ifd_off + 2 + 12 * len(entries) + 4
    heap = b""
    packed = []
    for tag, typ, vals in entries:
        data = struct.pack("<%d%s" % (len(vals), fmt[typ]), *vals)
        if len(data) <= 4:
            packed.append((tag, typ, len(vals), data.ljust(4, b"\0")))
        else:
            packed.append((tag, typ, len(vals), struct.pack("<I", heap_off + len(heap))))
            heap += data
    data_off = heap_off + len(heap)
    out = bytearray(struct.pack("<2sHI", b"II", 42, ifd_off))
    out += struct.pack("<H", len(packed))
    for tag, typ, count, val in packed:
        if tag == 273:
            val = struct.pack("<I", data_off)
        out += struct.pack("<HHI", tag, typ, count) + val
    out += struct.pack("<I", 0) + heap
    with open(path, "wb") as f:
        f.write(bytes(out))
        f.write(a.tobytes())


def read_tiff(path: str) -> np.ndarray:
    """An uncompressed, chunky, classic little-endian TIFF -> (H, W, C)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"II*\0":
        raise ValueError(f"{path}: not a classic little-endian TIFF")
    (ifd,) = struct.unpack_from("<I", buf, 4)
    (n,) = struct.unpack_from("<H", buf, ifd)
    sizes = {3: 2, 4: 4, 12: 8, 16: 8}
    fmt = {3: "H", 4: "I", 12: "d", 16: "Q"}
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from("<HHI", buf, ifd + 2 + 12 * i)
        if typ not in fmt:
            continue
        pos = ifd + 2 + 12 * i + 8
        if sizes[typ] * count > 4:
            (pos,) = struct.unpack_from("<I", buf, pos)
        tags[tag] = struct.unpack_from("<%d%s" % (count, fmt[typ]), buf, pos)
    if tags.get(259, (1,))[0] != 1 or tags.get(284, (1,))[0] != 1:
        raise ValueError(f"{path}: compressed or planar TIFF")
    w, h, c = tags[256][0], tags[257][0], tags.get(277, (1,))[0]
    dtype = np.dtype(_DTYPES[(tags.get(339, (1,))[0], tags[258][0])]).newbyteorder("<")
    data = b"".join(buf[o:o + k] for o, k in zip(tags[273], tags[279]))
    return np.frombuffer(data, dtype, count=h * w * c).reshape(h, w, c)
