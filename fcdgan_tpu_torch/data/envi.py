"""ENVI raster codec (header .hdr + raw binary cube).

The OSCD preparation path stores each scene's two Sentinel-2 images as ENVI
files (extension-less binary + .hdr; reference OSCDProcess.py:22-29 and
the discovery rule at data_utils.py:322). This codec reads/writes BSQ/BIL/BIP
interleaves with the standard ENVI data-type codes via numpy memmap — random
window reads without loading the scene.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

_ENVI_DTYPES = {
    1: np.uint8, 2: np.int16, 3: np.int32, 4: np.float32, 5: np.float64,
    12: np.uint16, 13: np.uint32, 14: np.int64, 15: np.uint64,
}
_DTYPE_TO_ENVI = {np.dtype(v): k for k, v in _ENVI_DTYPES.items()}


def _parse_hdr(path: str) -> Dict[str, str]:
    with open(path, "r") as f:
        text = f.read()
    fields: Dict[str, str] = {}
    key = None
    buf = ""
    depth = 0
    for line in text.splitlines():
        line = line.strip()
        if not line or line.lower() == "envi":
            continue
        if depth == 0 and "=" in line:
            key, val = line.split("=", 1)
            key = key.strip().lower()
            val = val.strip()
            depth = val.count("{") - val.count("}")
            buf = val
            if depth == 0:
                fields[key] = buf.strip("{} ")
        else:
            depth += line.count("{") - line.count("}")
            buf += " " + line
            if depth == 0 and key:
                fields[key] = buf.strip("{} ")
    return fields


def hdr_path_for(data_path: str) -> str:
    for cand in (data_path + ".hdr", os.path.splitext(data_path)[0] + ".hdr"):
        if os.path.exists(cand):
            return cand
    return data_path + ".hdr"


class EnviReader:
    """Window reads over a memory-mapped ENVI cube."""

    def __init__(self, path: str):
        self.path = path
        hdr = _parse_hdr(hdr_path_for(path))
        self.xsize = int(hdr["samples"])
        self.ysize = int(hdr["lines"])
        self.nband = int(hdr["bands"])
        code = int(hdr["data type"])
        if code not in _ENVI_DTYPES:
            raise ValueError(f"unsupported ENVI data type {code}")
        base = np.dtype(_ENVI_DTYPES[code])
        byte_order = int(hdr.get("byte order", "0"))
        self.dtype = base.newbyteorder(">" if byte_order == 1 else "<")
        self.interleave = hdr.get("interleave", "bsq").lower()
        offset = int(hdr.get("header offset", "0"))
        shape = {
            "bsq": (self.nband, self.ysize, self.xsize),
            "bil": (self.ysize, self.nband, self.xsize),
            "bip": (self.ysize, self.xsize, self.nband),
        }[self.interleave]
        self._mm = np.memmap(path, dtype=self.dtype, mode="r", offset=offset, shape=shape)
        # geo metadata (map info = {proj, refx, refy, x, y, sx, sy, ...})
        self.geotransform = None
        self.projection = hdr.get("coordinate system string", "")
        if "map info" in hdr:
            parts = [p.strip() for p in hdr["map info"].split(",")]
            try:
                refx, refy = float(parts[1]), float(parts[2])
                x, y = float(parts[3]), float(parts[4])
                sx, sy = float(parts[5]), float(parts[6])
                self.geotransform = (x - (refx - 1) * sx, sx, 0.0, y + (refy - 1) * sy, 0.0, -sy)
            except (IndexError, ValueError):
                pass

    def read_block(self, xoff: int = 0, yoff: int = 0, w: Optional[int] = None,
                   h: Optional[int] = None) -> np.ndarray:
        w = self.xsize - xoff if w is None else w
        h = self.ysize - yoff if h is None else h
        if self.interleave == "bsq":
            block = self._mm[:, yoff : yoff + h, xoff : xoff + w]
            out = np.moveaxis(block, 0, -1)
        elif self.interleave == "bil":
            block = self._mm[yoff : yoff + h, :, xoff : xoff + w]
            out = np.moveaxis(block, 1, -1)
        else:
            out = self._mm[yoff : yoff + h, xoff : xoff + w, :]
        return np.ascontiguousarray(out).astype(self.dtype.newbyteorder("="))

    def read_band(self, band: int, xoff: int = 0, yoff: int = 0,
                  w: Optional[int] = None, h: Optional[int] = None) -> np.ndarray:
        return self.read_block(xoff, yoff, w, h)[..., band]


def write_envi(
    path: str,
    data: np.ndarray,
    interleave: str = "bsq",
    geotransform=None,
    projection: str = "",
) -> None:
    """Write an (h, w, nband) cube as ENVI data + .hdr."""
    h, w, nb = data.shape
    dt = np.dtype(data.dtype)
    if dt not in _DTYPE_TO_ENVI:
        raise ValueError(f"unsupported dtype {dt}")
    cube = {
        "bsq": np.moveaxis(data, -1, 0),
        "bil": np.moveaxis(data, -1, 1),
        "bip": data,
    }[interleave]
    np.ascontiguousarray(cube).tofile(path)
    lines = [
        "ENVI",
        f"samples = {w}",
        f"lines = {h}",
        f"bands = {nb}",
        "header offset = 0",
        "file type = ENVI Standard",
        f"data type = {_DTYPE_TO_ENVI[dt]}",
        f"interleave = {interleave}",
        "byte order = 0",
    ]
    if geotransform is not None:
        gt = geotransform
        lines.append(
            "map info = {{Arbitrary, 1, 1, {}, {}, {}, {}}}".format(gt[0], gt[3], gt[1], -gt[5])
        )
    if projection:
        lines.append("coordinate system string = {%s}" % projection)
    with open(hdr_path_for(path) if os.path.exists(hdr_path_for(path)) else path + ".hdr", "w") as f:
        f.write("\n".join(lines) + "\n")
