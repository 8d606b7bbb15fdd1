"""Minimal GeoTIFF codec — the raster substrate the reference gets from GDAL.

The port depends on no GDAL/rasterio, so it carries its own TIFF
reader/writer (classic TIFF + BigTIFF, little/big endian, strips and tiles,
uncompressed/deflate/LZW/PackBits, planar/chunky, horizontal-predictor) with
the geo metadata the reference relies on (geotransform + projection;
GDALwriteDefault copies both from the input raster,
reference data_utils.py:190-198). The codec set covers what GDAL
emits for the reference's datasets (OSCD ``*-cm.tif`` and WHU tiles are
commonly LZW or PackBits; scenes >4 GB need BigTIFF's 8-byte offsets).

Random-access semantics mirror GDAL:
  * :meth:`TiffReader.read_block` decodes only the strips/tiles covering the
    requested window (the tile-grid hot path, data_utils.py:104-105),
  * :class:`TiffWriter` creates the raster up-front and supports
    `write_block` at arbitrary offsets via a memory map (the stitched
    write-back path, data_utils.py:213), producing uncompressed chunky TIFFs
    any standard tool can open.

Geo encoding: north-up geotransforms become ModelPixelScale (33550) +
ModelTiepoint (33922); rotated transforms use ModelTransformation (34264).
The projection string travels in GeoAsciiParams (34737).
"""

from __future__ import annotations

import mmap
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

# sample format codes
_SF_UINT, _SF_INT, _SF_FLOAT = 1, 2, 3

_DTYPES = {
    (_SF_UINT, 8): np.uint8,
    (_SF_UINT, 16): np.uint16,
    (_SF_UINT, 32): np.uint32,
    (_SF_INT, 8): np.int8,
    (_SF_INT, 16): np.int16,
    (_SF_INT, 32): np.int32,
    (_SF_FLOAT, 32): np.float32,
    (_SF_FLOAT, 64): np.float64,
}
_DTYPE_TO_SF = {np.dtype(v): k for k, v in _DTYPES.items()}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4,
               12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}

GeoTransform = Tuple[float, float, float, float, float, float]


class TiffError(ValueError):
    pass


def _read_ifd_entries(buf: bytes, off: int, bo: str,
                      big: bool = False) -> Tuple[Dict[int, tuple], int]:
    """Parse one IFD. ``big`` selects BigTIFF layout: 8-byte entry counts,
    20-byte entries with 8-byte inline values, 8-byte next-IFD pointer."""
    if big:
        (count,) = struct.unpack_from(bo + "Q", buf, off)
        base, esize, inline, head_fmt, ptr_fmt = off + 8, 20, 8, "HHQ", "Q"
    else:
        (count,) = struct.unpack_from(bo + "H", buf, off)
        base, esize, inline, head_fmt, ptr_fmt = off + 2, 12, 4, "HHI", "I"
    entries = {}
    for i in range(count):
        tag, typ, n = struct.unpack_from(bo + head_fmt, buf, base + esize * i)
        val_off = base + esize * i + esize - inline
        size = _TYPE_SIZES.get(typ, 1) * n
        if size > inline:
            (ptr,) = struct.unpack_from(bo + ptr_fmt, buf, val_off)
            raw = buf[ptr : ptr + size]
        else:
            raw = buf[val_off : val_off + size]
        # copy out of the mmap: long-lived tag views would block close()
        entries[tag] = (typ, n, bytes(raw))
    (nxt,) = struct.unpack_from(bo + ptr_fmt, buf, base + esize * count)
    return entries, nxt


def _lzw_decode(data) -> bytes:
    """TIFF-flavor LZW (compression 5): MSB-first codes, 9->12 bit widths with
    the spec's "early change" (width bumps one code early), Clear=256, EOI=257.
    TIFF 6.0 section 13; the format GDAL/libtiff write by default for LZW."""
    data = bytes(data)
    out = bytearray()
    nbits = len(data) * 8
    bitpos = 0
    width = 9
    table: List[bytes] = []
    prev: Optional[bytes] = None
    while bitpos + width <= nbits:
        byte0 = bitpos >> 3
        window = int.from_bytes(data[byte0 : byte0 + 4].ljust(4, b"\0"), "big")
        code = (window >> (32 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        if code == 257:  # EOI
            break
        if code == 256:  # Clear
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            prev = None
            continue
        if prev is None:
            if not table or code >= len(table):
                raise TiffError("LZW stream did not start with Clear")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise TiffError("corrupt LZW stream")
        out += entry
        prev = entry
        if len(table) == (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _packbits_decode(data, expected: int) -> bytes:
    """PackBits RLE (compression 32773, TIFF 6.0 section 9)."""
    data = bytes(data)
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 128:  # literal run of ctrl+1 bytes
            out += data[i : i + ctrl + 1]
            i += ctrl + 1
        elif ctrl > 128:  # repeat next byte 257-ctrl times
            out += data[i : i + 1] * (257 - ctrl)
            i += 1
        # ctrl == 128: no-op
    return bytes(out)


def _values(entry: tuple, bo: str):
    typ, n, raw = entry
    if typ == 2:  # ASCII
        return bytes(raw).split(b"\0")[0].decode("latin-1")
    if typ in (5, 10):  # RATIONAL
        fmt = "II" if typ == 5 else "ii"
        out = []
        for i in range(n):
            a, b = struct.unpack_from(bo + fmt, raw, 8 * i)
            out.append(a / b if b else 0.0)
        return out
    fmt = _TYPE_FMT.get(typ)
    if fmt is None:
        return list(raw)
    return list(struct.unpack_from(bo + fmt * n, raw, 0))


class TiffReader:
    """Random-access reader for classic TIFF/GeoTIFF rasters."""

    def __init__(self, path: str):
        self.path = path
        # memory-map instead of reading: arbitrarily large scenes (the
        # reference streams via GDAL; loading a 10k x 10k multiband raster
        # into RAM would defeat the tiled design)
        self._file = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self._buf = memoryview(self._mm)
        except (ValueError, OSError):  # empty file etc.
            self._mm = None
            self._buf = memoryview(self._file.read())
        buf = self._buf
        if bytes(buf[:2]) == b"II":
            self._bo = "<"
        elif bytes(buf[:2]) == b"MM":
            self._bo = ">"
        else:
            raise TiffError(f"not a TIFF: {path}")
        (magic,) = struct.unpack_from(self._bo + "H", buf, 2)
        if magic == 43:  # BigTIFF: 8-byte offsets everywhere
            self._big = True
            offsize, zero = struct.unpack_from(self._bo + "HH", buf, 4)
            if offsize != 8 or zero != 0:
                raise TiffError(f"bad BigTIFF header ({offsize}, {zero})")
            (ifd_off,) = struct.unpack_from(self._bo + "Q", buf, 8)
        elif magic == 42:
            self._big = False
            (ifd_off,) = struct.unpack_from(self._bo + "I", buf, 4)
        else:
            raise TiffError(f"bad TIFF magic {magic}")
        self._tags, _ = _read_ifd_entries(buf, ifd_off, self._bo, self._big)

        t = self._tag
        self.xsize = int(t(256)[0])
        self.ysize = int(t(257)[0])
        self.nband = int(t(277, [1])[0])
        bits = t(258, [8])
        self._bits = int(bits[0])
        sf = t(339, [_SF_UINT])
        self._sf = int(sf[0])
        key = (self._sf, self._bits)
        if key not in _DTYPES:
            raise TiffError(f"unsupported sample format {key}")
        self.dtype = np.dtype(_DTYPES[key]).newbyteorder(self._bo)
        self._compression = int(t(259, [1])[0])
        if self._compression not in (1, 5, 8, 32773, 32946):
            raise TiffError(f"unsupported compression {self._compression}")
        self._predictor = int(t(317, [1])[0])
        self._planar = int(t(284, [1])[0])

        if 322 in self._tags:  # tiled
            self._tiled = True
            self._tw = int(t(322)[0])
            self._th = int(t(323)[0])
            self._offsets = [int(v) for v in t(324)]
            self._counts = [int(v) for v in t(325)]
        else:
            self._tiled = False
            self._rps = int(t(278, [self.ysize])[0])
            self._offsets = [int(v) for v in t(273)]
            self._counts = [int(v) for v in t(279)]
        self._chunk_cache: Dict[int, np.ndarray] = {}

    def _tag(self, tag: int, default=None):
        if tag in self._tags:
            return _values(self._tags[tag], self._bo)
        if default is not None:
            return default
        raise TiffError(f"missing required tag {tag}")

    # -- geo metadata -----------------------------------------------------
    @property
    def geotransform(self) -> Optional[GeoTransform]:
        if 34264 in self._tags:
            m = self._tag(34264)
            return (m[3], m[0], m[1], m[7], m[4], m[5])
        if 33550 in self._tags and 33922 in self._tags:
            sx, sy = self._tag(33550)[:2]
            tp = self._tag(33922)
            i, j, _, x, y, _ = tp[:6]
            return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)
        return None

    @property
    def projection(self) -> str:
        if 34737 in self._tags:
            return self._tag(34737).rstrip("|")
        return ""

    # -- pixel access -----------------------------------------------------
    def _decode_chunk(self, idx: int) -> np.ndarray:
        """Decode chunk idx -> (h, w, bands_in_chunk) array."""
        if idx in self._chunk_cache:
            return self._chunk_cache[idx]
        raw = self._buf[self._offsets[idx] : self._offsets[idx] + self._counts[idx]]
        spp = self.nband if self._planar == 1 else 1
        if self._tiled:
            h, w = self._th, self._tw
        else:
            w = self.xsize
            per_band_strips = (self.ysize + self._rps - 1) // self._rps
            row0 = (idx % per_band_strips) * self._rps
            h = min(self._rps, self.ysize - row0)
        if self._compression in (8, 32946):
            raw = zlib.decompress(raw)
        elif self._compression == 5:
            raw = _lzw_decode(raw)
        elif self._compression == 32773:
            raw = _packbits_decode(raw, h * w * spp * self.dtype.itemsize)
        arr = np.frombuffer(raw, dtype=self.dtype, count=h * w * spp).reshape(h, w, spp)
        if self._predictor == 2:
            arr = np.cumsum(arr.astype(np.int64), axis=1).astype(self.dtype)
        if len(self._chunk_cache) > 32:
            self._chunk_cache.clear()
        self._chunk_cache[idx] = arr
        return arr

    def read_block(self, xoff: int = 0, yoff: int = 0, w: Optional[int] = None,
                   h: Optional[int] = None) -> np.ndarray:
        """Window -> (h, w, nband) array, decoding only covering chunks."""
        w = self.xsize - xoff if w is None else w
        h = self.ysize - yoff if h is None else h
        if xoff < 0 or yoff < 0 or xoff + w > self.xsize or yoff + h > self.ysize:
            raise TiffError("window out of bounds")
        native = self.dtype.newbyteorder("=")
        out = np.empty((h, w, self.nband), native)

        if self._tiled:
            tx0, tx1 = xoff // self._tw, (xoff + w - 1) // self._tw
            ty0, ty1 = yoff // self._th, (yoff + h - 1) // self._th
            tiles_across = (self.xsize + self._tw - 1) // self._tw
            tiles_down = (self.ysize + self._th - 1) // self._th
            nplanes = self.nband if self._planar == 2 else 1
            for p in range(nplanes):
                for ty in range(ty0, ty1 + 1):
                    for tx in range(tx0, tx1 + 1):
                        idx = p * tiles_down * tiles_across + ty * tiles_across + tx
                        chunk = self._decode_chunk(idx)
                        gy0 = max(yoff, ty * self._th)
                        gy1 = min(yoff + h, (ty + 1) * self._th)
                        gx0 = max(xoff, tx * self._tw)
                        gx1 = min(xoff + w, (tx + 1) * self._tw)
                        src = chunk[gy0 - ty * self._th : gy1 - ty * self._th,
                                    gx0 - tx * self._tw : gx1 - tx * self._tw]
                        if self._planar == 2:
                            out[gy0 - yoff : gy1 - yoff, gx0 - xoff : gx1 - xoff, p] = src[..., 0]
                        else:
                            out[gy0 - yoff : gy1 - yoff, gx0 - xoff : gx1 - xoff, :] = src
        else:
            per_band_strips = (self.ysize + self._rps - 1) // self._rps
            nplanes = self.nband if self._planar == 2 else 1
            for p in range(nplanes):
                s0, s1 = yoff // self._rps, (yoff + h - 1) // self._rps
                for s in range(s0, s1 + 1):
                    idx = p * per_band_strips + s
                    chunk = self._decode_chunk(idx)
                    gy0 = max(yoff, s * self._rps)
                    gy1 = min(yoff + h, s * self._rps + chunk.shape[0])
                    src = chunk[gy0 - s * self._rps : gy1 - s * self._rps, xoff : xoff + w]
                    if self._planar == 2:
                        out[gy0 - yoff : gy1 - yoff, :, p] = src[..., 0]
                    else:
                        out[gy0 - yoff : gy1 - yoff, :, :] = src
        return out

    def read_band(self, band: int, xoff: int = 0, yoff: int = 0,
                  w: Optional[int] = None, h: Optional[int] = None) -> np.ndarray:
        return self.read_block(xoff, yoff, w, h)[..., band]

    def close(self):
        self._chunk_cache.clear()
        self._buf = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._file.close()

    def __del__(self):
        try:
            if getattr(self, "_mm", None) is not None or not self._file.closed:
                self.close()
        except Exception:
            pass


def _pack_entry(bo, tag, typ, values, heap: List[bytes], heap_base: int,
                big: bool = False):
    if typ == 2:  # ascii
        data = values.encode("latin-1") + b"\0"
        n = len(data)
    else:
        fmt = _TYPE_FMT[typ]
        data = struct.pack(bo + fmt * len(values), *values)
        n = len(values)
    inline = 8 if big else 4
    head_fmt = "HHQ" if big else "HHI"
    ptr_fmt = "Q" if big else "I"
    if len(data) <= inline:
        return struct.pack(bo + head_fmt, tag, typ, n) + data.ljust(inline, b"\0"), None
    ptr = heap_base + sum(len(h) for h in heap)
    heap.append(data if len(data) % 2 == 0 else data + b"\0")
    return struct.pack(bo + head_fmt + ptr_fmt, tag, typ, n, ptr), data


class TiffWriter:
    """Create a chunky uncompressed TIFF and write blocks at random offsets."""

    def __init__(
        self,
        path: str,
        xsize: int,
        ysize: int,
        nband: int = 1,
        dtype=np.float32,
        geotransform: Optional[GeoTransform] = None,
        projection: str = "",
        big_tiff: Optional[bool] = None,
    ):
        self.path = path
        self.xsize, self.ysize, self.nband = xsize, ysize, nband
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_TO_SF:
            raise TiffError(f"unsupported dtype {dtype}")
        sf, bits = _DTYPE_TO_SF[self.dtype]
        bo = "<"
        self._bo = bo
        bpp = bits // 8
        row_bytes = xsize * nband * bpp
        # one strip per row: random-access offsets are pure arithmetic
        nstrips = ysize
        if big_tiff is None:  # auto: classic TIFF offsets are 32-bit
            big_tiff = row_bytes * ysize > 2**32 - 2**16
        self.big_tiff = big = bool(big_tiff)
        # offsets/counts as LONG8 in BigTIFF so >4 GB rasters address fully
        off_typ = 16 if big else 4

        # photometric: RGB for >=3 bands (PIL/most viewers expect it),
        # BlackIsZero otherwise; bands beyond 3 are unspecified extra samples
        photometric = 2 if nband >= 3 else 1
        tags: List[Tuple[int, int, object]] = [
            (256, 4, [xsize]),
            (257, 4, [ysize]),
            (258, 3, [bits] * nband),
            (259, 3, [1]),
            (262, 3, [photometric]),
            (277, 3, [nband]),
            (278, 4, [1]),
            (284, 3, [1]),
            (339, 3, [sf] * nband),
        ]
        if nband > 3:
            tags.append((338, 3, [0] * (nband - 3)))
        if geotransform is not None:
            gt = geotransform
            if gt[2] == 0.0 and gt[4] == 0.0:
                tags.append((33550, 12, [gt[1], -gt[5], 0.0]))
                tags.append((33922, 12, [0.0, 0.0, 0.0, gt[0], gt[3], 0.0]))
            else:
                m = [gt[1], gt[2], 0.0, gt[0],
                     gt[4], gt[5], 0.0, gt[3],
                     0.0, 0.0, 0.0, 0.0,
                     0.0, 0.0, 0.0, 1.0]
                tags.append((34264, 12, m))
        if projection:
            tags.append((34737, 2, projection + "|"))

        tags.append((273, off_typ, [0] * nstrips))  # placeholder, re-packed below
        tags.append((279, off_typ, [row_bytes] * nstrips))
        tags.sort(key=lambda e: e[0])

        n_entries = len(tags)
        if big:
            ifd_off = 16
            heap_base = ifd_off + 8 + 20 * n_entries + 8
        else:
            ifd_off = 8
            heap_base = ifd_off + 2 + 12 * n_entries + 4

        # pass 1: compute heap layout (entry sizes depend only on counts)
        heap: List[bytes] = []
        for tag, typ, vals in tags:
            _pack_entry(bo, tag, typ, vals, heap, heap_base, big)
        data_start = heap_base + sum(len(h) for h in heap)

        # pass 2: re-pack everything with the real strip offsets
        offsets = [data_start + i * row_bytes for i in range(nstrips)]
        tags = [(273, off_typ, offsets) if t == 273 else (t, ty, v) for t, ty, v in tags]
        heap = []
        entry_bufs = []
        for tag, typ, vals in tags:
            buf, _ = _pack_entry(bo, tag, typ, vals, heap, heap_base, big)
            entry_bufs.append(buf)

        if big:
            header = struct.pack(bo + "2sHHHQ", b"II", 43, 8, 0, ifd_off)
            ifd = (struct.pack(bo + "Q", n_entries) + b"".join(entry_bufs)
                   + struct.pack(bo + "Q", 0))
        else:
            header = struct.pack(bo + "2sHI", b"II", 42, ifd_off)
            ifd = (struct.pack(bo + "H", n_entries) + b"".join(entry_bufs)
                   + struct.pack(bo + "I", 0))
        total = data_start + row_bytes * ysize

        with open(path, "wb") as f:
            f.write(header)
            f.write(ifd)
            for hbuf in heap:
                f.write(hbuf)
            f.truncate(total)
        self._data_start = data_start
        self._row_bytes = row_bytes
        self._f = open(path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), total)
        self._view = np.frombuffer(
            self._mm, dtype=self.dtype, count=xsize * ysize * nband, offset=data_start
        ).reshape(ysize, xsize, nband)
        self._view.setflags(write=True)

    def write_block(self, arr: np.ndarray, xoff: int = 0, yoff: int = 0, band: Optional[int] = None):
        """Write (h, w) single-band or (h, w, nband) chunky block at offset."""
        if arr.ndim == 2:
            h, w = arr.shape
            if band is None:
                if self.nband != 1:
                    raise TiffError("2-D block on multi-band raster needs band=")
                band = 0
            self._view[yoff : yoff + h, xoff : xoff + w, band] = arr.astype(self.dtype)
        else:
            h, w, b = arr.shape
            if b != self.nband:
                raise TiffError("band count mismatch")
            self._view[yoff : yoff + h, xoff : xoff + w, :] = arr.astype(self.dtype)

    def close(self):
        if self._mm is not None:
            self._mm.flush()
            del self._view
            self._mm.close()
            self._f.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
