"""ctypes bindings of the native tile I/O library (``native/tileio.cpp``).

The port's own copy of the JAX package's ``native/__init__.py`` (:28-261).
The library is built with g++ at first use, never at import
(``ops/build.host_library``: ``_build/libtileio-<hash>.so``, written under a
temporary name and moved into place, so processes building at once each load
a whole library). A failed build raises ``KernelBuildError`` with g++'s
output; ``native_available()`` is the explicit availability check the feeds
choose by, and ``build_error()`` says why it is False. ``can_open(path)``
probes whether the library reads a raster (TIFF or ENVI; a PNG slice is not
one).

  * ``NativeRaster``: window reads into float32 (h, w, nband) arrays.
  * ``read_files_f32``: threaded whole-image reads of uniform slice files,
    optionally normalized per band (the WHU slice sets).
  * ``NativePairAssembler``: threaded batch assembly of a scene pair's
    zero-padded tile canvases, normalized float32 (``assemble``) or in the
    rasters' stored type (``assemble_raw``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from ..ops.build import KernelBuildError, host_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tileio.cpp")

#: DType enum codes of tileio.cpp -> numpy types
DTYPE_CODES = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
               4: np.uint32, 5: np.int32, 6: np.float32, 7: np.float64}
INTEGRAL_CODES = (0, 1, 2, 3, 4, 5)

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lock = threading.Lock()

_I64 = ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PD = ctypes.POINTER(ctypes.c_double)
_PF = ctypes.POINTER(ctypes.c_float)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tio_open.restype = _I64
    lib.tio_open.argtypes = [ctypes.c_char_p]
    lib.tio_info.argtypes = [_I64, _PI64, _PI64, _PI64]
    lib.tio_dtype.restype = ctypes.c_int
    lib.tio_dtype.argtypes = [_I64]
    lib.tio_read_window_f32.restype = ctypes.c_int
    lib.tio_read_window_f32.argtypes = [_I64, _I64, _I64, _I64, _I64, _PF]
    lib.tio_assemble_batch.restype = ctypes.c_int
    lib.tio_assemble_batch.argtypes = [_I64, _I64, _PI64, _I64, _I64, _I64, _I64, _I64,
                                       _PD, _PD, _PD, _PD, _PF, _PF, ctypes.c_int]
    lib.tio_assemble_batch_raw.restype = ctypes.c_int
    lib.tio_assemble_batch_raw.argtypes = [_I64, _I64, _PI64, _I64, _I64, _I64, _I64, _I64,
                                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.tio_read_files_f32.restype = ctypes.c_int
    lib.tio_read_files_f32.argtypes = [ctypes.POINTER(ctypes.c_char_p), _I64, _I64, _I64,
                                       _I64, _PD, _PD, _PF, ctypes.c_int]
    lib.tio_close.argtypes = [_I64]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises
    ``KernelBuildError`` (with g++'s output) when it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is None:
            if _error is not None:
                raise KernelBuildError(_error)
            try:
                _lib = _bind(ctypes.CDLL(host_library(SOURCE)))
            except (KernelBuildError, OSError) as e:
                _error = str(e)
                raise KernelBuildError(_error) from e
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (built at the first call)."""
    try:
        load()
    except KernelBuildError:
        return False
    return True


def build_error() -> Optional[str]:
    """Why ``native_available()`` is False (None when it is True)."""
    native_available()
    return _error


def can_open(path: str) -> bool:
    """Whether the library is available and reads the raster at ``path``."""
    if not native_available():
        return False
    h = _lib.tio_open(path.encode())
    if h:
        _lib.tio_close(h)
    return bool(h)


def _threads(n_threads: Optional[int]) -> int:
    return n_threads or min(8, os.cpu_count() or 4)


def _dptr(a: Optional[np.ndarray]):
    return _PD() if a is None else a.ctypes.data_as(_PD)


def _bands(v, nband: int) -> Optional[np.ndarray]:
    return None if v is None else np.ascontiguousarray(np.asarray(v, np.float64)[:nband])


class NativeRaster:
    """Window reads through the C++ reader."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.tio_open(path.encode())
        if self._h == 0:
            raise ValueError(f"native tileio cannot open {path}")
        xs, ys, nb = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.tio_info(self._h, ctypes.byref(xs), ctypes.byref(ys), ctypes.byref(nb))
        self.xsize, self.ysize, self.nband = xs.value, ys.value, nb.value
        self.dtype_code = int(self._lib.tio_dtype(self._h))
        self.dtype = np.dtype(DTYPE_CODES.get(self.dtype_code, np.float32))
        self.path = path

    def read_block(self, xoff=0, yoff=0, w=None, h=None) -> np.ndarray:
        w = self.xsize - xoff if w is None else w
        h = self.ysize - yoff if h is None else h
        out = np.empty((h, w, self.nband), np.float32)
        rc = self._lib.tio_read_window_f32(self._h, xoff, yoff, w, h, out.ctypes.data_as(_PF))
        if rc != 0:
            raise ValueError(f"native read of {self.path} failed (rc {rc})")
        return out

    def close(self):
        if self._h:
            self._lib.tio_close(self._h)
            self._h = 0

    def __del__(self):
        self.close()


def read_files_f32(paths: Sequence[str], height: int, width: int, nband: int,
                   mean=None, std=None, n_threads: Optional[int] = None) -> np.ndarray:
    """Threaded whole-image reads of uniform slice files into one (n, height,
    width, nband) float32 batch, per-band ``(v - mean) / std`` when given."""
    lib = load()
    n = len(paths)
    out = np.zeros((n, height, width, nband), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.tio_read_files_f32(arr, n, width, height, nband, _dptr(_bands(mean, nband)),
                                _dptr(_bands(std, nband)), out.ctypes.data_as(_PF),
                                _threads(n_threads))
    if rc != 0:
        what = {-2: "open/read failure", -3: "shape mismatch"}.get(rc, rc)
        raise ValueError(f"native file batch read failed: {what}")
    return out


class NativePairAssembler:
    """Threaded batch assembly of a scene pair's tile canvases: one C call
    gives the (n, patch_h, patch_w, nband) x and y canvases of ``items``."""

    def __init__(self, path_x: str, path_y: str, patch_size, overlap_padding,
                 mean_x=None, std_x=None, mean_y=None, std_y=None,
                 n_threads: Optional[int] = None):
        self._lib = load()
        self.rx = NativeRaster(path_x)
        self.ry = NativeRaster(path_y)
        self.patch_size = patch_size
        self.pad = overlap_padding
        self.nband = self.rx.nband
        self.mean_x, self.std_x = _bands(mean_x, self.nband), _bands(std_x, self.nband)
        self.mean_y, self.std_y = _bands(mean_y, self.nband), _bands(std_y, self.nband)
        self.n_threads = _threads(n_threads)

    def _items(self, items):
        return np.ascontiguousarray(np.asarray(items, np.int64))

    def assemble(self, items: Sequence[int]):
        """Normalized float32 canvases (zero outside each write window)."""
        pw, ph = self.patch_size
        arr = self._items(items)
        out_x = np.zeros((len(arr), ph, pw, self.nband), np.float32)
        out_y = np.zeros_like(out_x)
        rc = self._lib.tio_assemble_batch(
            self.rx._h, self.ry._h, arr.ctypes.data_as(_PI64), len(arr), pw, ph,
            self.pad[0], self.pad[1], _dptr(self.mean_x), _dptr(self.std_x),
            _dptr(self.mean_y), _dptr(self.std_y), out_x.ctypes.data_as(_PF),
            out_y.ctypes.data_as(_PF), self.n_threads)
        if rc != 0:
            raise ValueError(f"native assemble failed (rc {rc})")
        return out_x, out_y

    def assemble_raw(self, items: Sequence[int]):
        """Zero-padded canvases in the rasters' stored type, unnormalized (the
        payload of ``DeviceNormalizer``). Both rasters must share one type
        other than float64."""
        code = self.rx.dtype_code
        if code != self.ry.dtype_code or code not in DTYPE_CODES or code == 7:
            raise ValueError("raw assembly needs one shared non-f64 dtype")
        pw, ph = self.patch_size
        arr = self._items(items)
        out_x = np.zeros((len(arr), ph, pw, self.nband), DTYPE_CODES[code])
        out_y = np.zeros_like(out_x)
        rc = self._lib.tio_assemble_batch_raw(
            self.rx._h, self.ry._h, arr.ctypes.data_as(_PI64), len(arr), pw, ph,
            self.pad[0], self.pad[1], out_x.ctypes.data_as(ctypes.c_void_p),
            out_y.ctypes.data_as(ctypes.c_void_p), code, self.n_threads)
        if rc != 0:
            raise ValueError(f"native raw assemble failed (rc {rc})")
        return out_x, out_y

    def close(self):
        self.rx.close()
        self.ry.close()
