"""Raster open/create over the bundled codecs (GeoTIFF and ENVI).

The GDAL role of the reference (data_utils.py:190-198): ``open_raster``
dispatches on content and extension, ``create_raster`` makes a writable
GeoTIFF with the geo metadata copied from a source raster. Trimmed copy of
the JAX package's ``data/raster.py``: the serving slice reads TIFF/ENVI
scenes and writes TIFF rasters only. ``read_image`` / ``write_image`` are the
WHU slice I/O that the JAX package does through PIL (datasets.py:429-444,
demo_wsss.py:337-344): ``.tif`` slices go through the TIFF codec here, any
other extension through PIL, imported only then.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np

from . import envi as envi_mod
from . import tiff as tiff_mod

GeoTransform = Tuple[float, float, float, float, float, float]
RasterLike = Union[tiff_mod.TiffReader, envi_mod.EnviReader]


def open_raster(path) -> RasterLike:
    """Open a raster by path (TIFF or ENVI)."""
    path = str(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No such a Image file:{path}")
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] in (b"II", b"MM") and magic[2:4] in (b"*\0", b"\0*"):
        try:
            return tiff_mod.TiffReader(path)
        except tiff_mod.TiffError:
            pass
    if os.path.exists(envi_mod.hdr_path_for(path)):
        return envi_mod.EnviReader(path)
    if os.path.splitext(path)[1].lower() in (".tif", ".tiff"):
        return tiff_mod.TiffReader(path)  # raise the codec's error
    raise ValueError(f"unrecognized raster format: {path}")


def create_raster(path: str, xsize: int, ysize: int, nband: int = 1,
                  dtype=np.float32, like: Optional[RasterLike] = None,
                  geotransform: Optional[GeoTransform] = None,
                  projection: Optional[str] = None) -> tiff_mod.TiffWriter:
    """Create a writable GeoTIFF; ``like`` copies geotransform/projection
    (the GDALwriteDefault metadata copy, data_utils.py:197-198)."""
    if like is not None:
        geotransform = geotransform or getattr(like, "geotransform", None)
        projection = projection if projection is not None else getattr(like, "projection", "")
    return tiff_mod.TiffWriter(path, xsize, ysize, nband, dtype, geotransform,
                               projection or "")


_TIFF_EXTENSIONS = (".tif", ".tiff")


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading or writing {path} needs PIL (Pillow), which is not "
                          "installed; only .tif slices are read without it") from e
    return Image


def read_image(path: str) -> np.ndarray:
    """A slice image as an (H, W, bands) array of its stored type."""
    if os.path.splitext(path)[1].lower() in _TIFF_EXTENSIONS:
        r = open_raster(path)
        try:
            return r.read_block()
        finally:
            r.close()
    a = np.array(_pil(path).open(path))
    return a[..., None] if a.ndim == 2 else a


def write_image(path: str, arr: np.ndarray) -> None:
    """Write an (H, W) or (H, W, bands) uint8 image: a plain TIFF for a
    ``.tif`` path, else PIL's format for the extension."""
    arr = np.asarray(arr, np.uint8)
    if os.path.splitext(path)[1].lower() in _TIFF_EXTENSIONS:
        a3 = arr[..., None] if arr.ndim == 2 else arr
        with tiff_mod.TiffWriter(path, a3.shape[1], a3.shape[0], a3.shape[2], np.uint8) as w:
            w.write_block(a3)
        return
    _pil(path).fromarray(arr).save(path)
