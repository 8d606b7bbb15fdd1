"""The port's native tile I/O library against the JAX package's Python codecs.

The library (``fcdgan_tpu_torch/native/tileio.cpp``) is built from the
port's own source with g++ at first use; nothing here uses the JAX package's
build. Reads are held bit-equal to ``fcdgan_tpu.data.tiff`` / ``envi`` over
sample types, codecs, layouts and byte orders; assembled tiles within one
float32 ulp of the JAX ``ScenePairDataset``; raw tiles bit-equal to the raw
windows. Four processes building into one empty directory at once all load
the same library, and a broken source raises with g++'s output.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from fcdgan_tpu.data import envi as jenvi
from fcdgan_tpu.data.datasets import ScenePairDataset, WHUDataset
from fcdgan_tpu.data.normalize import Normalize
from fcdgan_tpu.data.synthetic import make_usss_scene, make_whu_dataset
from fcdgan_tpu.data.tiff import TiffReader, _pack_entry
from fcdgan_tpu_torch import native
from fcdgan_tpu_torch.ops.build import KernelBuildError, host_library
from test_tiff_codecs import lzw_encode, packbits_encode


@pytest.fixture(autouse=True)
def _library():
    """The port's library, built at the first test that needs it (never
    while the module is imported); without g++ the tests skip."""
    if not native.native_available():
        pytest.skip(f"g++ cannot build the library: {native.build_error()}")


DTYPES = {"u8": np.uint8, "u16": np.uint16, "i16": np.int16, "i32": np.int32,
          "u32": np.uint32, "f32": np.float32, "f64": np.float64}
CODECS = {"none": (1, 1), "deflate": (8, 1), "lzw": (5, 1), "packbits": (32773, 1),
          "lzw_predictor": (5, 2)}
ORDERS = {"II": "<", "MM": ">"}


def _sample(dtype, h=37, w=29, nb=3, seed=0) -> np.ndarray:
    """Runs (for the RLE codecs), ramps and noise over the type's range."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a = rng.normal(0.0, 1e3, size=(h, w, nb)).astype(dt)
    else:
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, size=(h, w, nb), dtype=np.int64,
                         endpoint=True).astype(dt)
    a[5:15, 3:20] = 7
    a[20:30] = np.arange(w, dtype=dt)[None, :, None]
    return a


def _compress(chunk: bytes, compression: int) -> bytes:
    return {1: lambda c: c, 8: zlib.compress, 5: lzw_encode,
            32773: packbits_encode}[compression](chunk)


def write_tiff(path, arr, *, compression=1, tiled=False, order="<", predictor=1,
               rows_per_strip=5, tile=(16, 16)):
    """A chunky (h, w, bands) TIFF of any of DTYPES in either byte order,
    stripped or tiled, with one of the codecs (the fixture writer of
    tests/test_tiff_codecs.py, widened to every sample type and to
    big-endian files)."""
    h, w, nb = arr.shape
    dt = arr.dtype
    sf = {"u": 1, "i": 2, "f": 3}[dt.kind]
    stored = dt.newbyteorder(order)

    def prep(block):
        if predictor == 2:  # horizontal differencing per band, modulo the type
            d = block.astype(np.int64)
            d[:, 1:] -= d[:, :-1].copy()
            block = d.astype(dt)
        return np.ascontiguousarray(block).astype(stored).tobytes()

    chunks = []
    if tiled:
        tw, th = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                canvas = np.zeros((th, tw, nb), dt)
                blk = arr[ty:ty + th, tx:tx + tw]
                canvas[:blk.shape[0], :blk.shape[1]] = blk
                chunks.append(_compress(prep(canvas), compression))
    else:
        for r0 in range(0, h, rows_per_strip):
            chunks.append(_compress(prep(arr[r0:r0 + rows_per_strip]), compression))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [dt.itemsize * 8] * nb),
            (259, 3, [compression]), (262, 3, [1]), (277, 3, [nb]), (284, 3, [1]),
            (317, 3, [predictor]), (339, 3, [sf] * nb)]
    if tiled:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, [0] * len(chunks)),
                 (325, 4, [len(c) for c in chunks])]
        off_tag = 324
    else:
        tags += [(273, 4, [0] * len(chunks)), (278, 4, [rows_per_strip]),
                 (279, 4, [len(c) for c in chunks])]
        off_tag = 273
    tags.sort()
    head = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8)
    heap_base = 8 + 2 + 12 * len(tags) + 4
    heap = []
    for tag, typ, vals in tags:  # sizes the heap
        _pack_entry(order, tag, typ, vals, heap, heap_base, False)
    pos = heap_base + sum(len(x) for x in heap)
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c) + len(c) % 2
    tags = [(t, ty, offsets if t == off_tag else v) for t, ty, v in tags]
    heap, bufs = [], []
    for tag, typ, vals in tags:
        bufs.append(_pack_entry(order, tag, typ, vals, heap, heap_base, False)[0])
    with open(path, "wb") as f:
        f.write(head + struct.pack(order + "H", len(tags)) + b"".join(bufs)
                + struct.pack(order + "I", 0))
        for x in heap:
            f.write(x)
        for c in chunks:
            f.write(c + b"\0" * (len(c) % 2))


def _cases():
    for dname in DTYPES:
        for cname, (_, predictor) in CODECS.items():
            if predictor == 2 and dname not in ("u16", "i16"):
                continue  # the 16-bit horizontal predictor
            for tiled in (False, True):
                for oname in ORDERS:
                    layout = "tiled" if tiled else "strips"
                    yield pytest.param(dname, cname, tiled, oname,
                                       id=f"{dname}-{cname}-{layout}-{oname}")


@pytest.mark.parametrize("dname,cname,tiled,oname", list(_cases()))
def test_tiff_reads_are_bit_equal_to_the_python_codec(tmp_path, dname, cname, tiled, oname):
    arr = _sample(DTYPES[dname])
    compression, predictor = CODECS[cname]
    p = str(tmp_path / "t.tif")
    write_tiff(p, arr, compression=compression, tiled=tiled, order=ORDERS[oname],
               predictor=predictor)
    want = TiffReader(p).read_block()
    np.testing.assert_array_equal(want, arr)  # the fixture itself
    r = native.NativeRaster(p)
    assert (r.xsize, r.ysize, r.nband) == (29, 37, 3)
    assert r.dtype == np.dtype(DTYPES[dname])
    np.testing.assert_array_equal(r.read_block(), want.astype(np.float32))
    np.testing.assert_array_equal(r.read_block(10, 3, 15, 30),
                                  want[3:33, 10:25].astype(np.float32))
    r.close()


@pytest.mark.parametrize("interleave", ["bsq", "bil", "bip"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.int16])
def test_envi_reads_are_bit_equal_to_the_python_codec(tmp_path, interleave, dtype):
    data = _sample(dtype, h=17, w=23, nb=4, seed=3)
    p = str(tmp_path / f"e_{interleave}")
    jenvi.write_envi(p, data, interleave=interleave)
    want = jenvi.EnviReader(p).read_block()
    r = native.NativeRaster(p)
    assert (r.xsize, r.ysize, r.nband) == (23, 17, 4)
    np.testing.assert_array_equal(r.read_block(), want.astype(np.float32))
    np.testing.assert_array_equal(r.read_block(3, 2, 9, 7), want[2:9, 3:12].astype(np.float32))


NORM = Normalize([100.013175, 101.514225, 99.899775],
                 [30.5321279982828, 29.2906071402124, 31.38792],
                 [105.1234567, 104.0000001, 106.54321], [31.000001, 30.25013, 32.111])


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_assemble_within_one_ulp_of_the_jax_dataset(tmp_path, dtype):
    paths = make_usss_scene(str(tmp_path), 100, 90, 3, dtype=np.dtype(dtype))
    ds = ScenePairDataset(paths["x"], paths["y"], enhance=NORM, patch_size=(48, 40),
                          overlap_padding=(4, 3))
    asm = native.NativePairAssembler(paths["x"], paths["y"], (48, 40), (4, 3),
                                     NORM.meansX, NORM.stdX, NORM.meansY, NORM.stdY)
    items = list(range(len(ds)))[::-1]
    nx, ny = asm.assemble(items)
    for pos, i in enumerate(items):
        px, py, _, _ = ds[i]
        for got, want in ((nx[pos], px), (ny[pos], py)):
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
            np.testing.assert_array_equal(got == 0, want == 0)
    asm.close()


def test_assemble_raw_is_bit_equal_to_the_raw_windows(tmp_path):
    paths = make_usss_scene(str(tmp_path), 100, 90, 3, dtype=np.uint16)
    ds = ScenePairDataset(paths["x"], paths["y"], patch_size=(48, 40),
                          overlap_padding=(4, 3))
    asm = native.NativePairAssembler(paths["x"], paths["y"], (48, 40), (4, 3))
    items = [5, 0, 3, 7, 2]
    rx, ry = asm.assemble_raw(items)
    assert rx.dtype == ry.dtype == np.uint16
    for pos, i in enumerate(items):
        _, read, write = ds.grid.slices(i)
        for got, raster in ((rx[pos], ds.raster_x), (ry[pos], ds.raster_y)):
            want = np.zeros((40, 48, 3), np.uint16)
            want[write[1]:write[1] + write[3], write[0]:write[0] + write[2]] = \
                raster.read_block(*read)
            np.testing.assert_array_equal(got, want)
    fpaths = make_usss_scene(str(tmp_path / "f"), 64, 64, 3)  # float32 rasters
    with pytest.raises(ValueError, match="non-f64"):
        native.NativePairAssembler(fpaths["x"], paths["y"], (48, 40), (4, 3)).assemble_raw([0])


def test_read_files_f32_matches_the_jax_slice_dataset(tmp_path):
    root = str(tmp_path / "whu")
    make_whu_dataset(root, n_changed=3, n_unchanged=4, size=48)
    ds = WHUDataset(os.path.join(root, "before"), os.path.join(root, "after"),
                    os.path.join(root, "Label"), root, "-1", scale=NORM)
    got = native.read_files_f32(ds.img_path_x, 48, 48, 3, mean=NORM.meansX, std=NORM.stdX)
    raw = native.read_files_f32(ds.img_path_y, 48, 48, 3)
    for i in range(len(ds)):
        x = ds[i][0]
        np.testing.assert_array_max_ulp(got[i], x, maxulp=1)
        np.testing.assert_array_equal(raw[i], TiffReader(ds.img_path_y[i]).read_block()
                                      .astype(np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        native.read_files_f32(ds.img_path_x[:1], 40, 48, 3)
    assert not native.can_open(os.path.join(root, "label.txt"))


_BUILD = """
import ctypes, sys
from fcdgan_tpu_torch.native import SOURCE
from fcdgan_tpu_torch.ops.build import host_library
path = host_library(SOURCE, build_dir=sys.argv[1])
lib = ctypes.CDLL(path)
lib.tio_open.restype = ctypes.c_int64
assert lib.tio_open(sys.argv[2].encode()) != 0
print(path)
"""


def test_processes_building_at_once_load_one_library(tmp_path):
    scene = make_usss_scene(str(tmp_path / "s"), 32, 32, 3, dtype=np.uint16)
    out = str(tmp_path / "build")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, out, scene["x"]], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [r[1] for r in results]
    paths = {r[0].strip() for r in results}
    assert len(paths) == 1
    assert os.listdir(out) == [os.path.basename(paths.pop())]  # no temporary left over


def test_a_broken_source_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(KernelBuildError, match="undeclared_name"):
        host_library(str(src), build_dir=str(tmp_path / "build"))
    assert os.listdir(tmp_path / "build") == []


def test_threaded_assembly_reads_every_tile_right(tmp_path):
    """Many strips (more than the 64 chunks the reader caches) read by eight
    threads at once, again and again: every tile equals the Python codec's.
    The decoded-chunk cache is shared between the threads; a chunk stays
    alive while a thread reads it, whatever the others store or clear."""
    arr = _sample(np.uint16, h=150, w=130, nb=3, seed=5)
    px, py = str(tmp_path / "x.tif"), str(tmp_path / "y.tif")
    write_tiff(px, arr, rows_per_strip=1)
    write_tiff(py, arr[::-1].copy(), compression=8, rows_per_strip=2)
    ds = ScenePairDataset(px, py, patch_size=(40, 40), overlap_padding=(4, 4))
    want = [ds[i][:2] for i in range(len(ds))]
    asm = native.NativePairAssembler(px, py, (40, 40), (4, 4), n_threads=8)
    items = np.tile(np.arange(len(ds)), 6)
    for _ in range(5):
        nx, ny = asm.assemble(items)
        for pos, i in enumerate(items):
            np.testing.assert_array_equal(nx[pos], want[i][0])
            np.testing.assert_array_equal(ny[pos], want[i][1])
