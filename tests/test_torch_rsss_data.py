"""The data, losses and schedules of the RSSS training slice against the JAX
package's: the synthetic OSCD layout, the OSCD datasets and per-scene
normalizers, the device-resident tile stacks, ``region_loss`` and the
adversarial schedules; and the options the port's RSSS driver does not run
yet. The steps and the driver are in ``test_torch_rsss.py``."""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fcdgan_tpu.data import datasets as jds
from fcdgan_tpu.data.device_cache import DeviceOSCDCache as JaxCache
from fcdgan_tpu.data.synthetic import make_oscd_dataset as jax_make_oscd_dataset
from fcdgan_tpu.demos.demo_rsss import _scene_scalers as jax_scene_scalers
from fcdgan_tpu.ops import losses as jlosses
from fcdgan_tpu.train import schedules as jsched
from fcdgan_tpu_torch.data import datasets as pds
from fcdgan_tpu_torch.data.device_cache import DeviceOSCDCache
from fcdgan_tpu_torch.data.synthetic import make_oscd_dataset
from fcdgan_tpu_torch.data.tiff import TiffWriter
from fcdgan_tpu_torch.demos.demo_rsss import _scene_scalers
from fcdgan_tpu_torch.ops import losses as plosses
from fcdgan_tpu_torch.train import schedules as psched

PATCH, PAD = (32, 32), (4, 4)
SIDE = 48
RECTS = ((5, 6, 10, 8), (28, 26, 10, 12))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kw", [{}, dict(xsize=SIDE, ysize=SIDE, nband=3, region_expand=3,
                                         seed=4, test_scenes=("gamma", "delta"))],
                         ids=["defaults", "other"])
def test_make_oscd_dataset_writes_the_jax_files(tmp_path, kw):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    make_oscd_dataset(port, **kw)
    jax_make_oscd_dataset(ref, **kw)
    assert _files(port) == _files(ref) and len(_files(port)) >= 20
    for f in _files(port):
        assert filecmp.cmp(os.path.join(port, f), os.path.join(ref, f), shallow=False), f


def test_make_oscd_dataset_uint16_rounds_the_float_layout(tmp_path):
    from fcdgan_tpu_torch.data.raster import open_raster

    make_oscd_dataset(str(tmp_path / "f"), xsize=SIDE, ysize=SIDE, rects=RECTS)
    make_oscd_dataset(str(tmp_path / "u"), xsize=SIDE, ysize=SIDE, rects=RECTS,
                      dtype=np.uint16)
    for name in ("alpha_20160120", "gamma_20180328"):
        scene = name.split("_")[0]
        f = open_raster(str(tmp_path / "f" / scene / "ImagePair" / name)).read_block()
        u = open_raster(str(tmp_path / "u" / scene / "ImagePair" / name)).read_block()
        assert u.dtype == np.uint16
        np.testing.assert_array_equal(u, np.round(f).astype(np.uint16))


@pytest.fixture(scope="module")
def oscd(tmp_path_factory):
    """Two layouts of three 48 px scenes, float32 and uint16, whose region
    rasters also hold values at and below 125 (which pass through
    un-binarized) and above it."""
    out = {}
    for dtype in (np.float32, np.uint16):
        root = str(tmp_path_factory.mktemp(np.dtype(dtype).name))
        make_oscd_dataset(root, xsize=SIDE, ysize=SIDE, rects=RECTS, seed=2, dtype=dtype)
        for k, scene in enumerate(("alpha", "beta", "gamma")):
            region = np.zeros((SIDE, SIDE), np.uint8)
            region[4:20, 3:22] = 255
            region[30:44, 24:40] = (100, 125, 126, 60)[k]
            region[2, 40:46] = 1
            path = os.path.join(root, scene, "ImagePair", f"{scene}-region.tif")
            with TiffWriter(path, SIDE, SIDE, 1, np.uint8) as w:
                w.write_block(region)
        out[np.dtype(dtype).name] = root
    return out


def _lists(root, txt, scaled):
    ps = _scene_scalers(root, txt, PATCH, "statsMS") if scaled else None
    js = jax_scene_scalers(root, txt, PATCH, "statsMS") if scaled else None
    return (pds.OSCDDataset(root, txt, scaler=ps, patch_size=PATCH, overlap_padding=PAD),
            jds.OSCDDataset(root, txt, scaler=js, patch_size=PATCH, overlap_padding=PAD))


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["raw", "normalized"])
def test_oscd_items_match_jax(oscd, dtype, scaled):
    """Bit-equal items (x, y, ref, region), the region values 100 and 125
    passed through, 126 and 255 set to 1; equal eval windows and interiors."""
    regions = {}
    for txt in ("train.txt", "test.txt"):
        p, j = _lists(oscd[dtype], txt, scaled)
        assert len(p) == len(j) and p.namelist == j.namelist and p.pathlist == j.pathlist
        values = set()
        for i in range(len(p)):
            got, want = p[i], j[i]
            assert got[2] == want[2] == i
            for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):  # x, y, ref, region
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            values.update(np.unique(got[4]).tolist())
            assert p.eff_range(i) == j.eff_range(i)
        np.testing.assert_array_equal(p.interior_sizes(), j.interior_sizes())
        regions[txt] = values
    assert regions == {"train.txt": {0.0, 1.0, 100.0, 125.0}, "test.txt": {0.0, 1.0}}


def test_oscd_list_checks(oscd, tmp_path):
    root = oscd["float32"]
    with pytest.raises(ValueError, match="scaler"):
        pds.OSCDDataset(root, "train.txt", scaler=[None])
    with pytest.raises(ValueError, match="transforms"):
        pds.OSCDDataset(root, "train.txt", transforms=[None])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pds.OSCDDataset(root, "train.txt", transforms=[None, lambda x: x])
    ds = pds.OSCDDataset(root, "train.txt", transforms=[None, None], patch_size=PATCH,
                         overlap_padding=PAD)
    with pytest.raises(IndexError):
        ds._locate(len(ds))
    assert [ds._locate(i) for i in (0, len(ds) // 2 - 1, len(ds) // 2, len(ds) - 1)] == [
        (0, 0), (0, len(ds) // 2 - 1), (1, 0), (1, len(ds) // 2 - 1)]


def test_stats_caches_and_scalers_match_jax(oscd, tmp_path):
    """The port and the JAX package write the same statsMS txts into two
    copies of one layout, and each reads the other's into equal scalers."""
    import shutil

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(oscd["uint16"], a)
    shutil.copytree(oscd["uint16"], b)
    for f in _files(a):
        if f.endswith("_statsMS.txt"):
            os.remove(os.path.join(a, f))
            os.remove(os.path.join(b, f))
    for txt in ("train.txt", "test.txt"):
        ps, js = _scene_scalers(a, txt, PATCH, "statsMS"), jax_scene_scalers(b, txt, PATCH,
                                                                             "statsMS")
        for sp, sj in zip(ps, js):
            for attr in ("meansX", "stdX", "meansY", "stdY"):
                assert getattr(sp, attr) == list(getattr(sj, attr))
    caches = [f for f in _files(a) if f.endswith("_statsMS.txt")]
    assert len(caches) == 6
    for f in caches:
        assert open(os.path.join(a, f)).read() == open(os.path.join(b, f)).read()
    cross = jax_scene_scalers(a, "train.txt", PATCH, "statsMS")  # the port's caches
    for sp, sj in zip(_scene_scalers(b, "train.txt", PATCH, "statsMS"), cross):
        assert sp.meansX == list(sj.meansX) and sp.stdY == list(sj.stdY)


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
def test_device_cache_matches_jax(oscd, dtype):
    p, j = _lists(oscd[dtype], "train.txt", True)
    assert DeviceOSCDCache.supports(p) and JaxCache.supports(j)
    pc, jc = DeviceOSCDCache(p, "cpu"), JaxCache(j)
    assert pc._xs.dtype == pc._ys.dtype == getattr(torch, dtype)
    batch = {"item": np.array([3, 0, len(p) - 1, 5]), "weight": np.array([1, 1, 1, 0],
                                                                         np.float32)}
    got, want = pc.complete(batch), jc.complete(batch)
    for k in ("x", "y"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for k in ("ref", "region", "item", "weight"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the host dataset's normalized items, from the same stacks
    for n, item in enumerate(batch["item"]):
        x, y, _, ref, region = p[int(item)]
        np.testing.assert_allclose(got["x"][n].numpy(), x, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["region"][n].numpy(), region)


def test_device_cache_budget(oscd, monkeypatch):
    p, _ = _lists(oscd["uint16"], "train.txt", True)
    # x and y in uint16 (2 bytes a band), ref and region in f32
    assert DeviceOSCDCache.tile_bytes(p) == len(p) * 32 * 32 * (2 * 4 * 2 + 8)
    monkeypatch.setenv("FCDGAN_TILE_CACHE_MAX_MB", "0.01")
    assert not DeviceOSCDCache.supports(p) and not JaxCache.supports(_lists(
        oscd["uint16"], "train.txt", True)[1])
    with pytest.raises(NotImplementedError, match="FCDGAN_TILE_CACHE_MAX_MB"):
        DeviceOSCDCache(p, "cpu")


@pytest.mark.parametrize("kind", ["l1", "mse"])
def test_region_loss_matches_jax(kind):
    rng = np.random.default_rng(6)
    cmap = rng.uniform(size=(4, 16, 16, 1)).astype(np.float32)
    region = (rng.uniform(size=cmap.shape) > 0.6).astype(np.float32)
    region[1] = 0.0  # an empty region: skipped
    region[2] = 1.0  # all pixels
    for w in (None, np.array([1.0, 1.0, 0.0, 1.0], np.float32),
              np.zeros(4, np.float32)):
        want = jlosses.region_loss(jnp.asarray(cmap), jnp.asarray(region), kind,
                                   sample_weight=None if w is None else jnp.asarray(w))
        got = plosses.region_loss(torch.from_numpy(cmap), torch.from_numpy(region), kind,
                                  sample_weight=None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)


@pytest.mark.parametrize("name", ["S_ADV_RSSS", "D_ADV_RSSS"])
def test_rsss_schedules_match_jax(name):
    port, ref = getattr(psched, name), getattr(jsched, name)
    for epoch in range(101):
        assert port(epoch) == pytest.approx(ref(epoch), rel=1e-12, abs=0)
    assert port(0.5) == pytest.approx(ref(0.5), rel=1e-12)


@pytest.mark.parametrize("flag", [["--siamese-stats", "split"], ["--remat", "true"],
                                  ["--tail", "pad"], ["--random-eraser", "true"], ["--n-devices", "2"],
                                  ["--checkpoint-every", "5"], ["--resume", "true"],
                                  ["--density-dtype", "uint8"], ["--profile-dir", "p"],
                                  ["--debug-nans", "true"], ["--num-processes", "2"]])
def test_unported_options_raise(flag, tmp_path):
    from fcdgan_tpu_torch.demos import demo_rsss

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        demo_rsss.main(["--img-dir", str(tmp_path), "--device", "cpu", *flag])


@pytest.mark.parametrize("flag", [["--eraser-regions", "2"], ["--erase-thresh", "0.2"],
                                  ["--learning-rate", "1e-3"], ["--device-normalize", "on"],
                                  ["--platform", "cpu"]])
def test_unread_options_are_rejected(flag, tmp_path):
    from fcdgan_tpu_torch.demos import demo_rsss

    with pytest.raises(SystemExit):
        demo_rsss.main(["--img-dir", str(tmp_path), "--device", "cpu", *flag])


def test_driver_defaults_to_the_card(monkeypatch, tmp_path):
    from fcdgan_tpu_torch.config import RSSSConfig
    from fcdgan_tpu_torch.demos import demo_rsss

    assert RSSSConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_rsss.main(["--img-dir", str(tmp_path)])
