"""The resident scene cache keeps narrow integer rasters in their own type.

The port's ``DeviceSceneCache`` holds a uint8 or uint16 scene in that type
on the device and casts to float32 at gather time, as the JAX package's does
(device_cache.py:263-272), and budgets those bytes against
``FCDGAN_SCENE_CACHE_MAX_MB`` as the JAX ``fits`` does (:331-342). The
stitched densities stay bit-equal to those of a float32 copy of the scene."""

import os

import numpy as np
import pytest
import torch

from fcdgan_tpu.data.datasets import ScenePairDataset as JaxScenePairDataset
from fcdgan_tpu.data.device_cache import DeviceSceneCache as JaxSceneCache
from fcdgan_tpu_torch.data.datasets import ScenePairDataset
from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
from fcdgan_tpu_torch.data.normalize import Normalize
from fcdgan_tpu_torch.data.raster import open_raster
from fcdgan_tpu_torch.data.synthetic import make_usss_scene
from fcdgan_tpu_torch.data.tiff import TiffWriter
from fcdgan_tpu_torch.models.segmentor import Segmentor

PATCH, PAD = (32, 32), (4, 4)
NORM = Normalize([100.0, 101.0, 99.0], [30.0, 29.0, 31.0],
                 [105.0, 104.0, 106.0], [28.0, 30.0, 29.0])


def _scene(root, dtype, side=72):
    make_usss_scene(str(root), side, side, 3, seed=5, dtype=dtype,
                    rects=((10, 12, 14, 10), (40, 38, 16, 20)))
    return ScenePairDataset(str(root / "T1.tif"), str(root / "T2.tif"),
                            ref_path=str(root / "ref.tif"), enhance=NORM,
                            patch_size=PATCH, overlap_padding=PAD)


@pytest.mark.parametrize("dtype,held", [(np.uint8, torch.uint8), (np.uint16, torch.uint16),
                                        (np.float32, torch.float32)])
def test_scene_is_held_in_its_own_type(tmp_path, dtype, held):
    cache = DeviceSceneCache(_scene(tmp_path, dtype), NORM, "cpu")
    assert cache.px.dtype == cache.py.dtype == held
    assert cache.pref.dtype == torch.uint8  # the {1, 2} reference raster
    x, y, ref = cache._gather(torch.arange(3), with_ref=True)
    assert x.dtype == y.dtype == ref.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
@pytest.mark.parametrize("side", [40, 72, 130])
@pytest.mark.parametrize("limit_mb", ["0.02", "0.05", "0.1"])
def test_fits_agrees_with_jax(tmp_path, monkeypatch, dtype, side, limit_mb):
    monkeypatch.setenv("FCDGAN_SCENE_CACHE_MAX_MB", limit_mb)
    ds = _scene(tmp_path, dtype, side)
    jds = JaxScenePairDataset(str(tmp_path / "T1.tif"), str(tmp_path / "T2.tif"),
                              ref_path=str(tmp_path / "ref.tif"), patch_size=PATCH,
                              overlap_padding=PAD)
    assert DeviceSceneCache.fits(ds) == JaxSceneCache.fits(jds)


def test_stitched_density_is_bit_equal_to_a_float32_copy(tmp_path):
    """A uint16 and a uint8 scene against float32 copies of the same pixels,
    through the same seeded Segmentor: the same density, bit for bit."""
    torch.manual_seed(3)
    net = Segmentor(3).eval()
    for dtype in (np.uint16, np.uint8):
        root = tmp_path / np.dtype(dtype).name
        ds = _scene(root, dtype)
        copy = root / "f32"
        os.makedirs(copy)
        for name in ("T1.tif", "T2.tif"):
            block = open_raster(str(root / name)).read_block()
            with TiffWriter(str(copy / name), block.shape[1], block.shape[0], 3,
                            np.float32) as w:
                w.write_block(block.astype(np.float32))
        ds32 = ScenePairDataset(str(copy / "T1.tif"), str(copy / "T2.tif"),
                                enhance=NORM, patch_size=PATCH, overlap_padding=PAD)
        got = DeviceSceneCache(ds, NORM, "cpu").stitched_density(net, batch_size=3)
        want = DeviceSceneCache(ds32, NORM, "cpu").stitched_density(net, batch_size=3)
        assert got.shape == (72, 72)
        np.testing.assert_array_equal(got, want)


def test_past_the_budget_the_error_names_the_variable(tmp_path, monkeypatch):
    ds = _scene(tmp_path, np.uint16)
    monkeypatch.setenv("FCDGAN_SCENE_CACHE_MAX_MB", "0.01")
    with pytest.raises(NotImplementedError) as e:
        DeviceSceneCache(ds, NORM, "cpu")
    msg = str(e.value)
    assert "FCDGAN_SCENE_CACHE_MAX_MB (0.01 MB)" in msg and "4096" not in msg
    monkeypatch.setenv("FCDGAN_SCENE_CACHE_MAX_MB", "1")
    assert DeviceSceneCache(ds, NORM, "cpu").px.dtype == torch.uint16
