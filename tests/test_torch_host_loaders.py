"""The port's host loaders against the JAX package's Python loaders.

Each port loader (the native ones over the port's own g++ library, and the
Python ``PairBatchLoader``) runs beside the JAX ``BatchLoader`` /
``PairBatchLoader`` over the same files with the same seed: the same items
in the same order and weights, tiles within one float32 ulp where they are
normalized (bit-equal otherwise), and the raw feed normalized on the device
(``DeviceNormalizer``, here on the CPU) within one ulp too.
"""

import os
import random

import numpy as np
import pytest
import torch

from fcdgan_tpu.data import datasets as jds
from fcdgan_tpu.data import pipeline as jpipe
from fcdgan_tpu.data.normalize import Normalize as JNormalize
from fcdgan_tpu_torch import native
from fcdgan_tpu_torch.data import datasets as pds
from fcdgan_tpu_torch.data import pipeline as ppipe
from fcdgan_tpu_torch.data.normalize import Normalize
from fcdgan_tpu_torch.data.synthetic import (make_oscd_dataset, make_usss_scene,
                                             make_whu_dataset)


@pytest.fixture(autouse=True)
def _library():
    """The port's library, built at the first test that needs it (never
    while the module is imported); without g++ the tests skip."""
    if not native.native_available():
        pytest.skip(f"g++ cannot build the library: {native.build_error()}")


STATS = ([100.013175, 101.514225, 99.899775], [30.5321279982828, 29.2906071402124, 31.38792],
         [105.1234567, 104.0000001, 106.54321], [31.000001, 30.25013, 32.111])
PATCH, PAD = (48, 40), (4, 3)


def _ulp(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_max_ulp(got, np.asarray(want), maxulp=1)
    np.testing.assert_array_equal(got == 0, np.asarray(want) == 0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_usss_scene(str(tmp_path_factory.mktemp("scene")), 100, 90, 3, dtype=np.uint16)


def _scene_pair(scene):
    port = pds.ScenePairDataset(scene["x"], scene["y"], ref_path=scene["ref"],
                                enhance=Normalize(*STATS), patch_size=PATCH, overlap_padding=PAD)
    ref = jds.ScenePairDataset(scene["x"], scene["y"], ref_path=scene["ref"],
                               enhance=JNormalize(*STATS), patch_size=PATCH, overlap_padding=PAD)
    return port, ref


@pytest.mark.parametrize("raw", [False, True], ids=["normalized", "raw_device_normalized"])
def test_native_scene_loader_matches_jax(scene, raw):
    port, ref = _scene_pair(scene)
    assert ppipe.NativeSceneBatchLoader.supports_device_normalize(port)
    nat = ppipe.NativeSceneBatchLoader(port, 4, shuffle=True, seed=7, device_normalize=raw)
    want = jpipe.BatchLoader(ref, 4, fields=("x", "y", "item", "ref"), shuffle=True, seed=7)
    placer = ppipe.DeviceNormalizer(port.enhance, 3, "cpu")
    n = 0
    for _ in range(2):  # two epochs: the shuffle stream goes on
        for got, exp in zip(nat, want):
            np.testing.assert_array_equal(got["item"], exp["item"])
            np.testing.assert_array_equal(got["weight"], exp["weight"])
            if raw:
                assert got["x"].dtype == np.uint16 and got["win"].shape == (4, 4)
                db = placer(ppipe.device_put_batch(got, "cpu"))
                assert "win" not in db and db["ref"].dtype == torch.float32
            else:
                db = got
            _ulp(db["x"], exp["x"])
            _ulp(db["y"], exp["y"])
            np.testing.assert_array_equal(np.asarray(db["ref"]), exp["ref"])
            n += 1
    assert n == 2 * len(want)


def test_raw_feed_needs_an_integral_type(tmp_path):
    paths = make_usss_scene(str(tmp_path), 64, 64, 3)  # float32 rasters
    ds = pds.ScenePairDataset(paths["x"], paths["y"], enhance=Normalize(*STATS),
                              patch_size=PATCH, overlap_padding=PAD)
    assert not ppipe.NativeSceneBatchLoader.supports_device_normalize(ds)
    with pytest.raises(ValueError, match="integral"):
        ppipe.NativeSceneBatchLoader(ds, 4, device_normalize=True)


def test_device_normalizer_without_an_enhance_is_the_identity(scene):
    port, _ = _scene_pair(scene)
    port.enhance = None
    raw = next(iter(ppipe.NativeSceneBatchLoader(port, 3, device_normalize=True)))
    db = ppipe.DeviceNormalizer(None, 3, "cpu")(ppipe.device_put_batch(raw, "cpu"))
    plain = ppipe.BatchLoader(port, 3, fields=("x", "y", "item", "ref"))
    exp = next(iter(plain))
    np.testing.assert_array_equal(db["x"].numpy(), exp["x"])
    np.testing.assert_array_equal(db["ref"].numpy(), exp["ref"])


@pytest.fixture(scope="module")
def whu(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("whu"))
    make_whu_dataset(root, n_changed=5, n_unchanged=7, size=40)
    return (os.path.join(root, "before"), os.path.join(root, "after"),
            os.path.join(root, "Label"), root)


FIELDS = ("x", "y", "ref", "item", "label")


def _same_batches(got_loader, want_loader, epochs=2):
    n = 0
    for _ in range(epochs):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(w) <= set(g)
            for k in w:
                if k.endswith(("x", "y")):
                    _ulp(g[k], w[k])
                else:
                    np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            n += 1
    return n


def test_native_whu_loader_matches_jax(whu):
    port = pds.WHUDataset(*whu, "-1", scale=Normalize(*STATS))
    ref = jds.WHUDataset(*whu, "-1", scale=JNormalize(*STATS))
    assert ppipe.NativeWHUBatchLoader.supports(port)
    _same_batches(ppipe.NativeWHUBatchLoader(port, 5, shuffle=True, seed=3),
                  jpipe.BatchLoader(ref, 5, fields=FIELDS, shuffle=True, seed=3))


@pytest.mark.parametrize("kind", ["native", "python_pad", "python_short"])
def test_pair_loaders_match_jax(whu, kind):
    port = pds.WHUPairDataset(*whu, scale=Normalize(*STATS), rng=random.Random(4))
    ref = jds.WHUPairDataset(*whu, scale=JNormalize(*STATS), random_assign=False,
                             rng=random.Random(4))
    tail = "short" if kind == "python_short" else "pad"
    want = jpipe.PairBatchLoader(ref, 3, c_fields=FIELDS, nc_fields=FIELDS, shuffle=True,
                                 seed=5, epoch_hook=lambda e: ref.order_reset(), tail=tail)
    if kind == "native":
        got = ppipe.NativeWHUPairBatchLoader(port, 3, shuffle=True, seed=5,
                                             epoch_hook=lambda e: port.order_reset())
    else:
        got = ppipe.PairBatchLoader(port, 3, c_fields=FIELDS, nc_fields=FIELDS, shuffle=True,
                                    seed=5, epoch_hook=lambda e: port.order_reset(), tail=tail)
    _same_batches(got, want, epochs=3)


@pytest.fixture(scope="module")
def oscd(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("oscd"))
    make_oscd_dataset(root, train_scenes=("alpha", "beta"), xsize=70, ysize=64,
                      dtype=np.uint16)
    return root


def test_native_oscd_loader_matches_jax_padded_tails(oscd):
    stats = [[(100.0 + 3 * s,) * 4, (30.0 + s,) * 4, (105.0 - s,) * 4, (31.0,) * 4]
             for s in range(2)]
    port = pds.OSCDDataset(oscd, "train.txt", scaler=[Normalize(*v) for v in stats],
                           patch_size=(40, 40), overlap_padding=(4, 4))
    ref = jds.OSCDDataset(oscd, "train.txt", scaler=[JNormalize(*v) for v in stats],
                          patch_size=(40, 40), overlap_padding=(4, 4))
    assert ppipe.NativeOSCDBatchLoader.supports(port)
    nat = ppipe.NativeOSCDBatchLoader(port, 5, shuffle=True, seed=7)
    want = jpipe.BatchLoader(ref, 5, fields=("x", "y", "item", "ref", "region"), shuffle=True,
                             seed=7, tail="pad")
    assert len(port) % 5 != 0  # a padded tail
    n = _same_batches(nat, want)
    assert n == 2 * -(-len(port) // 5)


@pytest.mark.parametrize("size", [32, 48])
@pytest.mark.parametrize("counts", [(3, 5), (6, 2)])
def test_whu_cache_supports_matches_jax(tmp_path, monkeypatch, counts, size):
    """``DeviceWHUCache.supports`` over slice counts, sizes and budgets, and
    with random pairing or an empty side, as the JAX one decides."""
    from types import SimpleNamespace

    from fcdgan_tpu.data.device_cache import DeviceWHUCache as JCache
    from fcdgan_tpu_torch.data.device_cache import DeviceWHUCache

    root = str(tmp_path)
    make_whu_dataset(root, *counts, size)
    dirs = (os.path.join(root, "before"), os.path.join(root, "after"),
            os.path.join(root, "Label"), root)
    port = pds.WHUPairDataset(*dirs, scale=Normalize(*STATS), rng=random.Random(0))
    ref = jds.WHUPairDataset(*dirs, scale=JNormalize(*STATS), random_assign=False,
                             rng=random.Random(0))
    n = sum(counts)
    need = (2 * n + counts[0]) * size * size * 3
    for mb in (need / 1e6 * 0.5, need / 1e6, need / 1e6 * 1.01, 4096):
        monkeypatch.setenv("FCDGAN_SLICE_CACHE_MAX_MB", repr(mb))
        assert DeviceWHUCache.supports(port) == JCache.supports(ref) == (need <= mb * 1e6)
    monkeypatch.delenv("FCDGAN_SLICE_CACHE_MAX_MB")
    for stub in (dict(random_assign=True), dict(c_len=0), dict(nc_len=0)):
        fields = dict(c_ds=port.c_ds, nc_ds=port.nc_ds, c_len=port.c_len, nc_len=port.nc_len,
                      random_assign=False)
        jfields = dict(fields, c_ds=ref.c_ds, nc_ds=ref.nc_ds)
        assert not DeviceWHUCache.supports(SimpleNamespace(**{**fields, **stub}))
        assert not JCache.supports(SimpleNamespace(**{**jfields, **stub}))
