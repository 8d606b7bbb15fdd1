"""``--random-eraser`` and ``--random-assign`` against the JAX package: the
port's copy of ``data/erasers.py`` draws the same rectangles from the same
seeds; the Python loaders' batches with the eraser (WHU pairs and unchanged
slices, OSCD scene lists, a scene pair) and the WHU pairings with a random
partner are item for item equal to the JAX loaders' over several epochs,
the port's run on its prefetch thread; and with either option the drivers'
feed choices leave the resident caches and the native loaders, which
refuse such datasets, as the JAX drivers do (demo_wsss.py:91-97,
demo_rsss.py:102-110). Every comparison is exact."""

import os
import random

import numpy as np
import pytest

from fcdgan_tpu.data import datasets as jds
from fcdgan_tpu.data import erasers as jerasers
from fcdgan_tpu.data import pipeline as jpipe
from fcdgan_tpu.data.synthetic import make_oscd_dataset as jax_make_oscd_dataset
from fcdgan_tpu.data.synthetic import make_whu_dataset as jax_make_whu_dataset
from fcdgan_tpu_torch.data import datasets as pds
from fcdgan_tpu_torch.data import erasers as perasers
from fcdgan_tpu_torch.data import pipeline as ppipe
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("x", "y", "ref", "item", "label")
OSCD_FIELDS = ("x", "y", "item", "ref", "region")


def _equal_batches(got, want, keys=None):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in keys or b.keys():
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("regions,thresh,seed", [(1, 0.3, 0), (1, 0.1, 5), (3, 0.3, 1),
                                                 (5, 0.05, 2)])
def test_erasers_draw_the_jax_rectangles(regions, thresh, seed):
    """``build_eraser`` from one seed: 40 calls on tiles of several shapes
    give the same regions and images, and the sync call re-applies them."""
    port = perasers.build_eraser(True, regions, thresh, seed)
    ref = jerasers.build_eraser(True, regions, thresh, seed)
    assert type(port).__name__ == type(ref).__name__
    rng = np.random.default_rng(seed + 10)
    for i in range(40):
        img = rng.normal(size=(24 + i % 3, 20 + i % 5, 3)).astype(np.float32)
        (a, ra), (b, rb) = port(img), ref(img)
        assert ra == rb
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port(img, ra)[0], ref(img, rb)[0])
    assert perasers.build_eraser(False) is None


@pytest.fixture(scope="module")
def whu(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("whu"))
    jax_make_whu_dataset(root, n_changed=5, n_unchanged=3, size=24, seed=3)
    dirs = (os.path.join(root, "before"), os.path.join(root, "after"),
            os.path.join(root, "Label"), root)
    return dirs


@pytest.mark.parametrize("random_assign,eraser", [(False, True), (True, False), (True, True)],
                         ids=["eraser", "random_assign", "both"])
def test_whu_pair_batches_match_jax(whu, random_assign, eraser):
    """Three epochs of ``PairBatchLoader`` over a ``WHUPairDataset`` (the
    driver's epoch hook re-pairs before each shuffle; the tail short) and of
    ``BatchLoader`` over the erased unchanged slices."""
    def pair(ds_mod, er_mod):
        return ds_mod.WHUPairDataset(*whu, random_assign=random_assign,
                                     transforms=er_mod.build_eraser(eraser, 2, 0.3, 4),
                                     rng=random.Random(4))

    p, j = pair(pds, perasers), pair(jds, jerasers)
    kw = dict(c_fields=FIELDS, nc_fields=FIELDS, shuffle=True, seed=4, tail="short")
    port = ppipe.PairBatchLoader(p, 3, epoch_hook=lambda e: p.order_reset(), **kw)
    ref = jpipe.PairBatchLoader(j, 3, epoch_hook=lambda e: j.order_reset(), **kw)
    for _ in range(3):
        _equal_batches(list(ppipe.prefetch(iter(port), 2)), list(ref))
    if eraser:
        unc = [m.WHUDataset(*whu, label_selected="0",
                            transforms=e.build_eraser(True, 1, 0.3, 9))
               for m, e in ((pds, perasers), (jds, jerasers))]
        loaders = [m.BatchLoader(ds, 2, fields=FIELDS, shuffle=True, seed=9, tail="pad")
                   for m, ds in zip((ppipe, jpipe), unc)]
        for _ in range(2):
            _equal_batches(list(ppipe.prefetch(iter(loaders[0]), 2)), list(loaders[1]))


@pytest.fixture(scope="module")
def oscd(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("oscd"))
    jax_make_oscd_dataset(root, xsize=48, ysize=48, seed=2)
    return root


def test_oscd_batches_with_the_eraser_match_jax(oscd):
    """Two epochs of ``BatchLoader`` over the erased train list, the
    eraser shared by the scenes as the drivers share it."""
    from fcdgan_tpu.data.normalize import Normalize as JaxNormalize
    from fcdgan_tpu_torch.data.normalize import Normalize

    stats = ([100.0] * 4, [20.0] * 4, [90.0] * 4, [25.0] * 4)
    lists = []
    for ds_mod, er_mod, norm in ((pds, perasers, Normalize), (jds, jerasers, JaxNormalize)):
        eraser = er_mod.build_eraser(True, 3, 0.3, 6)
        lists.append(ds_mod.OSCDDataset(oscd, "train.txt", scaler=[norm(*stats)] * 2,
                                        transforms=[eraser] * 2, patch_size=(32, 32),
                                        overlap_padding=(4, 4)))
    loaders = [m.BatchLoader(ds, 3, fields=OSCD_FIELDS, shuffle=True, seed=6, tail="pad")
               for m, ds in zip((ppipe, jpipe), lists)]
    erased = 0
    for _ in range(2):
        got, want = list(ppipe.prefetch(iter(loaders[0]), 2)), list(loaders[1])
        _equal_batches(got, want)
        erased += sum(int((b["x"] == 0).all(axis=-1).sum()) for b in got)
    assert erased > 0


def test_scene_pair_transform_matches_jax(tmp_path):
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene

    make_usss_scene(str(tmp_path), 56, 48, 3, seed=1)
    paths = [str(tmp_path / n) for n in ("T1.tif", "T2.tif")]
    p = pds.ScenePairDataset(*paths, transforms=perasers.build_eraser(True, 2, 0.3, 3),
                             patch_size=(24, 24), overlap_padding=(2, 2))
    j = jds.ScenePairDataset(*paths, transforms=jerasers.build_eraser(True, 2, 0.3, 3),
                             patch_size=(24, 24), overlap_padding=(2, 2))
    for i in list(range(len(p))) * 2:
        for a, b in zip(p[i], j[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_caches_and_native_loaders_refuse_the_options(whu, oscd):
    """The resident caches and the native loaders refuse an eraser (and the
    WHU ones a random pairing): ``supports`` says so and the constructors
    raise, so the drivers take the Python loaders."""
    from fcdgan_tpu_torch.data.device_cache import (DeviceOSCDCache, DeviceWHUCache,
                                                    IndexPairBatchLoader)

    eraser = perasers.build_eraser(True)
    erased = pds.WHUPairDataset(*whu, transforms=eraser, rng=random.Random(0))
    assigned = pds.WHUPairDataset(*whu, random_assign=True, rng=random.Random(0))
    plain = pds.WHUPairDataset(*whu, rng=random.Random(0))
    assert DeviceWHUCache.supports(plain)
    for ds in (erased, assigned):
        assert not DeviceWHUCache.supports(ds)
        assert not ppipe.NativeWHUPairBatchLoader.supports(ds)
        with pytest.raises(ValueError):
            DeviceWHUCache(ds, None, "cpu")
    with pytest.raises(ValueError, match="random_assign"):
        ppipe.NativeWHUPairBatchLoader(assigned, 2)
    with pytest.raises(ValueError, match="random_assign"):
        IndexPairBatchLoader(assigned, 2)
    with pytest.raises(ValueError, match="sync transforms"):
        ppipe.NativeWHUBatchLoader(erased.nc_ds, 2)
    assert not ppipe.NativeWHUBatchLoader.supports(erased.nc_ds)
    lst = pds.OSCDDataset(oscd, "train.txt", transforms=[eraser, eraser], patch_size=(32, 32),
                          overlap_padding=(4, 4))
    assert not DeviceOSCDCache.supports(lst)
    assert not ppipe.NativeOSCDBatchLoader.supports(lst)
    with pytest.raises(ValueError, match="sync transforms"):
        DeviceOSCDCache(lst, "cpu")
    with pytest.raises(ValueError, match="sync transforms"):
        ppipe.NativeOSCDBatchLoader(lst, 2)


@pytest.mark.parametrize("flags", [dict(random_eraser=True), dict(random_assign=True),
                                   dict(random_eraser=True, random_assign=True)],
                         ids=["eraser", "random_assign", "both"])
def test_wsss_feed_choice(whu, flags):
    """The WSSS driver's choice, as the JAX driver's: the pair loader takes
    ``PairBatchLoader``; the unchanged-slice loader falls back on its own,
    so a random pairing alone keeps its native reads where they work."""
    from fcdgan_tpu_torch.config import WSSSConfig
    from fcdgan_tpu_torch.data.erasers import build_eraser
    from fcdgan_tpu_torch.demos.demo_wsss import slice_feed

    cfg = WSSSConfig(img_dir_x=whu[0], img_dir_y=whu[1], ref_dir=whu[2], label_dir=whu[3],
                     batch_size=2, unc_batch_size=2, device="cpu", **flags)
    eraser = build_eraser(cfg.random_eraser, cfg.eraser_regions, cfg.erase_thresh, cfg.seed)
    pair = pds.WHUPairDataset(*whu, transforms=eraser, random_assign=cfg.random_assign,
                              rng=random.Random(0))
    feed, unc_feed, cache, pair_loader, unc_loader = slice_feed(cfg, pair, None, "cpu",
                                                                eraser)
    native_unc = ppipe.NativeWHUBatchLoader.supports(pds.WHUDataset(*whu, label_selected="0"))
    assert (feed, cache) == ("host", None) and type(pair_loader) is ppipe.PairBatchLoader
    assert unc_feed == ("native" if native_unc and eraser is None else "host")
    assert isinstance(unc_loader, ppipe.NativeWHUBatchLoader if unc_feed == "native"
                      else ppipe.BatchLoader)


def test_rsss_feed_choice_with_the_eraser(oscd):
    """The erased train list leaves the tile cache for ``BatchLoader``; the
    test list, without a transform, keeps the native loader."""
    from fcdgan_tpu_torch import native
    from fcdgan_tpu_torch.config import RSSSConfig
    from fcdgan_tpu_torch.demos.demo_rsss import tile_feed

    cfg = RSSSConfig(img_dir=oscd, device="cpu", random_eraser=True)
    eraser = perasers.build_eraser(True)
    train = pds.OSCDDataset(oscd, "train.txt", transforms=[eraser] * 2, patch_size=(32, 32),
                            overlap_padding=(4, 4))
    test = pds.OSCDDataset(oscd, "test.txt", patch_size=(32, 32), overlap_padding=(4, 4))
    feed, test_feed, train_cache, test_cache = tile_feed(cfg, train, test, "cpu")
    assert (feed, train_cache, test_cache) == ("host", None, None)
    assert test_feed == ("native" if native.native_available() else "host")
