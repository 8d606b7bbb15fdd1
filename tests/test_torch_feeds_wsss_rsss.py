"""The WSSS and RSSS drivers on their host feeds, on the CPU at a tiny size.

``demo_wsss --slice-cache off`` trains through the native slice loaders
(``native``) and ``demo_rsss --tile-cache off`` through
``NativeOSCDBatchLoader`` (padded tails); each run writes every artifact and
names its feed. The feed choices: the Python loaders without the native
library (``host``), the native loaders for ``--slice-cache auto`` past
``FCDGAN_SLICE_CACHE_MAX_MB``, the resident caches within the budgets;
``on`` past the budget raises.
"""

import os

import numpy as np
import pytest

from fcdgan_tpu_torch import native
from fcdgan_tpu_torch.data.raster import open_raster, read_image
from fcdgan_tpu_torch.data.synthetic import make_oscd_dataset, make_whu_dataset
from fcdgan_tpu_torch.demos import demo_rsss, demo_wsss


@pytest.fixture()
def whu(tmp_path):
    root = str(tmp_path)
    make_whu_dataset(root, 3, 5, 48)
    return ["--img-dir-x", os.path.join(root, "before"), "--img-dir-y",
            os.path.join(root, "after"), "--ref-dir", os.path.join(root, "Label"),
            "--label-dir", root, "--out-g-model-dir", os.path.join(root, "G"),
            "--device", "cpu", "--msssim-weights", "0.5,0.5", "--batch-size", "3",
            "--unc-batch-size", "5", "--init-num-epochs-g", "1", "--num-epochs", "1",
            "--log-tensorboard", "false", "--progress", "false"]


def test_wsss_host_feed_trains(whu):
    out = demo_wsss.main([*whu, "--slice-cache", "off"])
    assert out["feed"] == "native"
    assert out["evaluator"].confusion_matrix.sum() == 3 * 48 * 48
    names = sorted(os.listdir(out["density_dir"]))
    assert len(names) == 3
    assert read_image(os.path.join(out["out_dir"], names[0])).shape[:2] == (48, 48)
    for key in ("para_path", "smodel_path", "gmodel_path", "dmodel_path"):
        assert os.path.isfile(out[key]), key
    assert all(np.isfinite(v) for ph in out["epoch_metrics"].values() for m in ph
               for v in m.values())


@pytest.mark.parametrize("cache,budget,library,feed", [
    ("off", None, True, "native"), ("off", None, False, "host"),
    ("auto", "0.01", True, "native"), ("auto", None, True, "resident")])
def test_wsss_feed_choice(whu, monkeypatch, cache, budget, library, feed):
    """``slice_feed``: the resident stacks within ``FCDGAN_SLICE_CACHE_MAX_MB``,
    else the native slice loaders, else the Python loaders."""
    import random

    from fcdgan_tpu_torch.config import WSSSConfig, parse_cli
    from fcdgan_tpu_torch.data.datasets import WHUPairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.pipeline import BatchLoader, PairBatchLoader

    if budget is not None:
        monkeypatch.setenv("FCDGAN_SLICE_CACHE_MAX_MB", budget)
    if not library:
        monkeypatch.setattr(native, "can_open", lambda path: False)
    cfg = parse_cli(WSSSConfig, [a for a in whu if a not in ("--device", "cpu")]
                    + ["--slice-cache", cache])
    scaler = Normalize([100.0] * 3, [30.0] * 3, [101.0] * 3, [31.0] * 3)
    pair = WHUPairDataset(cfg.img_dir_x, cfg.img_dir_y, cfg.ref_dir, cfg.label_dir,
                          scale=scaler, rng=random.Random(0))
    got, unc_got, cache_obj, pair_loader, unc_loader = demo_wsss.slice_feed(cfg, pair, scaler,
                                                                            "cpu")
    assert got == unc_got == feed and (cache_obj is not None) == (feed == "resident")
    if feed == "host":
        assert type(pair_loader) is PairBatchLoader and type(unc_loader) is BatchLoader
    batch = next(iter(pair_loader))
    assert len(batch["weight"]) == 3


def test_wsss_slice_cache_on_past_its_budget_raises(whu, monkeypatch):
    monkeypatch.setenv("FCDGAN_SLICE_CACHE_MAX_MB", "0.01")
    with pytest.raises(RuntimeError, match="--slice-cache on"):
        demo_wsss.main([*whu, "--slice-cache", "on"])


@pytest.fixture()
def oscd(tmp_path):
    root = str(tmp_path)
    make_oscd_dataset(root, xsize=48, ysize=48, rects=((5, 6, 10, 8), (28, 26, 10, 12)))
    return root, ["--img-dir", root, "--out-g-model-dir", os.path.join(root, "G"),
                  "--device", "cpu", "--patch-size", "32,32", "--overlap-padding", "4,4",
                  "--msssim-weights", "0.5,0.5", "--init-batch-size", "4", "--batch-size", "3",
                  "--init-num-epochs-g", "1", "--num-epochs", "1", "--log-tensorboard",
                  "false", "--progress", "false", "--ext", "_h"]


def test_rsss_host_feed_trains(oscd):
    root, args = oscd
    out = demo_rsss.main([*args, "--tile-cache", "off"])
    assert out["feed"] == "native"
    assert out["test_tiles"] % 3 != 0  # a padded tail
    d = os.path.join(root, "gamma", "ImagePair")
    density = open_raster(os.path.join(d, out["density_name"])).read_block()
    color = open_raster(os.path.join(d, out["color_name"])).read_block()
    assert density.shape == color.shape == (48, 48, 1)
    assert np.isfinite(density).all() and set(np.unique(color).tolist()) <= {0, 1, 2, 3}
    # the test evaluation and the inference cover the test scene once each
    assert out["evaluator"].confusion_matrix.sum() == 48 * 48
    assert out["test_evaluator"].confusion_matrix.sum() == 48 * 48
    for key in ("para_path", "smodel_path", "gmodel_path", "dmodel_path"):
        assert os.path.isfile(out[key]), key


@pytest.mark.parametrize("cache,library,feed", [("off", True, "native"),
                                                ("off", False, "host"),
                                                ("auto", True, "resident")])
def test_rsss_feed_choice(oscd, monkeypatch, cache, library, feed):
    """``tile_feed``: the resident stacks, else ``NativeOSCDBatchLoader``, else
    ``BatchLoader``; the loaders of each feed give the same items."""
    from fcdgan_tpu_torch.config import RSSSConfig
    from fcdgan_tpu_torch.data.datasets import OSCDDataset

    root, _ = oscd
    if not library:
        monkeypatch.setattr(native, "can_open", lambda path: False)
    ds = OSCDDataset(root, "train.txt", patch_size=(32, 32), overlap_padding=(4, 4))
    test = OSCDDataset(root, "test.txt", patch_size=(32, 32), overlap_padding=(4, 4))
    got, test_got, train_cache, test_cache = demo_rsss.tile_feed(RSSSConfig(tile_cache=cache),
                                                                 ds, test, "cpu")
    assert got == test_got == feed and (train_cache is not None) == (feed == "resident")
    items = [b["item"].tolist() for b in
             demo_rsss._loader(got, ds, train_cache, 5, True, 3)]
    plain = [b["item"].tolist() for b in demo_rsss._loader("host", ds, None, 5, True, 3)]
    assert [i[:len(p)] for i, p in zip(items, plain)] == plain


def test_rsss_tile_cache_on_past_its_budget_raises(oscd, monkeypatch):
    _, args = oscd
    monkeypatch.setenv("FCDGAN_TILE_CACHE_MAX_MB", "0.001")
    with pytest.raises(RuntimeError, match="--tile-cache on"):
        demo_rsss.main([*args, "--tile-cache", "on"])
