"""The USSS driver on each of its feeds, on the CPU at a tiny size.

``--scene-cache window`` trains from the rolling-window slabs and writes the
density that the resident cache's fused pass gives with the run's own saved
S; ``--scene-cache off`` trains from the native raw tiles normalized on the
device (``native_raw``) and runs the tile-loop inference; the feed choice
takes their float32 assembly with ``--device-normalize off`` (``native``)
or the Python loader without the native library (``host``), each batch the
resident gather's within one ulp. The options that cannot be met raise.
"""

import os

import numpy as np
import pytest

from fcdgan_tpu_torch import native
from fcdgan_tpu_torch.data.datasets import ScenePairDataset
from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
from fcdgan_tpu_torch.data.normalize import Normalize
from fcdgan_tpu_torch.data.raster import open_raster
from fcdgan_tpu_torch.data.stats import dataset_meanstd
from fcdgan_tpu_torch.data.synthetic import make_usss_scene
from fcdgan_tpu_torch.demos import demo_usss
from fcdgan_tpu_torch.io.checkpoint import load_segmentor

# one joint epoch (the pretrain phases read the same feed; tests/test_torch_usss.py
# runs them)
ARGS = ["--device", "cpu", "--patch-size", "48,48", "--overlap-padding", "4,4",
        "--msssim-weights", "0.5,0.5", "--batch-size", "4", "--init-num-epochs-g", "0",
        "--init-num-epochs-s", "0", "--num-epochs", "1", "--log-tensorboard", "false",
        "--progress", "false"]


@pytest.fixture()
def scene(tmp_path):
    make_usss_scene(str(tmp_path), 96, 96, 3, dtype=np.uint16)
    return str(tmp_path)


def _density(out):
    return open_raster(out["density_path"]).read_block()[..., 0]


def _check_artifacts(out):
    d = _density(out)
    assert d.shape == (96, 96) and np.isfinite(d).all() and 0 <= d.min() <= d.max() <= 1
    for key in ("color_path", "para_path", "smodel_path", "gmodel_path"):
        assert os.path.isfile(out[key]), key
    assert out["evaluator"].confusion_matrix.sum() == 96 * 96
    return d


def test_window_run_writes_the_resident_density_of_its_own_s(scene, monkeypatch):
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.3")  # three one-row slabs
    out = demo_usss.main(["--dir", scene, "--scene-cache", "window", "--ext", "_w", *ARGS])
    assert out["feed"] == "window" and out["n_slabs"] == 3
    assert len(out["slab_waits"]) >= 3
    got = _check_artifacts(out)
    scaler = Normalize(*dataset_meanstd(os.path.join(scene, "T1_stats.txt"),
                                        os.path.join(scene, "T2_stats.txt"), None))
    ds = ScenePairDataset(os.path.join(scene, "T1.tif"), os.path.join(scene, "T2.tif"),
                          enhance=scaler, patch_size=(48, 48), overlap_padding=(4, 4))
    want = DeviceSceneCache(ds, scaler, "cpu").stitched_density(
        load_segmentor(out["smodel_path"]), batch_size=4)
    np.testing.assert_array_equal(got, want)


def test_host_feed_trains_and_runs_the_tile_loop(scene):
    out = demo_usss.main(["--dir", scene, "--scene-cache", "off", "--ext", "_h", *ARGS])
    assert out["feed"] == "native_raw" and out["n_slabs"] is None
    _check_artifacts(out)
    assert len(out["epoch_metrics"]["joint"]) == 1
    assert all(np.isfinite(v) for ph in out["epoch_metrics"].values() for m in ph
               for v in m.values())


@pytest.mark.parametrize("feed,normalize,library", [("native_raw", "auto", True),
                                                    ("native", "off", True),
                                                    ("host", "auto", False)])
def test_host_feed_choice(scene, monkeypatch, feed, normalize, library):
    """``scene_feed`` with --scene-cache off: the raw native tiles (device
    normalized), the float32 native tiles, or the Python loader without the
    native library; each feed's first batch is the resident gather's within
    one float32 ulp."""
    import torch

    from fcdgan_tpu_torch.config import USSSConfig
    from fcdgan_tpu_torch.data.pipeline import device_put_batch

    if not library:
        monkeypatch.setattr(native, "can_open", lambda path: False)
    scaler = Normalize([100.013175, 101.514225, 99.899775], [30.53, 29.29, 31.38],
                       [105.1234567, 104.0000001, 106.54321], [31.0, 30.25, 32.11])
    ds = ScenePairDataset(os.path.join(scene, "T1.tif"), os.path.join(scene, "T2.tif"),
                          ref_path=os.path.join(scene, "ref.tif"), enhance=scaler,
                          patch_size=(48, 48), overlap_padding=(4, 4))
    cfg = USSSConfig(dir=scene, batch_size=4, scene_cache="off", device_normalize=normalize)
    got, cache, loader, placer = demo_usss.scene_feed(cfg, ds, scaler, "cpu")
    assert (got, cache) == (feed, None) and (placer is not None) == (feed == "native_raw")
    batch = next(iter(loader))
    db = device_put_batch(batch, "cpu")
    db = placer(db) if placer is not None else db
    want = DeviceSceneCache(ds, scaler, "cpu").complete(batch)
    for k in ("x", "y"):
        np.testing.assert_array_max_ulp(db[k].numpy(), want[k].numpy(), maxulp=1)
    assert torch.equal(db["ref"].float(), want["ref"])


def test_options_that_cannot_be_met_raise(scene, tmp_path, monkeypatch):
    monkeypatch.setenv("FCDGAN_SCENE_CACHE_MAX_MB", "0.05")
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.05")  # not even one tile row
    for cache in ("on", "window"):
        with pytest.raises(RuntimeError, match=f"--scene-cache {cache}"):
            demo_usss.main(["--dir", scene, "--scene-cache", cache, *ARGS])
    monkeypatch.setattr(native, "can_open", lambda path: False)
    with pytest.raises(RuntimeError, match="--device-normalize on"):
        demo_usss.main(["--dir", scene, "--scene-cache", "off", "--device-normalize", "on",
                        *ARGS])
    with pytest.raises(ValueError, match="--scene-cache"):
        demo_usss.main(["--dir", scene, "--scene-cache", "sometimes", *ARGS])
