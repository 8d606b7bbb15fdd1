"""The data, losses and schedules of the RSSS training slice against the JAX
package's: the synthetic OSCD layout, the OSCD datasets and per-scene
normalizers, the device-resident tile stacks, ``region_loss`` and the
adversarial schedules; and every option of the port's RSSS driver, through
the driver on the CPU. The steps and the driver's end-to-end runs are in
``test_torch_rsss.py``."""

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

from torch_threads import one_torch_thread  # noqa: F401

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
    calls = []

    def sync(img, region=None):  # a scene's sync transform: x first, then y with its region
        calls.append(region)
        return img + 1.0, "r"

    plain = pds.OSCDDataset(root, "train.txt", patch_size=PATCH, overlap_padding=PAD)
    moved = pds.OSCDDataset(root, "train.txt", transforms=[None, sync], patch_size=PATCH,
                            overlap_padding=PAD)
    for i in (0, len(plain) - 1):  # a tile of each scene
        for a, b, k in zip(moved[i][:2], plain[i][:2], "xy"):
            np.testing.assert_array_equal(a, b + (1.0 if i else 0.0), err_msg=k)
    assert calls == [None, "r"]
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


def _run_option(tmp_path, monkeypatch, *flags):
    """The driver with ``flags`` on the layout of the ``oscd`` fixture (48 px,
    3 uint16 scenes: 8 train tiles in batches of 3, a tail of 2; 4 test
    tiles), no G pretrain, one adversarial epoch with its train-mode test
    evaluation; checks the artifacts and returns the result, the batch sizes
    of the adversarial steps and of the test evaluation, and the erasers the
    driver built."""
    import shutil

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.demos import demo_rsss
    from fcdgan_tpu_torch.train.steps import RSSSSteps

    make_oscd_dataset(str(tmp_path), xsize=SIDE, ysize=SIDE, rects=RECTS, seed=2,
                      dtype=np.uint16)
    sizes = {"adversarial": [], "eval_confusion_train": []}
    erasers, build = [], demo_rsss.build_eraser
    for name, calls in sizes.items():
        def recorded(self, x, *args, _fn=getattr(RSSSSteps, name), _calls=calls):
            _calls.append(int(x.shape[0]))
            return _fn(self, x, *args)

        monkeypatch.setattr(RSSSSteps, name, recorded)
    monkeypatch.setattr(demo_rsss, "build_eraser",
                        lambda *a: erasers.append(build(*a)) or erasers[-1])
    out = demo_rsss.main([
        "--img-dir", str(tmp_path), "--out-g-model-dir", str(tmp_path / "G"), "--device", "cpu",
        "--msssim-weights", "0.5,0.5", "--patch-size", "32,32", "--overlap-padding", "4,4",
        "--batch-size", "3", "--init-num-epochs-g", "0", "--num-epochs", "1",
        "--log-tensorboard", "false", "--progress", "false", "--save-checkpoints", "false",
        "--ext", "_o", *flags])
    for name in (out["density_name"], out["color_name"]):
        r = open_raster(os.path.join(str(tmp_path), "gamma", "ImagePair", name)).read_block()
        assert r.shape[:2] == (SIDE, SIDE) and np.isfinite(r).all()
    assert out["evaluator"].confusion_matrix.sum() == SIDE * SIDE
    assert os.path.isfile(out["para_path"])
    for m in out["epoch_metrics"]["adv"]:
        assert all(np.isfinite(v) for k, v in m.items() if k != "f1")
    shutil.rmtree(str(tmp_path / "G"), ignore_errors=True)
    return out, sizes, erasers


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("flag", [["--siamese-stats", "split"], ["--remat", "true"],
                                  ["--tail", "pad"], ["--random-eraser", "true"], ["--n-devices", "1"],
                                  ["--checkpoint-every", "1"], ["--resume", "true"],
                                  ["--density-dtype", "uint8"], ["--profile-dir", "p"],
                                  ["--debug-nans", "true"], ["--num-processes", "2"]])
def test_unported_options_raise(flag, tmp_path, monkeypatch):
    """The options the RSSS driver once left out each run through the driver
    on the CPU and write their artifacts (``_run_option``). With ``--tail
    pad`` the adversarial steps see the padded tail and the train-mode test
    evaluation trims it; the eraser leaves the resident tiles for
    ``BatchLoader``. ``--n-devices 1`` runs every data-parallel path of the
    driver in a world of one gloo rank here (padded tails, the train-mode
    test evaluation keeping its padded tail, the all-reduces, the
    inference's gathers); a multi-host world without its coordinator and
    id raises."""
    import json
    import shutil

    from fcdgan_tpu_torch.demos import demo_rsss

    if flag[0] == "--num-processes":
        with pytest.raises(ValueError, match="--coordinator-address and --process-id"):
            demo_rsss.main(["--img-dir", str(tmp_path), "--device", "cpu", *flag])
        return
    resume = tmp_path / "model_o" / "resume.ckpt"
    if flag[0] == "--resume":  # a record of a finished adversarial phase
        resume.mkdir(parents=True)
        (resume / "meta.json").write_text(json.dumps({"phase": "adv", "epoch": 0}))
    if flag[0] == "--profile-dir":
        flag = [flag[0], str(tmp_path / flag[1])]
    out, sizes, erasers = _run_option(tmp_path, monkeypatch, *flag)
    assert out["feed"] == ("host" if flag[0] == "--random-eraser" else "resident")
    assert (erasers[0] is not None) == (flag[0] == "--random-eraser")
    padded = flag[0] in ("--tail", "--n-devices")
    want = {"adversarial": [3, 3, 3] if padded else [3, 3, 2],
            "eval_confusion_train": [3, 3] if flag[0] == "--n-devices" else [3, 1]}
    assert sizes == ({k: [] for k in want} if flag[0] == "--resume" else want)
    assert out["dstate"].siamese_stats == out["sstate"].siamese_stats == (
        "split" if flag[0] == "--siamese-stats" else "joint")
    if flag[0] == "--checkpoint-every":
        assert json.loads((resume / "meta.json").read_text()) == {"phase": "adv", "epoch": 0}
        assert sorted(os.listdir(resume)) == ["meta.json", "netD.pt", "netG.pt", "netS.pt"]
        shutil.rmtree(resume)  # half a GB of S and its RMSprop state
    if flag[0] == "--density-dtype":
        from fcdgan_tpu_torch.data.raster import open_raster

        d = open_raster(os.path.join(str(tmp_path), "gamma", "ImagePair",
                                     out["density_name"])).read_block()
        np.testing.assert_array_equal(d * 255, np.round(d * 255))
    if flag[0] == "--profile-dir":
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(flag[1]))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("flag", [["--eraser-regions", "2"], ["--erase-thresh", "0.2"],
                                  ["--learning-rate", "1e-3"], ["--device-normalize", "on"],
                                  ["--platform", "cpu"]])
def test_unread_options_are_rejected(flag, tmp_path, monkeypatch):
    """Flags of no field of the config are rejected; ``--eraser-regions``
    and ``--erase-thresh`` are fields since the eraser runs, and reach it
    (with ``--random-eraser``, through the driver)."""
    from fcdgan_tpu_torch.data.erasers import RandomEraser, RandomEraserMultiRegion
    from fcdgan_tpu_torch.demos import demo_rsss

    if flag[0] not in ("--eraser-regions", "--erase-thresh"):
        with pytest.raises(SystemExit):
            demo_rsss.main(["--img-dir", str(tmp_path), "--device", "cpu", *flag])
        return
    _, _, erasers = _run_option(tmp_path, monkeypatch, "--random-eraser", "true", *flag)
    eraser = erasers[0]
    if flag[0] == "--eraser-regions":
        assert isinstance(eraser, RandomEraserMultiRegion) and eraser.multi_region == 2
    else:
        assert isinstance(eraser, RandomEraser) and eraser.erase_thresh == 0.2


def test_driver_defaults_to_the_card(monkeypatch, tmp_path):
    from fcdgan_tpu_torch.config import RSSSConfig
    from fcdgan_tpu_torch.demos import demo_rsss

    assert RSSSConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_rsss.main(["--img-dir", str(tmp_path)])
