"""The rolling-window scene cache against the JAX package's and the port's
resident cache.

``DeviceSceneWindowCache`` plans its slabs as the JAX one does (rows per
slab, slab count and sizes, ``supports``) over scene sizes, sample types and
budgets; its loader gives the JAX batches for a seed and visits every tile
once an epoch; its tiles are bit-equal to the port's resident cache and to
the JAX window cache; its stitched density is bit-equal to the resident
fused density on every serving path (device canvas or a download per slab,
float32, uint8 or bfloat16) and within 5e-4 of the JAX
window cache's at carried weights.
"""

import numpy as np
import pytest
import torch

import jax

from fcdgan_tpu.data import device_cache as jdc
from fcdgan_tpu.data.datasets import ScenePairDataset as JScenePairDataset
from fcdgan_tpu.data.normalize import Normalize as JNormalize
from fcdgan_tpu.data.tiff import TiffWriter
from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu_torch.data import device_cache as pdc
from fcdgan_tpu_torch.data.datasets import ScenePairDataset
from fcdgan_tpu_torch.data.normalize import Normalize
from fcdgan_tpu_torch.data.synthetic import make_usss_scene
from fcdgan_tpu_torch.models.segmentor import Segmentor

STATS = ([100.013175, 101.514225, 99.899775], [30.5321279982828, 29.2906071402124, 31.38792],
         [105.1234567, 104.0000001, 106.54321], [31.000001, 30.25013, 32.111])
PATCH, PAD = (48, 40), (4, 3)


def _write(path, arr):
    with TiffWriter(path, arr.shape[1], arr.shape[0], arr.shape[2], arr.dtype) as w:
        w.write_block(arr)


def _rasters(root, h, w, dtype, ref_dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    hi = 4000 if dt.kind != "u" or dt.itemsize > 1 else 250
    paths = {}
    for name in ("x", "y"):
        a = rng.integers(0, hi, size=(h, w, 3)).astype(dt)
        paths[name] = str(root / f"{name}.tif")
        _write(paths[name], a)
    paths["ref"] = None
    if ref_dtype is not None:
        paths["ref"] = str(root / "ref.tif")
        _write(paths["ref"], rng.integers(0, 2, size=(h, w, 1)).astype(ref_dtype))
    return paths


@pytest.mark.parametrize("ref_dtype", [None, "uint8", "float32"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "int32", "float32", "float64"])
def test_slab_plan_matches_jax(tmp_path, monkeypatch, dtype, ref_dtype):
    monkeypatch.delenv("FCDGAN_SCENE_WINDOW_MB", raising=False)
    for k, (h, w) in enumerate(((61, 47), (130, 100), (211, 37))):
        root = tmp_path / str(k)
        root.mkdir()
        paths = _rasters(root, h, w, dtype, ref_dtype)
        port = ScenePairDataset(paths["x"], paths["y"], ref_path=paths["ref"],
                                enhance=Normalize(*STATS), patch_size=PATCH,
                                overlap_padding=PAD)
        ref = JScenePairDataset(paths["x"], paths["y"], ref_path=paths["ref"],
                                enhance=JNormalize(*STATS), patch_size=PATCH,
                                overlap_padding=PAD)
        for mb in ("0.02", "0.15", "0.4", "1", "100"):
            for var in ("FCDGAN_SCENE_WINDOW_MB", "FCDGAN_SCENE_CACHE_MAX_MB"):
                monkeypatch.setenv(var, mb)
                rows = pdc.DeviceSceneWindowCache._plan_rows(port)
                assert rows == jdc.DeviceSceneWindowCache._plan_rows(ref), (h, w, mb, var)
                assert pdc.DeviceSceneWindowCache.supports(port) == \
                    jdc.DeviceSceneWindowCache.supports(ref) == (rows >= 1)
                if rows >= 1:
                    got = pdc.DeviceSceneWindowCache(port, port.enhance, "cpu")
                    want = jdc.DeviceSceneWindowCache(ref, ref.enhance)
                    assert (got.n_slabs, got.slab_sizes) == (want.n_slabs, want.slab_sizes)
                    assert sum(got.slab_sizes) == len(port)
                monkeypatch.delenv(var)


def _scene(tmp_path, dtype="uint16", h=130, w=100):
    paths = make_usss_scene(str(tmp_path), w, h, 3, dtype=np.dtype(dtype), seed=2)
    port = ScenePairDataset(paths["x"], paths["y"], ref_path=paths["ref"],
                            enhance=Normalize(*STATS), patch_size=PATCH, overlap_padding=PAD)
    ref = JScenePairDataset(paths["x"], paths["y"], ref_path=paths["ref"],
                            enhance=JNormalize(*STATS), patch_size=PATCH, overlap_padding=PAD)
    return port, ref


@pytest.mark.parametrize("tail", ["short", "pad"])
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_epochs_match_jax_and_tiles_match_the_resident_cache(tmp_path, monkeypatch, dtype, tail):
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.3" if dtype == "uint16" else "0.6")
    port, ref = _scene(tmp_path, dtype)
    win = pdc.DeviceSceneWindowCache(port, port.enhance, "cpu")
    jwin = jdc.DeviceSceneWindowCache(ref, ref.enhance)
    assert win.n_slabs >= 3
    resident = pdc.DeviceSceneCache(port, port.enhance, "cpu")
    got_loader = win.loader(4, shuffle=True, seed=9, tail=tail)
    want_loader = jwin.loader(4, ref, shuffle=True, seed=9, tail=tail)
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        seen = []
        for g, w in zip(got, want):
            for k in ("item", "weight", "slab"):
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            seen += [int(i) for i, wt in zip(g["item"], g["weight"]) if wt > 0]
            tiles = win.complete(g)
            res = resident.complete(g)
            jt = jwin.complete(w)
            for key in ("x", "y", "ref"):
                np.testing.assert_array_equal(tiles[key].numpy(), res[key].numpy(), err_msg=key)
                np.testing.assert_array_equal(tiles[key].numpy(), np.asarray(jt[key]),
                                              err_msg=key)
            np.testing.assert_array_equal(tiles["weight"].numpy(), np.asarray(g["weight"]))
        assert sorted(seen) == list(range(len(port)))  # every tile once an epoch
    waits = win.drain_slab_waits()
    assert len(waits) >= 2 * win.n_slabs - 1 and win.slab_waits == []


class _Dense(torch.nn.Module):
    """A small stand-in for S (NCHW pairs -> a (B, 1, H, W) density): the
    paths under test stitch whatever the model gives; the full-width
    Segmentor runs in the JAX comparison below and on the card."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(3)
        self.conv = torch.nn.Conv2d(6, 1, 5, padding=2)

    def forward(self, x, y):
        return torch.sigmoid(4.0 * self.conv(torch.cat([x, y], 1)))


@pytest.fixture(scope="module")
def segmentor():
    return _Dense().eval()


SERVE_PATHS = {  # tag: (density dtype, environment)
    "canvas_overlap": ("float32", {}),
    "slabs_overlap": ("float32", {"FCDGAN_SERVE_CANVAS_MAX_MB": "0.001"}),
    "canvas_uint8": ("uint8", {}),
    "slabs_uint8": ("uint8", {"FCDGAN_SERVE_CANVAS_MAX_MB": "0.001"}),
    "canvas_bfloat16": ("bfloat16", {}),
    "slabs_bfloat16": ("bfloat16", {"FCDGAN_SERVE_CANVAS_MAX_MB": "0.001"}),
}


@pytest.mark.parametrize("tag", list(SERVE_PATHS))
def test_window_density_is_bit_equal_to_the_resident_pass(tmp_path, monkeypatch, segmentor,
                                                          tag):
    dd, env = SERVE_PATHS[tag]
    monkeypatch.delenv("FCDGAN_SERVE_BS", raising=False)
    port, _ = _scene(tmp_path)
    want = pdc.DeviceSceneCache(port, port.enhance, "cpu").stitched_density(
        segmentor, 3, dd)
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.3")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    win = pdc.DeviceSceneWindowCache(port, port.enhance, "cpu")
    assert win.n_slabs >= 3 and min(win.slab_sizes) >= 3
    got = win.stitched_density(segmentor, 3, dd)
    assert got.shape == (130, 100) and got.dtype == np.float32
    assert 0.01 < got.std() and 0 <= got.min() and got.max() <= 1
    np.testing.assert_array_equal(got, want)


def test_bfloat16_slabs_stay_within_their_rounding(tmp_path, monkeypatch, segmentor):
    """``FCDGAN_SERVE_SLAB_DTYPE=bfloat16``: a float32 scene's slabs ride as
    bf16, not bit-exact; the density stays close to the resident one."""
    monkeypatch.delenv("FCDGAN_SERVE_BS", raising=False)
    port, _ = _scene(tmp_path, "float32")
    want = pdc.DeviceSceneCache(port, port.enhance, "cpu").stitched_density(segmentor, 3)
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.6")
    monkeypatch.setenv("FCDGAN_SERVE_SLAB_DTYPE", "bfloat16")
    win = pdc.DeviceSceneWindowCache(port, port.enhance, "cpu")
    assert win._read_slab_host(0)[1].dtype == torch.bfloat16
    got = win.stitched_density(segmentor, 3)
    assert 0 < np.abs(got - want).max() <= 0.05


def test_window_density_matches_jax_at_carried_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("FCDGAN_SERVE_BS", raising=False)
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.3")
    port, ref = _scene(tmp_path)
    model = JaxSegmentor(3, bilinear=True)
    z = np.zeros((1, 40, 48, 3), np.float32)
    vs = model.init({"params": jax.random.PRNGKey(11)}, z, z, train=False)
    rng = np.random.default_rng(11)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 2.0, size=v.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.5, size=v.shape)).astype(np.float32),
        vs["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, vs["params"])
    conv = params["OutConv_0"]["TorchConv_0"]["Conv_0"]
    conv["kernel"] = conv["kernel"] * 50.0
    net = Segmentor(3).eval()
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in variables_to_torch(params, stats).items()})
    jwin = jdc.DeviceSceneWindowCache(ref, ref.enhance)
    want = jwin.stitched_density(_jax_infer(model), {"params": params, "batch_stats": stats},
                                 batch_size=3)
    win = pdc.DeviceSceneWindowCache(port, port.enhance, "cpu")
    got = win.stitched_density(net, 3)
    assert win.n_slabs == jwin.n_slabs >= 3
    assert got.std() > 0.01
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-4)


_INFER = {}


def _jax_infer(model):
    """One eval-mode function per model (a static argument of the JAX jits)."""
    if model not in _INFER:
        _INFER[model] = lambda st, x, y: model.apply(st, x, y, train=False).astype(np.float32)
    return _INFER[model]
