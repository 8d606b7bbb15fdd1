"""The oscd serving mode: the port's tools.infer --mode oscd against the JAX
package's run_oscd on two test scenes, one seeded SModel.pkl and the same
settings, on the fused per-scene path and on the streaming path of each."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

import fcdgan_tpu.data.pipeline as jax_pipeline
from fcdgan_tpu.data.synthetic import make_oscd_dataset
from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.tools import infer as jax_infer
from fcdgan_tpu_torch.data.raster import open_raster
from fcdgan_tpu_torch.tools import infer as port_infer

SCENES = ("gamma", "delta")
THRESH = 0.1  # the seeded model's densities sit around it: both classes occur
SETTINGS = dict(mode="oscd", patch_size=(40, 40), overlap_padding=(4, 4), batch_size=3,
                compute_dtype="float32", prob_thresh=THRESH)
PATHS = {"fused": "auto", "stream": "stream"}


def seeded_smodel(path: str, nband: int, side: int) -> None:
    """A seeded reference-format SModel.pkl with random BN statistics and a
    widened output conv, so the densities spread over (0, 1)."""
    model = JaxSegmentor(nband, bilinear=True)
    z = np.zeros((1, side, side, nband), np.float32)
    vs = model.init({"params": jax.random.PRNGKey(11)}, z, z, train=False)
    rng = np.random.default_rng(11)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 2.0, size=v.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.5, size=v.shape)).astype(np.float32),
        vs["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, vs["params"])
    conv = params["OutConv_0"]["TorchConv_0"]["Conv_0"]
    conv["kernel"] = conv["kernel"] * 50.0
    torch.save({k: torch.from_numpy(v) for k, v in variables_to_torch(params, stats).items()},
               path)


def read(root, scene, name):
    return open_raster(os.path.join(root, scene, "ImagePair", name)).read_block()[..., 0]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("oscd")
    jdir, pdir = str(root / "jax"), str(root / "port")
    make_oscd_dataset(jdir, train_scenes=("alpha",), test_scenes=SCENES, xsize=64,
                      ysize=64, nband=4, seed=5)
    shutil.copytree(jdir, pdir)
    smodel = str(root / "SModel.pkl")
    seeded_smodel(smodel, 4, 40)
    mp = pytest.MonkeyPatch()
    mp.setenv("FCDGAN_SERVE_BS", "0")
    # the JAX streaming path's Python loader, the one the port has
    mp.delattr(jax_pipeline, "NativeOSCDBatchLoader")
    out = {"jax": {}, "port": {}, "dirs": (jdir, pdir)}
    try:
        for path, feed in PATHS.items():
            names = dict(out_name_density=f"density_{path}", out_name_binary=f"color_{path}")
            out["jax"][path] = jax_infer.run(jax_infer.InferConfig(
                dir=jdir, smodel=smodel, platform="cpu", progress=False, device_feed=feed,
                **names, **SETTINGS))
            out["port"][path] = port_infer.run(port_infer.InferConfig(
                dir=pdir, smodel=smodel, device="cpu", progress=False, device_feed=feed,
                **names, **SETTINGS))
        out["binary"] = port_infer.run(port_infer.InferConfig(
            dir=pdir, smodel=smodel, device="cpu", progress=False, write_color=False,
            out_name_density="density_bin", out_name_binary="binary", **SETTINGS))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_densities_match_jax(served, path):
    jdir, pdir = served["dirs"]
    assert served["port"][path]["fused"] == (path == "fused")
    for scene in SCENES:
        jd = read(jdir, scene, f"density_{path}")
        pd = read(pdir, scene, f"density_{path}")
        assert pd.shape == jd.shape == (64, 64)
        assert np.isfinite(pd).all() and pd.min() >= 0.0 and pd.max() <= 1.0
        assert pd.std() > 0.01
        np.testing.assert_allclose(pd, jd, atol=5e-4)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_colors_and_metrics_match_jax(served, path):
    jdir, pdir = served["dirs"]
    jout, pout = served["jax"][path], served["port"][path]
    near = []
    for scene in SCENES:
        jd = read(jdir, scene, f"density_{path}")
        n = np.abs(jd - THRESH) <= 1e-3  # a threshold flip is allowed there only
        jc, pc = read(jdir, scene, f"color_{path}"), read(pdir, scene, f"color_{path}")
        assert set(np.unique(pc).tolist()) <= {0.0, 1.0, 2.0, 3.0}
        assert np.array_equal(pc[~n], jc[~n])
        near.append(n)
    share = np.concatenate(near).mean()
    for key in ("scenes", "pixels", "density_name", "color_name"):
        assert pout[key] == jout[key]
    assert pout["scenes"] == list(SCENES) and pout["pixels"] == 2 * 64 * 64
    for key in ("oa", "f1"):
        assert np.isfinite(pout[key])
        assert abs(pout[key] - jout[key]) <= share + 1e-12


def test_write_color_false_writes_the_binary_detection(served):
    _, pdir = served["dirs"]
    for scene in SCENES:
        d, b = read(pdir, scene, "density_bin"), read(pdir, scene, "binary")
        assert set(np.unique(b).tolist()) == {0.0, 1.0}
        np.testing.assert_array_equal(b, (d > THRESH).astype(np.float32))


def test_statsms_caches_are_interchangeable(served):
    jdir, pdir = served["dirs"]
    for scene in SCENES:
        names = sorted(n for n in os.listdir(os.path.join(jdir, scene, "ImagePair"))
                       if n.endswith("_statsMS.txt"))
        assert len(names) == 2
        for name in names:
            j, p = (np.loadtxt(os.path.join(d, scene, "ImagePair", name), usecols=(1, 2, 3, 4),
                               dtype=str).astype(float) for d in (jdir, pdir))
            np.testing.assert_allclose(p, j, rtol=1e-12)
