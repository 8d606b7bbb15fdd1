"""The serving slice end to end: the port's tools.infer against the JAX
package's on one scene, one seeded SModel.pkl and the same settings."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from fcdgan_tpu.data.synthetic import make_usss_scene
from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.tools import infer as jax_infer
from fcdgan_tpu_torch.data.raster import open_raster
from fcdgan_tpu_torch.tools import infer as port_infer

# the seeded model's densities sit around 0.1: threshold there so both
# classes occur and every metric is finite
THRESH = 0.1
SETTINGS = dict(patch_size=(48, 48), overlap_padding=(4, 4), batch_size=2,
                compute_dtype="float32", ref_name="ref.tif", prob_thresh=THRESH)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    jdir, pdir = str(root / "jax"), str(root / "port")
    make_usss_scene(jdir, 96, 96, 3, seed=3)
    shutil.copytree(jdir, pdir)
    model = JaxSegmentor(3, bilinear=True)
    z = np.zeros((1, 48, 48, 3), np.float32)
    vs = model.init({"params": jax.random.PRNGKey(11)}, z, z, train=False)
    rng = np.random.default_rng(11)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 2.0, size=v.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.5, size=v.shape)).astype(np.float32),
        vs["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, vs["params"])
    conv = params["OutConv_0"]["TorchConv_0"]["Conv_0"]
    conv["kernel"] = conv["kernel"] * 50.0  # density spread over (0, 1)
    sd = {k: torch.from_numpy(v) for k, v in variables_to_torch(params, stats).items()}
    smodel = str(root / "SModel.pkl")
    torch.save(sd, smodel)

    mp = pytest.MonkeyPatch()
    mp.delenv("FCDGAN_SERVE_BS", raising=False)  # batch-exact JAX chunking
    try:
        jout = jax_infer.run(jax_infer.InferConfig(
            dir=jdir, smodel=smodel, platform="cpu", progress=False, **SETTINGS))
    finally:
        mp.undo()
    pout = port_infer.run(port_infer.InferConfig(
        dir=pdir, smodel=smodel, device="cpu", **SETTINGS))
    read = lambda p: open_raster(p).read_block()[..., 0]  # noqa: E731
    return {"jax": jout, "port": pout,
            "jd": read(jout["density_path"]), "pd": read(pout["density_path"]),
            "jc": read(jout["color_path"]), "pc": read(pout["color_path"]),
            "dirs": (jdir, pdir)}


def test_density_matches_jax(served):
    jd, pd = served["jd"], served["pd"]
    assert pd.shape == jd.shape == (96, 96)
    assert np.isfinite(pd).all() and pd.min() >= 0.0 and pd.max() <= 1.0
    assert pd.std() > 0.01  # not a flat map
    np.testing.assert_allclose(pd, jd, atol=5e-4)


def test_color_map_and_metrics_match_jax(served):
    jd = served["jd"]
    near = np.abs(jd - THRESH) <= 1e-3   # a threshold flip is allowed there only
    assert np.array_equal(served["pc"][~near], served["jc"][~near])
    share = near.mean()
    for key in ("oa", "f1"):
        assert np.isfinite(served["port"][key])
        assert abs(served["port"][key] - served["jax"][key]) <= share + 1e-12
    assert served["port"]["pixels"] == served["jax"]["pixels"] == 96 * 96


def test_stats_caches_are_interchangeable(served):
    jdir, pdir = served["dirs"]
    for name in ("T1_stats.txt", "T2_stats.txt"):
        j = np.loadtxt(os.path.join(jdir, name), usecols=(1, 2, 3), dtype=str)
        p = np.loadtxt(os.path.join(pdir, name), usecols=(1, 2, 3), dtype=str)
        np.testing.assert_allclose(p.astype(float), j.astype(float), rtol=1e-12)
