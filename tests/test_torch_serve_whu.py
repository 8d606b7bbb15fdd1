"""The whu serving mode: the port's tools.infer --mode whu against the JAX
package's run_whu on 3 changed slices at batch 2 (so the tail batch holds
one slice), in bn_mode eval and train, with one seeded SModel.pkl."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from fcdgan_tpu.data.synthetic import make_whu_dataset
from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.tools import infer as jax_infer
from fcdgan_tpu_torch.data.datasets import WHUDataset
from fcdgan_tpu_torch.data.normalize import Normalize
from fcdgan_tpu_torch.data.raster import read_image
from fcdgan_tpu_torch.data.stats import dataset_meanstd
from fcdgan_tpu_torch.io.checkpoint import load_segmentor
from fcdgan_tpu_torch.tools import infer as port_infer

SIDE = 48
THRESH = 0.1  # the seeded model's densities sit around it: both classes occur
MODES = ("eval", "train")


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


def whu_dirs(root):
    return dict(img_dir_x=os.path.join(root, "before"), img_dir_y=os.path.join(root, "after"),
                ref_dir=os.path.join(root, "Label"), label_dir=root)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("whu")
    jdir, pdir = str(root / "jax"), str(root / "port")
    make_whu_dataset(jdir, n_changed=3, n_unchanged=1, size=SIDE, seed=4)
    shutil.copytree(jdir, pdir)
    smodel = str(root / "SModel.pkl")
    seeded_smodel(smodel, 3, SIDE)
    nets = []
    make = port_infer._segmentor

    def recording(*args):  # keeps the tool's S, for its running buffers
        nets.append(make(*args))
        return nets[-1]

    out = {"jax": {}, "port": {}, "smodel": smodel, "pdir": pdir}
    mp = pytest.MonkeyPatch()
    mp.setattr(port_infer, "_segmentor", recording)
    try:
        for bn in MODES:
            common = dict(mode="whu", smodel=smodel, bn_mode=bn, batch_size=2,
                          compute_dtype="float32", prob_thresh=THRESH, progress=False)
            out["jax"][bn] = jax_infer.run(jax_infer.InferConfig(
                platform="cpu", outdir=str(root / f"jax_{bn}"), **whu_dirs(jdir), **common))
            out["port"][bn] = port_infer.run(port_infer.InferConfig(
                device="cpu", outdir=str(root / f"port_{bn}"), **whu_dirs(pdir), **common))
    finally:
        mp.undo()
    out["net_train"] = nets[1]
    return out


def slice_names(out):
    names = sorted(os.listdir(out["out_dir"]))
    assert names == sorted(os.listdir(out["density_dir"])) and len(names) == 3
    return names


@pytest.mark.parametrize("bn", MODES)
def test_density_images_match_jax(served, bn):
    jout, pout = served["jax"][bn], served["port"][bn]
    assert slice_names(pout) == slice_names(jout)
    for name in slice_names(pout):
        jd = read_image(os.path.join(jout["density_dir"], name))[..., 0] / 255.0
        pd = read_image(os.path.join(pout["density_dir"], name))[..., 0] / 255.0
        assert pd.shape == (SIDE, SIDE) and pd.std() > 0.01
        np.testing.assert_allclose(pd, jd, atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("bn", MODES)
def test_eval_images_and_metrics_match_jax(served, bn):
    jout, pout = served["jax"][bn], served["port"][bn]
    near = []
    for name in slice_names(pout):
        # the densities' truncated grey levels: a threshold flip is allowed
        # where the JAX density lies within a level of the threshold
        jd = read_image(os.path.join(jout["density_dir"], name))[..., 0] / 255.0
        n = np.abs(jd - THRESH) <= 2 / 255
        je = read_image(os.path.join(jout["out_dir"], name))
        pe = read_image(os.path.join(pout["out_dir"], name))
        assert pe.shape == je.shape == (SIDE, SIDE, 3)
        assert np.array_equal(pe[~n], je[~n])
        near.append(n)
    share = np.concatenate(near).mean()
    assert pout["pixels"] == jout["pixels"] == 3 * SIDE * SIDE
    for key in ("oa", "f1"):
        assert np.isfinite(pout[key])
        assert abs(pout[key] - jout[key]) <= share + 1e-12


def test_train_mode_uses_real_slices_and_carries_the_statistics(served):
    """A replay in the port: batches [0, 1] and the 1-slice tail [2] through
    a train-mode S restored from the same file give the tool's density
    images and leave S with the tool's running buffers."""
    pdir = served["pdir"]
    dirs = whu_dirs(pdir)
    args = (dirs["img_dir_x"], dirs["img_dir_y"], dirs["ref_dir"], dirs["label_dir"])
    scaler = Normalize(*dataset_meanstd(os.path.join(dirs["img_dir_x"], "stats_meanstd.txt"),
                                        os.path.join(dirs["img_dir_y"], "stats_meanstd.txt"),
                                        WHUDataset(*args, "-1")))
    ds = WHUDataset(*args, label_selected="1", scale=scaler)
    net = load_segmentor(served["smodel"]).train()
    outs = []
    with torch.no_grad():
        for idx in ([0, 1], [2]):
            x, y = (torch.from_numpy(np.stack([ds[i][k] for i in idx])).permute(0, 3, 1, 2)
                    for k in (0, 1))
            outs.extend(net(x, y)[:, 0].numpy())
    for i, want in enumerate(outs):
        got = read_image(os.path.join(served["port"]["train"]["density_dir"],
                                      ds.get_file_name(i)))[..., 0] / 255.0
        np.testing.assert_allclose(got, want, atol=1 / 255 + 1e-6)
    tool = dict(served["net_train"].named_buffers())
    for name, buf in net.named_buffers():
        torch.testing.assert_close(tool[name], buf, rtol=0, atol=0)
    assert int(tool["inc.double_conv.1.num_batches_tracked"]) == 2


def test_meanstd_caches_are_interchangeable(served):
    jdir = os.path.dirname(served["smodel"]) + "/jax"
    for sub in ("before", "after"):
        j, p = (np.loadtxt(os.path.join(d, sub, "stats_meanstd.txt"), usecols=(1, 2, 3),
                           dtype=str).astype(float) for d in (jdir, served["pdir"]))
        np.testing.assert_allclose(p, j, rtol=1e-12)
