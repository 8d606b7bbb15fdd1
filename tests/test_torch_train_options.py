"""The drivers' remaining training options against the JAX package and
through the drivers on the CPU: ``--tail pad`` (the resident loaders'
batches and a padded-tail step against JAX), ``--checkpoint-every`` /
``--resume`` (``TrainCheckpointer``'s cadence and start epochs against the
JAX one's; a driver resume that skips the completed epochs and restores
every state bit for bit), a quantized ``--density-dtype`` (the densities of
a run are the serving tool's quantization of its float32 ones, exactly),
``--profile-dir`` (a trace file) and ``--debug-nans`` (an injected NaN
raises, naming the phase and the epoch).

The padded-tail step is a USSS G-pretrain step on a batch of 3 whose third
item repeats the first with weight 0: losses rtol 1e-4, running statistics
atol 1e-5, gradients rtol 2e-3 / atol 2e-5, else the witness of
``test_torch_usss.py`` (the tolerances of that file)."""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.io.checkpoint import TrainCheckpointer as JaxCheckpointer
from fcdgan_tpu.models import Generator as JaxGenerator
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.models.vgg import vgg16_random_params
from fcdgan_tpu.train import optim as joptim
from fcdgan_tpu.train import steps as jsteps
from fcdgan_tpu_torch.io.checkpoint import TrainCheckpointer
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights
from fcdgan_tpu_torch.train.optim import adam
from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

from test_torch_siamese_split import _init, _perturbed, check, grads_of, jax_sd, stats_of
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIDE = 48
MSW = (0.5, 0.5)


def _usss_argv(root, *flags, epochs=(0, 0, 0), batch=4):
    g, s, j = epochs
    return ["--dir", str(root), "--device", "cpu", "--patch-size", "32,32",
            "--overlap-padding", "4,4", "--msssim-weights", "0.5,0.5", "--batch-size",
            str(batch), "--init-num-epochs-g", str(g), "--init-num-epochs-s", str(s),
            "--num-epochs", str(j), "--log-tensorboard", "false", "--progress", "false",
            "--save-checkpoints", "false", *flags]


@pytest.fixture
def scene(tmp_path):
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene

    make_usss_scene(str(tmp_path), SIDE, SIDE, 3, rects=((10, 12, 14, 12),), seed=2)
    return tmp_path


# ---------------------------------------------------------------------------
# --tail pad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,bs,seed", [(7, 3, 0), (4, 3, 2), (2, 5, 1)])
def test_padded_tail_batches_match_jax(n, bs, seed):
    """Three epochs of the resident loaders' (item, weight) batches with
    ``tail='pad'``, as the JAX package's ``IndexBatchLoader`` gives them."""
    from fcdgan_tpu.data.device_cache import IndexBatchLoader as JaxLoader
    from fcdgan_tpu_torch.data.device_cache import IndexBatchLoader

    port = IndexBatchLoader(n, bs, shuffle=True, seed=seed, tail="pad")
    ref = JaxLoader(list(range(n)), bs, shuffle=True, seed=seed, tail="pad")
    for _ in range(3):
        got, want = list(port), list(ref)
        assert len(got) == len(want) and all(len(b["item"]) == bs for b in got)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["item"], b["item"])
            np.testing.assert_array_equal(a["weight"], b["weight"])


def test_padded_tail_step_matches_jax():
    """A G-pretrain step on a padded tail: the weight-0 duplicate enters
    G's batch statistics and leaves the losses, in both packages."""
    vggp = vgg16_random_params(0)
    steps = jsteps.USSSSteps(
        JaxGenerator(3), JaxSegmentor(3, bilinear=True), joptim.adam(), joptim.adam(), vggp,
        jsteps.PerceptionConfig((3,), per_band=True), perception_weight=0.4,
        l1_weight=0.65, ssim_weight=0.0, interior_sizes=np.array([[24, 24]] * 3),
        pad=(4, 4), msssim_weights=MSW)
    init = _init(steps, 32, 3)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    y = (x * 0.9 + rng.normal(scale=0.1, size=x.shape)).astype(np.float32)
    x[2], y[2] = x[0], y[0]  # the wrap-padded duplicate
    w = np.array([1.0, 1.0, 0.0], np.float32)
    gbs = init["g"]["batch_stats"]

    @jax.jit
    def g_pretrain(pg):
        cmap = jnp.zeros(x.shape[:3] + (1,))

        def loss_fn(pg_):
            y_fake, muts = steps._g_fwd(pg_, gbs, jnp.asarray(x))
            gen, _, perc, ssim = steps._cnet_ck_pre(jnp.asarray(y), y_fake.astype(jnp.float32),
                                                    cmap, jnp.asarray(w))
            return gen + steps.pw * perc + steps.sw * ssim, muts["batch_stats"]

        return jax.value_and_grad(loss_fn, has_aux=True)(pg)

    (want_loss, want_bs), want_g = g_pretrain(init["g"]["params"])

    def port(b):
        from fcdgan_tpu_torch.io.torch_interop import from_jax_variables

        g, s = Generator(3), Segmentor(3)
        g.load_state_dict(from_jax_variables(init["g"], "generator"), strict=True)
        st = USSSSteps(g, s, adam(g.parameters()), adam(s.parameters()),
                       VGG16Weights(vggp, "cpu"), PerceptionConfig((3,), True), 0.4, 0.65,
                       0.0, np.array([[24, 24]] * 3), (4, 4), msssim_weights=MSW)
        m = st.g_pretrain(torch.from_numpy(b["x"]), torch.from_numpy(b["y"]),
                          torch.from_numpy(w), 1e-4)
        return m, g

    m, g = port({"x": x, "y": y})
    np.testing.assert_allclose(float(m["NetLoss"]), float(want_loss), rtol=1e-4)

    def rerun(seed):
        b = _perturbed({"x": x, "y": y}, seed)
        b["x"][2], b["y"][2] = b["x"][0], b["y"][0]
        return port(b)[1]

    want = {k: v for k, v in jax_sd(init["g"]["params"], want_bs, "generator").items()
            if k.endswith(("running_mean", "running_var"))}
    check(stats_of(g), want, lambda seed: stats_of(rerun(seed)), 0, 1e-5)
    want = jax_sd(want_g, gbs, "generator")
    got = grads_of(g)
    check(got, {k: want[k] for k in got}, lambda seed: grads_of(rerun(seed)), 2e-3, 2e-5)


# ---------------------------------------------------------------------------
# --checkpoint-every / --resume
# ---------------------------------------------------------------------------


def test_checkpointer_cadence_and_starts_match_jax(tmp_path):
    for every in (0, 1, 2, 3, 5):
        port, ref = TrainCheckpointer(str(tmp_path), every), JaxCheckpointer(str(tmp_path), every)
        assert port.enabled == ref.enabled
        assert [port.due(e) for e in range(12)] == [ref.due(e) for e in range(12)]
    for order in (("g", "s", "joint"), ("g", "adv")):
        assert TrainCheckpointer.start_epochs(None, order) == \
            JaxCheckpointer.start_epochs(None, order)
        for phase in order:
            for epoch in (0, 1, 4, 49):
                meta = {"phase": phase, "epoch": epoch}
                assert TrainCheckpointer.start_epochs(meta, order) == \
                    JaxCheckpointer.start_epochs(meta, order)


def test_checkpointer_writes_on_its_cadence(tmp_path):
    net = torch.nn.Linear(3, 2)
    opt = adam(net.parameters())
    ck = TrainCheckpointer(str(tmp_path / "r"), every=2)
    saved = [ck.maybe_save("s", e, netS=(net, opt)) for e in range(5)]
    assert saved == [False, True, False, True, False]
    assert json.loads((tmp_path / "r" / "meta.json").read_text()) == {"phase": "s", "epoch": 3}
    assert sorted(os.listdir(tmp_path / "r")) == ["meta.json", "netS.pt"]
    assert not TrainCheckpointer(str(tmp_path / "r"), 0).maybe_save("s", 1, netS=(net, opt))


def _same_optimizer_state(a, b):
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for k, st in a["state"].items():
        for name, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(b["state"][k][name])), name


def test_driver_resume_skips_completed_epochs_and_restores_states(scene, monkeypatch):
    """A run stopped after the S-init phase (checkpoints every epoch), then
    resumed with one more S-init epoch and a joint epoch: the G pretrain and
    the saved S-init epoch are skipped, and the restored parameters, BN
    buffers and Adam states equal the saved files bit for bit."""
    from fcdgan_tpu_torch.demos import demo_usss

    first = demo_usss.main(_usss_argv(scene, "--checkpoint-every", "1", "--ext", "_r",
                                      epochs=(1, 1, 0)))
    assert [len(first["epoch_seconds"][p]) for p in ("g", "s", "joint")] == [1, 1, 0]
    resume = scene / "resume_r.ckpt"
    assert json.loads((resume / "meta.json").read_text()) == {"phase": "s", "epoch": 0}
    saved = {n: torch.load(resume / f"{n}.pt", weights_only=True) for n in ("netG", "netS")}
    restored = {}
    orig = TrainCheckpointer.restore

    def capture(self, nets):
        meta = orig(self, nets)
        for name, (module, opt) in nets.items():
            restored[name] = copy.deepcopy((module.state_dict(), opt.state_dict()))
        return meta

    monkeypatch.setattr(TrainCheckpointer, "restore", capture)
    second = demo_usss.main(_usss_argv(scene, "--resume", "true", "--ext", "_r",
                                       epochs=(1, 2, 1)))
    assert second["start_epochs"] == {"g": 10**9, "s": 1, "joint": 0}
    assert [len(second["epoch_seconds"][p]) for p in ("g", "s", "joint")] == [0, 1, 1]
    assert restored.keys() == saved.keys()
    for name, (sd, opt_sd) in restored.items():
        assert sd.keys() == saved[name]["state_dict"].keys()
        for k, v in sd.items():
            assert torch.equal(v, saved[name]["state_dict"][k]), (name, k)
        _same_optimizer_state(opt_sd, saved[name]["optimizer"])
    assert saved["netS"]["optimizer"]["state"]  # S-init stepped S: its moments were saved
    shutil.rmtree(resume)  # half a GB of S and its Adam moments


# ---------------------------------------------------------------------------
# --density-dtype, --profile-dir, --debug-nans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feed", ["auto", "off"], ids=["resident", "host"])
def test_quantized_densities_are_the_tools_quantization(scene, feed):
    """The final inference of an untrained run, fused (resident) or tile by
    tile (host feed), with each download format: the rasters equal
    ``utils.download``'s quantize and dequantize of the float32 density."""
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.demos import demo_usss
    from fcdgan_tpu_torch.utils.download import dequantize, quantize

    dens = {}
    for dt in ("float32", "uint8", "bfloat16"):
        out = demo_usss.main(_usss_argv(scene, "--scene-cache", feed, "--density-dtype", dt,
                                        "--device-normalize", "off", "--ext", f"_{dt}"))
        assert out["density_dtype"] == dt and out["feed"] == ("resident" if feed == "auto"
                                                              else "native")
        dens[dt] = open_raster(out["density_path"]).read_block()[..., 0]
    f32 = torch.from_numpy(dens["float32"])
    assert 0.0 < float(f32.std())
    for dt in ("uint8", "bfloat16"):
        np.testing.assert_array_equal(dens[dt], dequantize(quantize(f32, dt), dt))
        assert not np.array_equal(dens[dt], dens["float32"])


def test_rsss_quantized_density(tmp_path):
    """The RSSS driver's tile-by-tile inference with uint8 downloads."""
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.data.synthetic import make_oscd_dataset
    from fcdgan_tpu_torch.demos import demo_rsss
    from fcdgan_tpu_torch.utils.download import dequantize, quantize

    make_oscd_dataset(str(tmp_path), xsize=48, ysize=48, seed=2)
    dens = {}
    for dt in ("float32", "uint8"):
        out = demo_rsss.main([
            "--img-dir", str(tmp_path), "--out-g-model-dir", str(tmp_path / "G"),
            "--device", "cpu", "--msssim-weights", "0.5,0.5", "--patch-size", "32,32",
            "--overlap-padding", "4,4", "--batch-size", "3", "--init-num-epochs-g", "0",
            "--num-epochs", "0", "--log-tensorboard", "false", "--progress", "false",
            "--save-checkpoints", "false", "--density-dtype", dt, "--ext", f"_{dt}"])
        dens[dt] = open_raster(os.path.join(str(tmp_path), "gamma", "ImagePair",
                                            out["density_name"])).read_block()[..., 0]
    np.testing.assert_array_equal(
        dens["uint8"], dequantize(quantize(torch.from_numpy(dens["float32"]), "uint8"), "uint8"))


def test_profile_dir_writes_a_trace(scene):
    from fcdgan_tpu_torch.demos import demo_usss

    prof = scene / "prof"
    demo_usss.main(_usss_argv(scene, "--profile-dir", str(prof), epochs=(1, 0, 0)))
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_debug_nans_raises_on_an_injected_nan(scene, monkeypatch):
    """A NaN in one tile of the first batch: with ``--debug-nans`` the
    driver raises FloatingPointError naming the phase and the epoch; without
    it the run ends, its losses NaN."""
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.demos import demo_usss

    complete = DeviceSceneCache.complete

    def poisoned(self, batch):
        db = complete(self, batch)
        db["x"][0, 5, 5, 0] = float("nan")
        return db

    monkeypatch.setattr(DeviceSceneCache, "complete", poisoned)
    with pytest.raises(FloatingPointError, match="phase g, epoch 1"):
        demo_usss.main(_usss_argv(scene, "--debug-nans", "true", epochs=(1, 0, 0)))
    out = demo_usss.main(_usss_argv(scene, epochs=(1, 0, 0)))
    assert np.isnan(out["epoch_metrics"]["g"][0]["NetLoss"])


def test_nan_checked_names_a_non_finite_gradient():
    from fcdgan_tpu_torch.train.loops import nan_checked

    net = torch.nn.Linear(2, 1)

    def step():
        net.weight.grad = torch.tensor([[0.0, float("inf")]])
        return {"loss": torch.tensor(1.0)}

    with pytest.raises(FloatingPointError, match="phase adv, epoch 3: non-finite gradient"):
        nan_checked(step, "adv", 2, net)
    net.weight.grad = None
    assert nan_checked(lambda: {"loss": torch.tensor(2.0)}, "g", 0, net)["loss"] == 2.0
