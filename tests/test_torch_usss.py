"""The USSS training slice as a whole: one step of each phase of the port's
USSSSteps against the JAX package's, from the same weights and batch, and
the port's driver end to end on the CPU.

The JAX side of each step is the body of ``USSSSteps.g_pretrain`` /
``s_init`` / ``joint`` built from the step object's own forward and loss
closures (``_g_fwd``, ``_s_fwd``, ``_cnet_ck``, ``_cnet_ck_pre``,
``_confusion``), returning its gradients before the optimizer, which the
jitted step keeps to itself. The optimizer is compared on its own, on
identical gradients."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Generator as JaxGenerator
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.models.vgg import vgg16_random_params
from fcdgan_tpu.train import optim as joptim
from fcdgan_tpu.train.state import create_net_state
from fcdgan_tpu.train.steps import PerceptionConfig as JaxPerception
from fcdgan_tpu.train.steps import USSSSteps as JaxSteps
from fcdgan_tpu_torch.io.torch_interop import from_jax_variables
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights
from fcdgan_tpu_torch.train.optim import adam, set_lr
from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

HW = 32
MSW = (0.5, 0.5)
PAD = (4, 4)
INTERIOR = np.array([[HW - 8, HW - 8]] * 4, np.int32)
METRICS = ("NetLoss", "generator_loss", "l1_loss", "perception_loss", "ssim_loss")
# the witness: each input element scaled by (1 + WITNESS_EPS * N(0, 1)), about
# one float32 rounding of the batch, under two seeds
WITNESS_EPS = 1e-7
f32 = jnp.float32


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    y = (x * 0.9 + 0.1 + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
    y[:, 10:20, 10:20, :] += 2.0  # a change square
    ref = np.ones((2, HW, HW, 1), np.float32)
    ref[:, 10:20, 10:20, :] = 2.0
    return dict(x=x, y=y, ref=ref, item=np.array([0, 3], np.int32),
                w=np.ones(2, np.float32))


# the perception taps: relu1_2, the tap of the JAX package's own step tests
# (tests/test_steps.py::_tiny_usss), and relu5_3, the USSS default
@pytest.fixture(scope="module", params=[(3,), (29,)], ids=["relu1_2", "relu5_3"])
def jx(request, batch):
    """JAX steps, initial states and each phase's outputs and gradients."""
    taps = request.param
    vggp = vgg16_random_params(0)
    steps = JaxSteps(JaxGenerator(3), JaxSegmentor(3, bilinear=True), joptim.adam(),
                     joptim.adam(), vggp, JaxPerception(taps, per_band=True),
                     perception_weight=0.4, l1_weight=0.65, ssim_weight=0.0,
                     interior_sizes=INTERIOR, pad=PAD, msssim_weights=MSW)
    k = jax.random.PRNGKey(0)
    z = jnp.zeros((2, HW, HW, 3))
    g = create_net_state(steps.G, k, (z,))
    s = create_net_state(steps.S, jax.random.fold_in(k, 1), (z, z))
    pg, ps = jax.tree.map(np.asarray, g.params), jax.tree.map(np.asarray, s.params)
    gbs, sbs = g.batch_stats, s.batch_stats
    x, y, ref = (jnp.asarray(batch[n]) for n in ("x", "y", "ref"))
    item, w = jnp.asarray(batch["item"]), jnp.asarray(batch["w"])
    pw, l1w, sw = steps.pw, steps.l1w, steps.sw

    @jax.jit
    def g_pretrain(pg):
        cmap = jnp.zeros(x.shape[:3] + (1,), x.dtype)

        def loss_fn(pg_):
            y_fake, muts = steps._g_fwd(pg_, gbs, x)
            gen, l1, perc, ssim = steps._cnet_ck_pre(y, y_fake.astype(f32), cmap, w)
            return gen + pw * perc + sw * ssim, (muts["batch_stats"], gen, l1, perc, ssim)

        (loss, (bs, *terms)), grads = jax.value_and_grad(loss_fn, has_aux=True)(pg)
        return dict(zip(METRICS, (loss, *terms))), {"g": bs}, {"g": grads}

    @jax.jit
    def s_init(pg, ps):
        y_fake, g_muts = steps.G.apply({"params": pg, "batch_stats": gbs}, x,
                                       train=True, mutable=["batch_stats"])
        y_fake = jax.lax.stop_gradient(y_fake.astype(f32))

        def loss_fn(ps_):
            cmap, muts = steps._s_fwd(ps_, sbs, x, y)
            cmap = cmap.astype(f32)
            gen, l1, perc, ssim = steps._cnet_ck(y, y_fake, cmap, w)
            loss = gen + l1w * l1 + pw * perc + sw * ssim
            return loss, (muts["batch_stats"], cmap, gen, l1, perc, ssim)

        (loss, (bs, cmap, *terms)), grads = jax.value_and_grad(loss_fn, has_aux=True)(ps)
        m = dict(zip(METRICS, (loss, *terms)), confusion=steps._confusion(cmap, ref, item, w))
        return m, {"g": g_muts["batch_stats"], "s": bs}, {"s": grads}

    @jax.jit
    def joint(pg, ps):
        def fwd(pg_, ps_):
            y_fake, g_muts = steps._g_fwd(pg_, gbs, x)
            cmap, s_muts = steps._s_fwd(ps_, sbs, x, y)
            y_fake, cmap = y_fake.astype(f32), cmap.astype(f32)
            gen, l1, perc, ssim = steps._cnet_ck(y, y_fake, cmap, w)
            a = gen + pw * perc + sw * ssim
            return (a, l1), (g_muts["batch_stats"], s_muts["batch_stats"], cmap,
                             gen, l1, perc, ssim)

        (a, l1), vjp_fn, (g_bs, s_bs, cmap, *terms) = jax.vjp(fwd, pg, ps, has_aux=True)
        d_pg, d_ps = vjp_fn((jnp.ones((), f32), jnp.full((), l1w, f32)))
        m = dict(zip(METRICS, (a + l1w * l1, *terms)),
                 confusion=steps._confusion(cmap, ref, item, w))
        return m, {"g": g_bs, "s": s_bs}, {"g": jax.tree.map(lambda t: 2.0 * t, d_pg),
                                           "s": d_ps}

    out = {"g_pretrain": g_pretrain(pg), "s_init": s_init(pg, ps), "joint": joint(pg, ps)}
    return dict(taps=taps, vggp=vggp, g={"params": pg, "batch_stats": gbs},
                s={"params": ps, "batch_stats": sbs}, out=out)


def _port(jx):
    net_g, net_s = Generator(3), Segmentor(3)
    net_g.load_state_dict(from_jax_variables(jx["g"], "generator"), strict=True)
    net_s.load_state_dict(from_jax_variables(jx["s"], "segmentor"), strict=True)
    steps = USSSSteps(net_g, net_s, adam(net_g.parameters()), adam(net_s.parameters()),
                      VGG16Weights(jx["vggp"], "cpu"), PerceptionConfig(jx["taps"], True),
                      0.4, 0.65, 0.0, INTERIOR, PAD, msssim_weights=MSW)
    return steps, {"g": net_g, "s": net_s}


def _step(jx, phase, batch, eps=0.0, seed=0):
    """One port step of ``phase`` from the JAX weights: its metrics, nets and
    gradients. With ``eps`` the batch's x and y are scaled per element by
    (1 + eps * N(0, 1)) drawn from ``seed``."""
    steps, nets = _port(jx)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    t["item"] = t["item"].long()
    if eps:
        gen = torch.Generator().manual_seed(seed)
        for k in ("x", "y"):
            t[k] = t[k] * (1 + eps * torch.randn(t[k].shape, generator=gen))
    if phase == "g_pretrain":
        m = steps.g_pretrain(t["x"], t["y"], t["w"], 1e-4)
    elif phase == "s_init":
        m = steps.s_init(t["x"], t["y"], t["ref"], t["item"], t["w"], 1e-4)
    else:
        m = steps.joint(t["x"], t["y"], t["ref"], t["item"], t["w"], 1e-4, 1e-4)
    grads = {n: {k: p.grad.numpy().copy() for k, p in net.named_parameters()
                 if p.grad is not None} for n, net in nets.items()}
    return m, nets, grads


@pytest.mark.parametrize("phase", ["g_pretrain", "s_init", "joint"])
def test_step_matches_jax(phase, jx, batch):
    m, nets, grads = _step(jx, phase, batch)
    want_m, want_stats, want_grads = jx["out"][phase]

    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(want_m[k]), rtol=1e-4, err_msg=k)
    if "confusion" in want_m:
        cm, want_cm = m["confusion"].numpy(), np.asarray(want_m["confusion"])
        assert cm.sum() == want_cm.sum() == 2 * (HW - 8) ** 2  # interiors only
        # thresholds at 0.5 may flip for a density within float noise of it
        np.testing.assert_allclose(cm, want_cm, atol=0.005 * cm.sum())

    for net_name, bs in want_stats.items():  # BN running stats after the step
        jvars = jx[net_name]
        want_sd = variables_to_torch(jvars["params"], bs, kind=_kind(net_name))
        sd = nets[net_name].state_dict()
        for k, v in want_sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), v, atol=1e-5, err_msg=k)

    # Gradients: per element at rtol 2e-3 / atol 2e-5 (tests/test_steps.py:180).
    # A tensor outside that must lie no farther from JAX, in norm, than twice
    # as far as the port's own gradient moves when the batch is perturbed by
    # about one float32 rounding (two seeds). At 32 px and batch 2 the S
    # gradients, and at relu5_3 the G pretrain gradients, are that
    # ill-conditioned (train-mode BN over 16 samples at the deepest level,
    # ReLU and pool routing near ties): such a rounding moves them by up to
    # about 1 % in norm. A wrong term or a missing factor 2 on G stays far
    # outside both.
    witness = None
    for net_name, net in nets.items():
        if net_name not in want_grads:  # a net the phase does not step
            assert all(p.grad is None for p in net.parameters())
            continue
        bs = jx[net_name]["batch_stats"]
        want_sd = variables_to_torch(want_grads[net_name], bs, kind=_kind(net_name))
        for name, p in net.named_parameters():
            want = want_sd[name]
            if p.grad is None:  # a conv bias folded into its BN
                np.testing.assert_array_equal(want, 0.0, err_msg=name)
                continue
            got = grads[net_name][name]
            if np.allclose(got, want, rtol=2e-3, atol=2e-5):
                continue
            if witness is None:
                witness = [_step(jx, phase, batch, WITNESS_EPS, seed)[2] for seed in (0, 1)]
            self_gap = max(np.linalg.norm(got - w[net_name][name]) for w in witness)
            gap = np.linalg.norm(got - want)
            assert gap <= 2 * self_gap, (net_name, name, gap, self_gap)


def _kind(net_name):
    return "generator" if net_name == "g" else "segmentor"


def test_adam_update_matches_jax_apply_updates():
    """Two Adam steps on identical gradients from zero parameters, so the
    parameters after each step are the updates themselves."""
    rng = np.random.default_rng(4)
    shapes = [(64, 3, 9, 9), (64,), (1,)]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    opt = adam(params)
    jparams = [jnp.zeros(s) for s in shapes]
    tx = joptim.adam()
    state = tx.init(jparams)
    # step 1 at rtol 1e-6; step 2 at the JAX package's own torch-golden Adam
    # tolerance (tests/test_torch_parity.py:402): optax forms the bias
    # correction 1 - 0.99**2 in float32, which cancellation leaves 1.8e-6
    # off, while torch forms it in float64
    for lr, rtol in ((3e-4, 1e-6), (1e-4, 1e-5)):
        grads = [rng.normal(scale=1e-3, size=s).astype(np.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        set_lr(opt, lr)
        opt.step()
        jparams, state = joptim.apply_updates(jparams, state,
                                              [jnp.asarray(g) for g in grads], tx, lr)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=rtol)
    assert opt.defaults["betas"] == (0.9, 0.99) and opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("n,bs,seed", [(36, 10, 0), (7, 4, 3), (5, 8, 1)])
def test_batch_order_matches_jax(n, bs, seed):
    """Three shuffled epochs of (item, weight) batches, the last one short,
    as the JAX package's ``IndexBatchLoader(tail='short')`` gives them."""
    from fcdgan_tpu.data.device_cache import IndexBatchLoader as JaxLoader
    from fcdgan_tpu_torch.data.device_cache import IndexBatchLoader

    port = IndexBatchLoader(n, bs, shuffle=True, seed=seed)
    ref = JaxLoader(list(range(n)), bs, shuffle=True, seed=seed, tail="short")
    for _ in range(3):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == -(-n // bs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["item"], b["item"])
            np.testing.assert_array_equal(a["weight"], b["weight"])


def test_demo_usss_end_to_end_on_cpu(tmp_path):
    """The port's driver on a tiny synthetic scene: every phase, every
    artifact, and a Segmentor checkpoint that the serving loader reads."""
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene
    from fcdgan_tpu_torch.demos import demo_usss
    from fcdgan_tpu_torch.io.checkpoint import load_segmentor

    make_usss_scene(str(tmp_path), 64, 64, 3, rects=((10, 12, 14, 12),), seed=2)
    out = demo_usss.main([
        "--dir", str(tmp_path), "--device", "cpu", "--patch-size", "48,48",
        "--overlap-padding", "4,4", "--msssim-weights", "0.5,0.5", "--batch-size", "4",
        "--init-num-epochs-g", "1", "--init-num-epochs-s", "1", "--num-epochs", "1",
        "--log-tensorboard", "false", "--progress", "false", "--ext", "_t"])
    for key in ("density_path", "color_path", "para_path", "smodel_path", "gmodel_path"):
        assert os.path.isfile(out[key]), key
    assert os.path.basename(out["smodel_path"]) == "SModel_t.pkl"
    density = open_raster(out["density_path"]).read_block()[..., 0]
    assert density.shape == (64, 64) and np.isfinite(density).all()
    assert density.min() >= 0 and density.max() <= 1
    codes = open_raster(out["color_path"]).read_block()[..., 0]
    assert set(np.unique(codes)) <= {0, 1, 2, 3}
    ev = out["evaluator"]
    assert ev.confusion_matrix.sum() == 64 * 64
    assert np.isfinite(ev.Pixel_Accuracy()) and np.isfinite(out["auc"])
    assert "Segmentation, Overall Accuracy" in open(out["para_path"]).read()
    net = load_segmentor(out["smodel_path"])
    assert not net.training
    Generator(3).load_state_dict(torch.load(out["gmodel_path"], weights_only=True),
                                 strict=True)
    assert all(len(v) == 1 for k, v in out["epoch_seconds"].items() if k != "infer")


@pytest.mark.parametrize("flag", [["--siamese-stats", "split"], ["--remat", "true"],
                                  ["--tail", "pad"], ["--n-devices", "2"],
                                  ["--checkpoint-every", "5"], ["--resume", "true"],
                                  ["--density-dtype", "uint8"], ["--profile-dir", "p"],
                                  ["--debug-nans", "true"]])
def test_unported_options_raise(flag, tmp_path):
    from fcdgan_tpu_torch.demos import demo_usss

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        demo_usss.main(["--dir", str(tmp_path), "--device", "cpu", *flag])
