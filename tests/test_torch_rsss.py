"""The RSSS training slice's steps and driver: one step of each RSSS phase of
the port's RSSSSteps against the JAX package's, from the same weights and
batch (4 bands, 40 px, MS-SSIM weights (0.5, 0.5)), and the port's driver
end to end on the CPU. The data, losses and schedules are in
``test_torch_rsss_data.py``.

The JAX side of each step is the body of ``RSSSSteps.g_pretrain`` /
``adversarial`` / ``eval_confusion`` / ``eval_confusion_train`` built from
the step object's own closures (``_g_fwd``, ``_cgen_ck``, ``_cgen_ck_pre``,
``_confusion``), returning its gradients before the optimizer, as
``test_torch_wsss.py`` rebuilds the WSSS steps; the witness scheme is that
file's.

The steps run at 40 px. At 32 px (D's last BatchNorm then normalizes 2 x 2
maps) the JAX package's float32 gradient of the Discriminator on the
region-synthesized pair misses the same JAX function in float64 by up to
2.4 % of a weight's gradient norm, so no comparison with it can hold the
port there; ``test_discriminator_gradient_on_the_synthesized_pair``
holds the port's against a float64 reference at that size instead."""

import os

import numpy as np
import pytest
import torch

import torch.nn.functional as F

import jax
import jax.numpy as jnp

from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Discriminator as JaxDiscriminator
from fcdgan_tpu.models import Generator as JaxGenerator
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.models.vgg import vgg16_random_params
from fcdgan_tpu.ops import losses as jlosses
from fcdgan_tpu.train import optim as joptim
from fcdgan_tpu.train.state import create_net_state
from fcdgan_tpu.train.steps import PerceptionConfig as JaxPerception
from fcdgan_tpu.train.steps import RSSSSteps as JaxSteps
from fcdgan_tpu.train.steps import _wmean
from fcdgan_tpu_torch.io.torch_interop import from_jax_variables
from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights
from fcdgan_tpu_torch.train.optim import adam, rmsprop
from fcdgan_tpu_torch.train.steps import PerceptionConfig, RSSSSteps

HW, NB = 40, 4
MSW = (0.5, 0.5)
TAPS = (29,)  # perception_layer 1, the RSSS default (per band)
PAD = (4, 4)
LR_D = 5e-6
INTERIOR = np.array([[32, 32], [24, 20]], np.int32)  # per item: (core_h, core_w)
TEST_INTERIOR = np.array([[32, 16], [32, 32]], np.int32)
G_METRICS = ("g_loss", "generator_loss", "perception_loss", "ssim_loss")
ADV_METRICS = ("d_loss", "s_loss", "s_d_loss", "l1_loss", "r_loss", "g_loss",
               "generator_loss", "ssim_loss", "perception_loss")
WEIGHTS = dict(perception_weight=0.1, ssim_weight=0.0, g_weight=0.5, l1_weight=0.02,
               d_weight=1.0, r_weight=2.0)
# the witness of test_torch_usss.py: each input element scaled by
# (1 + WITNESS_EPS * N(0, 1)), about one float32 rounding, under two seeds
WITNESS_EPS = 1e-7
f32 = jnp.float32


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)

    def pair(change):
        x = rng.normal(size=(2, HW, HW, NB)).astype(np.float32)
        y = (x * 0.9 + 0.1 + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
        if change:
            y[:, 8:20, 10:22, :] += 2.0
        return x, y

    x, y = pair(True)
    tx, ty = pair(True)
    ref = np.ones((2, HW, HW, 1), np.float32)  # {1 unchanged, 2 changed}
    ref[:, 8:20, 10:22] = 2.0
    region = np.zeros((2, HW, HW, 1), np.float32)
    region[0, 4:24, 6:26] = 1.0  # grown around the change
    region[1, 6:22, 8:24] = 1.0
    region[1, 26:30, 2:6] = 100.0 / 255  # a raw value below 125, scaled
    return dict(x=x, y=y, ref=ref, region=region, item=np.array([0, 1]),
                w=np.ones(2, np.float32), tx=tx, ty=ty, titem=np.array([1, 0]))


@pytest.fixture(scope="module")
def jx(batch):
    """JAX steps, initial states and each phase's outputs and gradients."""
    vggp = vgg16_random_params(0)
    steps = JaxSteps(JaxGenerator(NB), JaxSegmentor(NB, bilinear=True), JaxDiscriminator(NB),
                     joptim.adam(), joptim.rmsprop(), joptim.rmsprop(), vggp,
                     JaxPerception(TAPS, per_band=True), interior_sizes=INTERIOR, pad=PAD,
                     msssim_weights=MSW, test_interior_sizes=TEST_INTERIOR, **WEIGHTS)
    k = jax.random.PRNGKey(0)
    z = jnp.zeros((2, HW, HW, NB))
    g = create_net_state(steps.G, k, (z,))
    s = create_net_state(steps.S, jax.random.fold_in(k, 1), (z, z))
    d = create_net_state(steps.D, jax.random.fold_in(k, 2), (z, z))
    pg, ps, pd = (jax.tree.map(np.asarray, t.params) for t in (g, s, d))
    gbs, sbs, dbs = g.batch_stats, s.batch_stats, d.batch_stats
    x, y, ref, region, w, tx, ty = (jnp.asarray(batch[n]) for n in
                                    ("x", "y", "ref", "region", "w", "tx", "ty"))
    item, titem = jnp.asarray(batch["item"]), jnp.asarray(batch["titem"])
    pw, sw, gw = steps.pw, steps.sw, steps.gw
    tx_d = joptim.rmsprop()

    @jax.jit
    def g_pretrain(pg):
        def loss_fn(pg_):
            y_fake, muts = steps._g_fwd(pg_, gbs, x)
            gen, ssim, perc = steps._cgen_ck_pre(y, y_fake.astype(f32), region, w)
            return gen + pw * perc + sw * ssim, (muts["batch_stats"], gen, perc, ssim)

        (loss, (bs, *terms)), grads = jax.value_and_grad(loss_fn, has_aux=True)(pg)
        return dict(zip(G_METRICS, (loss, *terms))), {"g": bs}, {"g": grads}

    @jax.jit
    def adversarial(pg, ps, pd):
        def s_fwd(ps_):
            cmap_, m = steps.S.apply({"params": ps_, "batch_stats": sbs}, x, y, train=True,
                                     mutable=["batch_stats"])
            return cmap_.astype(f32), m["batch_stats"]

        cmap, s_vjp, s_bs = jax.vjp(s_fwd, ps, has_aux=True)
        keep = 1 - jax.lax.stop_gradient(cmap)
        y_unc = y * (1 - region) + x * region

        def d_loss_fn(pd_):
            c_out, muts = steps.D.apply({"params": pd_, "batch_stats": dbs}, x * keep,
                                        y * keep, train=True, mutable=["batch_stats"])
            nc_out, muts = steps.D.apply({"params": pd_, "batch_stats": muts["batch_stats"]},
                                         x * keep, y_unc * keep, train=True,
                                         mutable=["batch_stats"])
            return 1.0 + _wmean(nc_out.astype(f32), w) - _wmean(c_out.astype(f32), w), \
                muts["batch_stats"]

        (d_loss, d_bs2), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(pd)
        pd_new, _ = joptim.apply_updates(pd, tx_d.init(pd), d_grads, tx_d, LR_D)
        y_fake = jax.lax.stop_gradient(steps.G.apply(
            {"params": pg, "batch_stats": gbs}, x, train=False).astype(f32))

        def s_loss_fn(cmap_s):
            keep_s = 1 - cmap_s
            c_out, muts = steps.D.apply({"params": pd_new, "batch_stats": d_bs2}, x * keep_s,
                                        y * keep_s, train=True, mutable=["batch_stats"])
            gen, ssim, perc = steps._cgen_ck(y, y_fake, cmap_s, w)
            g_loss = gen + pw * perc + sw * ssim
            l1_loss = jlosses.region_loss(cmap_s, region, "l1", sample_weight=w)
            r_loss = jlosses.region_loss(cmap_s, 1 - region, "mse", sample_weight=w)
            s_d_loss = _wmean(c_out.astype(f32), w)
            s_loss = (steps.dw * s_d_loss + steps.l1w * l1_loss + gw * g_loss
                      + steps.rw * r_loss)
            return s_loss, (muts["batch_stats"], s_d_loss, l1_loss, r_loss, g_loss, gen,
                            ssim, perc)

        (s_loss, (d_bs3, *terms)), g_cmap = jax.value_and_grad(s_loss_fn,
                                                               has_aux=True)(cmap)
        (s_grads,) = s_vjp(g_cmap)
        m = dict(zip(ADV_METRICS, (d_loss, s_loss, *terms)))
        m["confusion"] = steps._confusion(cmap, ref, item, w, steps.interior)
        return m, {"s": s_bs, "d": d_bs3}, {"s": s_grads, "d": d_grads}

    @jax.jit
    def eval_confusion(ps):
        cmap = steps.S.apply({"params": ps, "batch_stats": sbs}, tx, ty,
                             train=False).astype(f32)
        cm = steps._confusion(cmap, ref, titem, w, steps.test_interior)
        return {"density": cmap, "confusion": cm}, {}, {}

    @jax.jit
    def eval_confusion_train(ps):
        cmap, muts = steps.S.apply({"params": ps, "batch_stats": sbs}, tx, ty, train=True,
                                   mutable=["batch_stats"])
        cmap = cmap.astype(f32)
        cm = steps._confusion(cmap, ref, titem, w, steps.test_interior)
        return {"density": cmap, "confusion": cm}, {"s": muts["batch_stats"]}, {}

    out = {"g_pretrain": g_pretrain(pg), "adversarial": adversarial(pg, ps, pd),
           "eval_confusion": eval_confusion(ps),
           "eval_confusion_train": eval_confusion_train(ps)}
    return dict(vggp=vggp, g={"params": pg, "batch_stats": gbs},
                s={"params": ps, "batch_stats": sbs}, d={"params": pd, "batch_stats": dbs},
                out=out)


KINDS = {"g": "generator", "s": "segmentor", "d": "discriminator"}


def _port(jx):
    nets = {"g": Generator(NB), "s": Segmentor(NB), "d": Discriminator(NB)}
    for name, net in nets.items():
        net.load_state_dict(from_jax_variables(jx[name], KINDS[name]), strict=True)
    g, s, d = nets["g"], nets["s"], nets["d"]
    steps = RSSSSteps(g, s, d, adam(g.parameters()), rmsprop(s.parameters()),
                      rmsprop(d.parameters()), VGG16Weights(jx["vggp"], "cpu"),
                      PerceptionConfig(TAPS, True), interior_sizes=INTERIOR, pad=PAD,
                      msssim_weights=MSW, test_interior_sizes=TEST_INTERIOR, **WEIGHTS)
    return steps, nets


def _d64(p, x, y, stats):
    """The reference Discriminator (Module.py:192-223) in float64 on NHWC
    pairs, from the port's state_dict entries ``p``: train-mode BN with the
    biased batch variance, its running statistics updated in ``stats``."""
    h = torch.cat([x, y]).permute(0, 3, 1, 2)
    for conv, bn in ((0, None), (2, 3), (5, 6), (8, 9)):
        h = F.conv2d(h, p[f"net.{conv}.weight"], p[f"net.{conv}.bias"], stride=2, padding=1)
        if bn is not None:
            mean, var = h.mean(dim=(0, 2, 3)), h.var(dim=(0, 2, 3), unbiased=False)
            for k, v in (("running_mean", mean), ("running_var", var)):
                stats[f"net.{bn}.{k}"] = 0.9 * stats[f"net.{bn}.{k}"] + 0.1 * v.detach()
            h = ((h - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + 1e-5).view(1, -1, 1, 1)
                 * p[f"net.{bn}.weight"].view(1, -1, 1, 1) + p[f"net.{bn}.bias"].view(1, -1, 1, 1))
        h = F.leaky_relu(h, 0.2)
    n = x.shape[0]
    d = (h[:n] - h[n:]).mean(dim=(2, 3), keepdim=True)
    d = F.leaky_relu(F.conv2d(d, p["classifier.1.weight"], p["classifier.1.bias"]), 0.2)
    return torch.sigmoid(F.conv2d(d, p["classifier.3.weight"], p["classifier.3.bias"]).reshape(n))


def _step(jx, phase, batch, eps=0.0, seed=0):
    """One port step of ``phase`` from the JAX weights: its outputs, nets and
    gradients. With ``eps`` the batch's images are scaled per element by
    (1 + eps * N(0, 1)) drawn from ``seed``."""
    steps, nets = _port(jx)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if eps:
        gen = torch.Generator().manual_seed(seed)
        for k in ("x", "y", "tx", "ty"):
            t[k] = t[k] * (1 + eps * torch.randn(t[k].shape, generator=gen))
    if phase == "g_pretrain":
        m = steps.g_pretrain(t["x"], t["y"], t["region"], t["w"], 1e-4)
    elif phase == "adversarial":
        m = steps.adversarial(t["x"], t["y"], t["ref"], t["region"], t["item"], t["w"],
                              1e-4, LR_D)
    else:
        cm, density = getattr(steps, phase)(t["tx"], t["ty"], t["ref"], t["titem"], t["w"])
        m = {"density": density, "confusion": cm}
    grads = {n: {k: p.grad.numpy().copy() for k, p in net.named_parameters()
                 if p.grad is not None} for n, net in nets.items()}
    return m, nets, grads


@pytest.mark.parametrize("phase", ["g_pretrain", "adversarial", "eval_confusion",
                                   "eval_confusion_train"])
def test_step_matches_jax(phase, jx, batch):
    m, nets, grads = _step(jx, phase, batch)
    want_m, want_stats, want_grads = jx["out"][phase]

    assert set(m) == set(want_m)
    for k, v in want_m.items():
        if k == "density":
            assert m[k].shape == (2, HW, HW, 1)
            np.testing.assert_allclose(m[k].numpy(), np.asarray(v), atol=1e-4)
        elif k == "confusion":
            cm, want_cm = m[k].numpy(), np.asarray(v)
            sizes = TEST_INTERIOR if phase.startswith("eval") else INTERIOR
            assert cm.sum() == want_cm.sum() == sizes.prod(axis=1).sum()
            # thresholds at 0.5 may flip for a density within float noise of it
            np.testing.assert_allclose(cm, want_cm, atol=0.005 * cm.sum())
        else:
            np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, err_msg=k)

    witness = []

    def within_witness(net_name, name, got, want, part):
        """The tensor lies no farther from JAX, in norm, than twice as far as
        the port's own result moves when the batch is perturbed by about one
        float32 rounding (two seeds)."""
        if not witness:
            for seed in (0, 1):
                _, wnets, wgrads = _step(jx, phase, batch, WITNESS_EPS, seed)
                witness.append({"grads": wgrads, "stats": {
                    n: {k: v.numpy().copy() for k, v in net.state_dict().items()}
                    for n, net in wnets.items()}})
        self_gap = max(np.linalg.norm(got - wt[part][net_name][name]) for wt in witness)
        gap = np.linalg.norm(got - want)
        assert gap <= 2 * self_gap, (net_name, name, gap, self_gap)

    # BN running stats after the step: atol 1e-5, else the witness; the nets
    # a phase does not run in train mode keep theirs exactly
    for net_name, net in nets.items():
        bs = want_stats.get(net_name, jx[net_name]["batch_stats"])
        want_sd = variables_to_torch(jx[net_name]["params"], bs, kind=KINDS[net_name])
        sd = net.state_dict()
        for k, v in want_sd.items():
            if not k.endswith(("running_mean", "running_var")):
                continue
            got = sd[k].numpy()
            if net_name not in want_stats:
                np.testing.assert_array_equal(got, v, err_msg=k)
            elif not np.allclose(got, v, rtol=0, atol=1e-5):
                within_witness(net_name, k, got, v, "stats")

    # gradients: per element at rtol 2e-3 / atol 2e-5, else the witness
    for net_name, net in nets.items():
        if net_name not in want_grads:  # a net the phase does not step
            assert all(p.grad is None for p in net.parameters()), net_name
            continue
        bs = jx[net_name]["batch_stats"]
        want_sd = variables_to_torch(want_grads[net_name], bs, kind=KINDS[net_name])
        for name, p in net.named_parameters():
            want = want_sd[name]
            if p.grad is None:  # a conv bias folded into its BN
                np.testing.assert_array_equal(want, 0.0, err_msg=name)
                continue
            got = grads[net_name][name]
            if not np.allclose(got, want, rtol=2e-3, atol=2e-5):
                within_witness(net_name, name, got, want, "grads")


def test_discriminator_gradient_on_the_synthesized_pair():
    """At 32 px, the size at which the JAX package's float32 D gradient
    missed its own float64 (module docstring), D's gradient of the D
    update's loss on a masked pair and the masked region-synthesized pair:
    the port's float32 within 1e-4 of each weight's gradient norm of a
    float64 reference (``_d64``)."""
    rng = np.random.default_rng(2)
    hw = 32
    x = rng.normal(size=(2, hw, hw, NB)).astype(np.float32)
    y = (x * 0.9 + 0.1 + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
    y[:, 8:20, 10:22] += 2.0
    region = np.zeros((2, hw, hw, 1), np.float32)
    region[0, 4:24, 6:26] = 1.0
    region[1, 6:22, 8:24] = 1.0
    keep = rng.uniform(0.27, 0.73, size=region.shape).astype(np.float32)
    y_unc = y * (1 - region) + x * region
    torch.manual_seed(0)
    net = Discriminator(NB).train()
    xt, yt, ut, kt = (torch.from_numpy(a) for a in (x, y, y_unc, keep))
    loss = 1 + net(*(t.permute(0, 3, 1, 2) for t in (xt * kt, ut * kt))).mean() \
        - net(*(t.permute(0, 3, 1, 2) for t in (xt * kt, yt * kt))).mean()
    params = dict(net.named_parameters())
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                               allow_unused=True)))
    sd = {k: v.double().requires_grad_() for k, v in net.state_dict().items()}
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    x64, y64, u64, k64 = (t.double() for t in (xt, yt, ut, kt))
    loss64 = 1 + _d64(sd, x64 * k64, u64 * k64, stats).mean() \
        - _d64(sd, x64 * k64, y64 * k64, stats).mean()
    want = dict(zip(params, torch.autograd.grad(loss64, [sd[k] for k in params])))
    for name in params:
        if got[name] is None:  # a conv bias folded into its BN: no gradient
            assert want[name].abs().max().item() <= 1e-9, name
            continue
        gap = (got[name].double() - want[name]).norm().item()
        assert gap <= 1e-4 * want[name].norm().item() + 1e-9, (name, gap)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _demo_argv(root, ext, bn="train"):
    return ["--img-dir", root, "--out-g-model-dir", os.path.join(root, "GModel"),
            "--device", "cpu", "--msssim-weights", "0.5,0.5", "--patch-size", "32,32",
            "--overlap-padding", "4,4", "--init-batch-size", "4", "--batch-size", "3",
            "--init-num-epochs-g", "1", "--num-epochs", "1", "--test-eval-bn", bn,
            "--log-tensorboard", "false", "--progress", "false", "--ext", ext]


def test_demo_rsss_end_to_end_on_cpu(tmp_path):
    """Two runs of the port's driver on a tiny synthetic OSCD layout (48 px,
    4 bands, uint16): every artifact, rasters of the test scene's size, and
    checkpoints that load strictly; the second run reuses the first one's
    GModel.pkl, skips the G pretrain and evaluates in eval mode."""
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.data.synthetic import make_oscd_dataset
    from fcdgan_tpu_torch.demos import demo_rsss

    root = str(tmp_path)
    make_oscd_dataset(root, xsize=48, ysize=48, seed=1, dtype=np.uint16,
                      rects=((5, 6, 10, 8), (28, 26, 10, 12)))
    first = demo_rsss.main(_demo_argv(root, "_a"))
    second = demo_rsss.main(_demo_argv(root, "_b", bn="eval"))
    assert first["g_pretrain_epochs"] == 1 and len(first["epoch_seconds"]["g"]) == 1
    assert second["g_pretrain_epochs"] == 0 and second["epoch_seconds"]["g"] == []
    for out, ext in ((first, "_a"), (second, "_b")):
        assert out["out_dir"] == os.path.join(root, "model" + ext)
        assert (out["tiles"], out["test_tiles"]) == (2 * 4, 4)
        d = os.path.join(root, "gamma", "ImagePair")
        density = open_raster(os.path.join(d, "density" + ext)).read_block()
        color = open_raster(os.path.join(d, "color" + ext)).read_block()
        assert density.shape == color.shape == (48, 48, 1)
        assert density.min() >= 0 and density.max() <= 1
        assert set(np.unique(color).tolist()) <= {0.0, 1.0, 2.0, 3.0}
        for ev in (out["evaluator"], out["test_evaluator"]):
            assert ev.confusion_matrix.sum() == 48 * 48
            assert np.isfinite(ev.Pixel_Accuracy())
        assert "Segmentation, Overall Accuracy" in open(out["para_path"]).read()
        for phase in ("adv", "test"):
            for m in out["epoch_metrics"][phase]:
                assert all(np.isfinite(v) for k, v in m.items() if k != "f1")
        for key, cls in (("smodel_path", Segmentor), ("gmodel_path", Generator),
                         ("dmodel_path", Discriminator)):
            cls(NB).load_state_dict(torch.load(out[key], weights_only=True), strict=True)
    assert os.path.basename(first["gmodel_path"]) == "GModel.pkl"
