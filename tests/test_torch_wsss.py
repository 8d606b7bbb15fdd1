"""The WSSS training slice as a whole: the WHU datasets, their pairing and
the device-resident batches against the JAX package's; ``cgenerator_loss``
and RMSprop; one step of each WSSS phase of the port's WSSSSteps against the
JAX package's, from the same weights and batch; and the port's driver end to
end on the CPU.

The JAX side of each step is the body of ``WSSSSteps.g_pretrain`` /
``adversarial`` / ``infer_train_mode`` built from the step object's own
closures (``_g_fwd``, ``_cgen_ck``, ``_cgen_ck_pre``, ``_mask_pair``),
returning its gradients before the optimizer, as ``test_torch_usss.py``
rebuilds the USSS steps."""

import os
import random
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.data import datasets as jds
from fcdgan_tpu.data.synthetic import make_whu_dataset as jax_make_whu_dataset
from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Discriminator as JaxDiscriminator
from fcdgan_tpu.models import Generator as JaxGenerator
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.models.vgg import vgg16_random_params
from fcdgan_tpu.ops import losses as jlosses
from fcdgan_tpu.train import optim as joptim
from fcdgan_tpu.train.state import create_net_state
from fcdgan_tpu.train.steps import PerceptionConfig as JaxPerception
from fcdgan_tpu.train.steps import WSSSSteps as JaxSteps
from fcdgan_tpu.train.steps import _wmean
from fcdgan_tpu_torch.data import datasets as pds
from fcdgan_tpu_torch.eval.inference import nhwc_infer
from fcdgan_tpu_torch.io.torch_interop import from_jax_variables
from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights
from fcdgan_tpu_torch.ops import losses as plosses
from fcdgan_tpu_torch.train.optim import adam, rmsprop, set_lr
from fcdgan_tpu_torch.train.steps import PerceptionConfig, WSSSSteps

from torch_threads import one_torch_thread  # noqa: F401

HW = 32
MSW = (0.5, 0.5)
TAPS = (29,)  # perception_layer 1, the WSSS default (RGB, not per band)
LR_D = 1e-5
G_METRICS = ("g_loss", "generator_loss", "perception_loss", "ssim_loss")
ADV_METRICS = ("d_loss", "s_loss", "s_d_loss", "l1_loss", "nc_loss", "g_loss",
               "generator_loss", "ssim_loss", "perception_loss")
WEIGHTS = dict(perception_weight=0.5, ssim_weight=0.0, g_weight=0.2, l1_weight=1.6,
               d_weight=1.0, nc_weight=1.5)
# the witness of test_torch_usss.py: each input element scaled by
# (1 + WITNESS_EPS * N(0, 1)), about one float32 rounding, under two seeds
WITNESS_EPS = 1e-7
f32 = jnp.float32


# ---------------------------------------------------------------------------
# data: datasets, pairing, device batches
# ---------------------------------------------------------------------------


def _dirs(root):
    return (os.path.join(root, "before"), os.path.join(root, "after"),
            os.path.join(root, "Label"), root)


@pytest.fixture(scope="module", params=[(3, 5), (5, 2)], ids=["c<nc", "c>nc"])
def whu(request, tmp_path_factory):
    """A WHU slice set written by the JAX package's generator (through PIL)."""
    root = str(tmp_path_factory.mktemp("whu"))
    n_c, n_nc = request.param
    jax_make_whu_dataset(root, n_changed=n_c, n_unchanged=n_nc, size=24, seed=3)
    return root


def test_whu_datasets_match_jax(whu):
    from fcdgan_tpu.data.normalize import Normalize as JaxNormalize
    from fcdgan_tpu_torch.data.normalize import Normalize

    stats = ([90.0, 100.0, 110.0], [30.0, 31.0, 32.0], [95.0, 99.0, 111.0], [29.0, 33.0, 30.0])
    for sel in ("-1", "1", "0", "-2"):
        for scale in (None, "norm"):
            p = pds.WHUDataset(*_dirs(whu), sel, scale=Normalize(*stats) if scale else None)
            j = jds.WHUDataset(*_dirs(whu), sel, scale=JaxNormalize(*stats) if scale else None)
            assert len(p) == len(j) and p.img_path_x == j.img_path_x
            assert p.label_list == j.label_list
            for i in range(len(p)):
                assert p.get_file_name(i) == j.get_file_name(i)
                for a, b in zip(p[i], j[i]):
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pairing_and_batches_match_jax_per_epoch(whu):
    """Three epochs of the index pair loader, each re-paired by its epoch
    hook before the shuffle, as the JAX package's loader gives them."""
    from fcdgan_tpu.data.device_cache import IndexPairBatchLoader as JaxLoader
    from fcdgan_tpu_torch.data.device_cache import IndexPairBatchLoader

    p = pds.WHUPairDataset(*_dirs(whu), rng=random.Random(7))
    j = jds.WHUPairDataset(*_dirs(whu), random_assign=False, rng=random.Random(7))
    assert (p.c_order, p.nc_order) == (j.c_order, j.nc_order)
    port = IndexPairBatchLoader(p, 3, shuffle=True, seed=7,
                                epoch_hook=lambda e: p.order_reset())
    ref = JaxLoader(j, 3, shuffle=True, seed=7, epoch_hook=lambda e: j.order_reset(),
                    tail="short")
    for _ in range(3):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == -(-len(p) // 3)
        for a, b in zip(got, want):
            for k in ("c_item", "nc_item", "weight"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (p.c_order, p.nc_order) == (j.c_order, j.nc_order)
    for i in range(len(p)):
        for a, b in zip(p[i], j[i]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_device_whu_cache_matches_jax(whu):
    from fcdgan_tpu.data.device_cache import DeviceWHUCache as JaxCache
    from fcdgan_tpu.data.normalize import Normalize as JaxNormalize
    from fcdgan_tpu_torch.data.device_cache import DeviceWHUCache
    from fcdgan_tpu_torch.data.normalize import Normalize

    stats = ([90.0, 100.0, 110.0], [30.0, 31.0, 32.0], [95.0, 99.0, 111.0], [29.0, 33.0, 30.0])
    p = pds.WHUPairDataset(*_dirs(whu), scale=Normalize(*stats), rng=random.Random(0))
    j = jds.WHUPairDataset(*_dirs(whu), scale=JaxNormalize(*stats), random_assign=False,
                           rng=random.Random(0))
    pc, jc = DeviceWHUCache(p, Normalize(*stats), "cpu"), JaxCache(j, JaxNormalize(*stats))
    pair = {"c_item": np.array([1, 0, 1]), "nc_item": np.array([1, 0, 1]),
            "weight": np.ones(3, np.float32)}
    one = {"item": np.array([1, 0]), "weight": np.ones(2, np.float32)}
    for got, want, keys in ((pc.complete_pair(pair), jc.complete_pair(pair),
                             ("c_x", "c_y", "c_ref", "nc_x", "nc_y", "weight")),
                            (pc.complete_unc(one), jc.complete_unc(one), ("x", "y", "weight")),
                            (pc.complete_c(one), jc.complete_c(one), ("x", "y", "weight"))):
        for k in keys:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    # the host dataset's normalized items, from the same stacks
    x, y, ref, _, _ = p.c_ds[1]
    batch = pc.complete_pair(pair)
    np.testing.assert_allclose(batch["c_x"][0].numpy(), x, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(batch["c_ref"][0].numpy(), ref)


def test_cache_past_its_budget_raises(whu, monkeypatch):
    from fcdgan_tpu_torch.data import device_cache
    from fcdgan_tpu_torch.data.normalize import Normalize

    p = pds.WHUPairDataset(*_dirs(whu), rng=random.Random(0))
    monkeypatch.setenv("FCDGAN_SLICE_CACHE_MAX_MB", "0.001")
    assert not device_cache.DeviceWHUCache.supports(p)
    with pytest.raises(NotImplementedError, match="host slice loaders"):
        device_cache.DeviceWHUCache(p, Normalize([0] * 3, [1] * 3, [0] * 3, [1] * 3), "cpu")


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("taps", [(3, 8), (29,)], ids=["relu1_2+relu2_2", "relu5_3"])
def test_cgenerator_loss_matches_jax(taps):
    rng = np.random.default_rng(5)
    y = rng.normal(size=(3, HW, HW, 3)).astype(np.float32)
    g = (y + rng.normal(scale=0.3, size=y.shape)).astype(np.float32)
    cmap = rng.uniform(size=(3, HW, HW, 1)).astype(np.float32)
    cmap[1] = 1.0  # a fully masked sample: skipped, still in the denominator
    w = np.array([1.0, 1.0, 0.0], np.float32)
    vggp = vgg16_random_params(0)
    want = jlosses.cgenerator_loss(jnp.asarray(y), jnp.asarray(g), jnp.asarray(cmap), vggp,
                                   taps, perception_per_band=False, msssim_weights=MSW,
                                   sample_weight=jnp.asarray(w))
    got = plosses.cgenerator_loss(torch.from_numpy(y), torch.from_numpy(g),
                                  torch.from_numpy(cmap), VGG16Weights(vggp, "cpu"), taps,
                                  perception_per_band=False, msssim_weights=MSW,
                                  sample_weight=torch.from_numpy(w))
    for a, b, name in zip(got, want, ("generator", "ssim", "perception")):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, err_msg=name)


def test_rmsprop_update_matches_jax_apply_updates():
    """Two RMSprop steps on identical gradients from zero parameters."""
    rng = np.random.default_rng(4)
    shapes = [(64, 3, 3, 3), (64,), (1,)]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    opt = rmsprop(params)
    jparams = [jnp.zeros(s) for s in shapes]
    tx = joptim.rmsprop()
    state = tx.init(jparams)
    for lr in (1e-3, 1e-5):
        grads = [rng.normal(scale=1e-3, size=s).astype(np.float32) for s in shapes]
        for p, gr in zip(params, grads):
            p.grad = torch.from_numpy(gr)
        set_lr(opt, lr)
        opt.step()
        jparams, state = joptim.apply_updates(jparams, state,
                                              [jnp.asarray(gr) for gr in grads], tx, lr)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-5)
    d = opt.defaults
    assert (d["alpha"], d["eps"], d["momentum"], d["centered"]) == (0.99, 1e-8, 0.0, False)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)

    def pair(change):
        x = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
        y = (x * 0.9 + 0.1 + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
        if change:
            y[:, 8:20, 10:22, :] += 2.0
        return x, y

    c_x, c_y = pair(True)
    nc_x, nc_y = pair(False)
    c_ref = np.zeros((2, HW, HW, 1), np.float32)
    c_ref[:, 8:20, 10:22] = 1.0
    return dict(c_x=c_x, c_y=c_y, c_ref=c_ref, nc_x=nc_x, nc_y=nc_y, w=np.ones(2, np.float32))


@pytest.fixture(scope="module")
def jx(batch):
    """JAX steps, initial states and each phase's outputs and gradients."""
    vggp = vgg16_random_params(0)
    steps = JaxSteps(JaxGenerator(3), JaxSegmentor(3, bilinear=True), JaxDiscriminator(3),
                     joptim.adam(), joptim.rmsprop(), joptim.rmsprop(), vggp,
                     JaxPerception(TAPS, per_band=False), prob_thresh=0.6,
                     msssim_weights=MSW, **WEIGHTS)
    k = jax.random.PRNGKey(0)
    z = jnp.zeros((2, HW, HW, 3))
    g = create_net_state(steps.G, k, (z,))
    s = create_net_state(steps.S, jax.random.fold_in(k, 1), (z, z))
    d = create_net_state(steps.D, jax.random.fold_in(k, 2), (z, z))
    pg, ps, pd = (jax.tree.map(np.asarray, t.params) for t in (g, s, d))
    gbs, sbs, dbs = g.batch_stats, s.batch_stats, d.batch_stats
    c_x, c_y, c_ref, nc_x, nc_y, w = (jnp.asarray(batch[n]) for n in
                                      ("c_x", "c_y", "c_ref", "nc_x", "nc_y", "w"))
    pw, sw, gw = steps.pw, steps.sw, steps.gw
    tx_d = joptim.rmsprop()

    @jax.jit
    def g_pretrain(pg):
        cmap = jnp.zeros(nc_x.shape[:3] + (1,), nc_x.dtype)

        def loss_fn(pg_):
            y_fake, muts = steps._g_fwd(pg_, gbs, nc_x)
            gen, ssim, perc = steps._cgen_ck_pre(nc_y, y_fake.astype(f32), cmap, w)
            return gen + pw * perc + sw * ssim, (muts["batch_stats"], gen, perc, ssim)

        (loss, (bs, *terms)), grads = jax.value_and_grad(loss_fn, has_aux=True)(pg)
        return dict(zip(G_METRICS, (loss, *terms))), {"g": bs}, {"g": grads}

    @jax.jit
    def adversarial(pg, ps, pd):
        def s_fwd(ps_):
            cmap_, m1 = steps.S.apply({"params": ps_, "batch_stats": sbs}, c_x, c_y,
                                      train=True, mutable=["batch_stats"])
            ncmap_, m2 = steps.S.apply({"params": ps_, "batch_stats": m1["batch_stats"]},
                                       nc_x, nc_y, train=True, mutable=["batch_stats"])
            return (cmap_.astype(f32), ncmap_.astype(f32)), (m1["batch_stats"],
                                                             m2["batch_stats"])

        (cmap, ncmap), s_vjp, (s_bs1, s_bs2) = jax.vjp(s_fwd, ps, has_aux=True)
        cmask_sg = jax.lax.stop_gradient(cmap)
        xm, ym = steps._mask_pair(c_x, c_y, cmask_sg)
        xm_nc, ym_nc = steps._mask_pair(nc_x, nc_y, cmask_sg)

        def d_loss_fn(pd_):
            c_out, muts = steps.D.apply({"params": pd_, "batch_stats": dbs}, xm, ym,
                                        train=True, mutable=["batch_stats"])
            nc_out, muts = steps.D.apply({"params": pd_, "batch_stats": muts["batch_stats"]},
                                         xm_nc, ym_nc, train=True, mutable=["batch_stats"])
            return 1.0 + _wmean(nc_out.astype(f32), w) - _wmean(c_out.astype(f32), w), \
                muts["batch_stats"]

        (d_loss, d_bs2), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(pd)
        pd_new, _ = joptim.apply_updates(pd, tx_d.init(pd), d_grads, tx_d, LR_D)
        y_fake = jax.lax.stop_gradient(steps.G.apply(
            {"params": pg, "batch_stats": gbs}, c_x, train=False).astype(f32))

        def s_loss_fn(cmap_s, ncmap_s):
            xm_, ym_ = steps._mask_pair(c_x, c_y, cmap_s)
            c_out, muts = steps.D.apply({"params": pd_new, "batch_stats": d_bs2}, xm_, ym_,
                                        train=True, mutable=["batch_stats"])
            nc_loss = _wmean(jnp.mean(ncmap_s ** 2, axis=(1, 2, 3)), w)
            gen, ssim, perc = steps._cgen_ck(c_y, y_fake, cmap_s, w)
            g_loss = gen + pw * perc + sw * ssim
            l1_loss = _wmean(jnp.mean(jnp.abs(cmap_s), axis=(1, 2, 3)), w)
            s_d_loss = _wmean(c_out.astype(f32), w)
            s_loss = steps.dw * s_d_loss + steps.l1w * l1_loss + gw * g_loss \
                + steps.ncw * nc_loss
            return s_loss, (muts["batch_stats"], s_d_loss, l1_loss, nc_loss, g_loss, gen,
                            ssim, perc)

        (s_loss, aux), map_grads = jax.value_and_grad(s_loss_fn, argnums=(0, 1),
                                                      has_aux=True)(cmap, ncmap)
        d_bs3, *terms = aux
        (s_grads,) = s_vjp(map_grads)
        m = dict(zip(ADV_METRICS, (d_loss, s_loss, *terms)))
        from fcdgan_tpu.eval.evaluator import confusion_update

        cmask_t = (cmap[..., 0] > 0.6).astype(f32)
        m["confusion"] = confusion_update(c_ref[..., 0], cmask_t, (0, 1), (0, 1),
                                          jnp.broadcast_to(w[:, None, None], cmask_t.shape))
        # infer_train_mode (steps.py:450-458) is the first S forward above:
        # train mode on the changed pair from the initial statistics
        infer = ({"density": cmap}, {"s": s_bs1}, {})
        return (m, {"s": s_bs2, "d": d_bs3}, {"s": s_grads, "d": d_grads}), infer

    adv, infer = adversarial(pg, ps, pd)
    out = {"g_pretrain": g_pretrain(pg), "adversarial": adv, "infer_train_mode": infer}
    return dict(vggp=vggp, g={"params": pg, "batch_stats": gbs},
                s={"params": ps, "batch_stats": sbs}, d={"params": pd, "batch_stats": dbs},
                out=out)


KINDS = {"g": "generator", "s": "segmentor", "d": "discriminator"}


def _port(jx):
    nets = {"g": Generator(3), "s": Segmentor(3), "d": Discriminator(3)}
    for name, net in nets.items():
        net.load_state_dict(from_jax_variables(jx[name], KINDS[name]), strict=True)
    g, s, d = nets["g"], nets["s"], nets["d"]
    steps = WSSSSteps(g, s, d, adam(g.parameters()), rmsprop(s.parameters()),
                      rmsprop(d.parameters()), VGG16Weights(jx["vggp"], "cpu"),
                      PerceptionConfig(TAPS, False), prob_thresh=0.6, msssim_weights=MSW,
                      **WEIGHTS)
    return steps, nets


def _step(jx, phase, batch, eps=0.0, seed=0):
    """One port step of ``phase`` from the JAX weights: its outputs, nets and
    gradients. With ``eps`` the batch's images are scaled per element by
    (1 + eps * N(0, 1)) drawn from ``seed``."""
    steps, nets = _port(jx)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if eps:
        gen = torch.Generator().manual_seed(seed)
        for k in ("c_x", "c_y", "nc_x", "nc_y"):
            t[k] = t[k] * (1 + eps * torch.randn(t[k].shape, generator=gen))
    if phase == "g_pretrain":
        m = steps.g_pretrain(t["nc_x"], t["nc_y"], t["w"], 1e-4)
    elif phase == "adversarial":
        m = steps.adversarial(t["c_x"], t["c_y"], t["c_ref"], t["nc_x"], t["nc_y"], t["w"],
                              1e-4, LR_D)
    else:  # slice_inference's pass: S in train mode, no gradients
        nets["s"].train()
        with torch.no_grad():
            m = {"density": nhwc_infer(nets["s"])(t["c_x"], t["c_y"])}
    grads = {n: {k: p.grad.numpy().copy() for k, p in net.named_parameters()
                 if p.grad is not None} for n, net in nets.items()}
    return m, nets, grads


@pytest.mark.parametrize("phase", ["g_pretrain", "adversarial", "infer_train_mode"])
def test_step_matches_jax(phase, jx, batch):
    m, nets, grads = _step(jx, phase, batch)
    want_m, want_stats, want_grads = jx["out"][phase]

    for k, v in want_m.items():
        if k == "density":
            assert m[k].shape == (2, HW, HW, 1)
            np.testing.assert_allclose(m[k].numpy(), np.asarray(v), atol=1e-4)
        elif k == "confusion":
            cm, want_cm = m[k].numpy(), np.asarray(v)
            assert cm.sum() == want_cm.sum() == 2 * HW * HW
            # thresholds at 0.6 may flip for a density within float noise of it
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
                wm, wnets, wgrads = _step(jx, phase, batch, WITNESS_EPS, seed)
                witness.append({"grads": wgrads, "stats": {
                    n: {k: v.numpy().copy() for k, v in net.state_dict().items()}
                    for n, net in wnets.items()}})
        self_gap = max(np.linalg.norm(got - wt[part][net_name][name]) for wt in witness)
        gap = np.linalg.norm(got - want)
        assert gap <= 2 * self_gap, (net_name, name, gap, self_gap)

    # BN running stats after the step: atol 1e-5 (test_torch_usss.py), else
    # the witness: the third D forward runs on D after its first RMSprop
    # step, about lr * sign(g) per weight, which a near-zero gradient of the
    # other sign moves by 2 * lr
    for net_name, bs in want_stats.items():
        want_sd = variables_to_torch(jx[net_name]["params"], bs, kind=KINDS[net_name])
        sd = nets[net_name].state_dict()
        for k, v in want_sd.items():
            if k.endswith(("running_mean", "running_var")):
                got = sd[k].numpy()
                if not np.allclose(got, v, rtol=0, atol=1e-5):
                    within_witness(net_name, k, got, v, "stats")
    for net_name in set(nets) - set(want_stats):  # nets the phase runs in eval mode
        if net_name == "g" or phase == "infer_train_mode":
            want_sd = variables_to_torch(jx[net_name]["params"], jx[net_name]["batch_stats"],
                                         kind=KINDS[net_name])
            sd = nets[net_name].state_dict()
            for k, v in want_sd.items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)

    # gradients: per element at rtol 2e-3 / atol 2e-5, else the witness (the
    # scheme of test_torch_usss.py)
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


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _demo_argv(root, ext):
    before, after, label, _ = _dirs(root)
    return ["--img-dir-x", before, "--img-dir-y", after, "--ref-dir", label,
            "--label-dir", root, "--out-g-model-dir", os.path.join(root, "GModel"),
            "--device", "cpu", "--msssim-weights", "0.5,0.5", "--batch-size", "2",
            "--unc-batch-size", "3", "--init-num-epochs-g", "1", "--num-epochs", "1",
            "--log-tensorboard", "false", "--progress", "false", "--ext", ext]


def test_demo_wsss_end_to_end_on_cpu(tmp_path):
    """Two runs of the port's driver on a tiny synthetic WHU set: every
    artifact and checkpoints that load strictly; the second run reuses the
    first one's GModel.pkl and skips the G pretrain."""
    from fcdgan_tpu_torch.data.raster import read_image
    from fcdgan_tpu_torch.data.synthetic import make_whu_dataset
    from fcdgan_tpu_torch.demos import demo_wsss

    root = str(tmp_path)
    make_whu_dataset(root, n_changed=3, n_unchanged=4, size=32, seed=1)
    changed = sorted(n for n, _, _, c in (ln.strip().split(",") for ln in
                                          open(os.path.join(root, "label.txt"))) if c == "1")
    first = demo_wsss.main(_demo_argv(root, "_a"))
    second = demo_wsss.main(_demo_argv(root, "_b"))
    assert first["g_pretrain_epochs"] == 1 and len(first["epoch_seconds"]["g"]) == 1
    assert second["g_pretrain_epochs"] == 0 and second["epoch_seconds"]["g"] == []
    for out in (first, second):
        assert out["out_dir"] == os.path.join(root, "Detection_WSS" + out["out_dir"][-2:])
        assert (out["changed"], out["unchanged"], out["pairs"]) == (3, 4, 4)
        for name in changed:
            density = read_image(os.path.join(out["density_dir"], name))
            color = read_image(os.path.join(out["out_dir"], name))
            assert density.shape == (32, 32, 1) and density.dtype == np.uint8
            assert color.shape == (32, 32, 3)
            assert set(np.unique(color)) <= {0, 255}
        ev = out["evaluator"]
        assert ev.confusion_matrix.sum() == 3 * 32 * 32
        assert np.isfinite(ev.Pixel_Accuracy())
        assert "Segmentation, Overall Accuracy" in open(out["para_path"]).read()
        for m in out["epoch_metrics"]["adv"]:
            assert all(np.isfinite(v) for v in m.values())
        for key, cls in (("smodel_path", Segmentor), ("gmodel_path", Generator),
                         ("dmodel_path", Discriminator)):
            cls(3).load_state_dict(torch.load(out[key], weights_only=True), strict=True)
    assert os.path.basename(first["gmodel_path"]) == "GModel.pkl"


def _run_option(tmp_path, monkeypatch, *flags):
    """The driver with ``flags`` on 3 changed and 4 unchanged 32 px slices
    (batch 3: a tail of one pair), no G pretrain, one adversarial epoch;
    checks the artifacts and returns the result, the adversarial batch sizes
    and the erasers the driver built."""
    from fcdgan_tpu_torch.data.raster import read_image
    from fcdgan_tpu_torch.data.synthetic import make_whu_dataset
    from fcdgan_tpu_torch.demos import demo_wsss

    root = str(tmp_path)
    make_whu_dataset(root, n_changed=3, n_unchanged=4, size=32, seed=1)
    sizes, erasers = [], []
    adversarial, build = WSSSSteps.adversarial, demo_wsss.build_eraser

    def recorded(self, c_x, *args):
        sizes.append(int(c_x.shape[0]))
        return adversarial(self, c_x, *args)

    monkeypatch.setattr(WSSSSteps, "adversarial", recorded)
    monkeypatch.setattr(demo_wsss, "build_eraser",
                        lambda *a: erasers.append(build(*a)) or erasers[-1])
    argv = _demo_argv(root, "_o")
    argv[argv.index("--batch-size") + 1] = "3"
    argv[argv.index("--init-num-epochs-g") + 1] = "0"
    out = demo_wsss.main([*argv, "--save-checkpoints", "false", *flags])
    names = sorted(n for n, _, _, c in (ln.strip().split(",") for ln in
                                        open(os.path.join(root, "label.txt"))) if c == "1")
    for name in names:
        assert read_image(os.path.join(out["density_dir"], name)).shape == (32, 32, 1)
        assert read_image(os.path.join(out["out_dir"], name)).shape == (32, 32, 3)
    assert out["evaluator"].confusion_matrix.sum() == 3 * 32 * 32
    assert os.path.isfile(out["para_path"])
    for m in out["epoch_metrics"]["adv"]:
        assert all(np.isfinite(v) for v in m.values())
    return out, sizes, erasers


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("flag", [["--siamese-stats", "split"], ["--remat", "true"],
                                  ["--tail", "pad"], ["--random-assign", "true"],
                                  ["--random-eraser", "true"], ["--n-devices", "1"],
                                  ["--checkpoint-every", "1"], ["--resume", "true"],
                                  ["--density-dtype", "uint8"], ["--profile-dir", "p"],
                                  ["--debug-nans", "true"]])
def test_unported_options_raise(flag, tmp_path, monkeypatch):
    """The options the WSSS driver once left out each run through the driver
    on the CPU and write their artifacts (``_run_option``). The eraser and a
    random pairing leave the resident slices for the Python loaders.
    ``--n-devices 1`` runs every data-parallel path of the driver in a world
    of one gloo rank here: the padded tail (the batch of 3 and its padded
    tail of one), the all-reduces, the train-mode inference's gather (two
    ranks: ``test_torch_parallel_steps.py`` and the USSS driver)."""
    import json
    resume = tmp_path / "Detection_WSS_o" / "resume.ckpt"
    if flag[0] == "--resume":  # a record of a finished adversarial phase
        resume.mkdir(parents=True)
        (resume / "meta.json").write_text(json.dumps({"phase": "adv", "epoch": 0}))
    if flag[0] == "--profile-dir":
        flag = [flag[0], str(tmp_path / flag[1])]
    out, sizes, erasers = _run_option(tmp_path, monkeypatch, *flag)
    host = flag[0] in ("--random-assign", "--random-eraser")
    assert out["feed"] == ("host" if host else "resident")
    padded = flag[0] in ("--tail", "--n-devices")
    assert sizes == ([] if flag[0] == "--resume" else [3, 3] if padded else [3, 1])
    assert (erasers[0] is not None) == (flag[0] == "--random-eraser")
    assert out["dstate"].siamese_stats == out["sstate"].siamese_stats == (
        "split" if flag[0] == "--siamese-stats" else "joint")
    if flag[0] == "--checkpoint-every":
        assert json.loads((resume / "meta.json").read_text()) == {"phase": "adv", "epoch": 0}
        assert sorted(os.listdir(resume)) == ["meta.json", "netD.pt", "netG.pt", "netS.pt"]
        shutil.rmtree(resume)  # half a GB of S and its RMSprop state
    if flag[0] == "--profile-dir":
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(flag[1]))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("flag", [["--eraser-regions", "2"], ["--erase-thresh", "0.2"],
                                  ["--learning-rate", "1e-3"], ["--device-normalize", "on"]])
def test_unread_options_are_rejected(flag, tmp_path, monkeypatch):
    """Flags of no field of the config are rejected; ``--eraser-regions``
    and ``--erase-thresh`` are fields since the eraser runs, and reach it
    (with ``--random-eraser``, through the driver)."""
    from fcdgan_tpu_torch.data.erasers import RandomEraser, RandomEraserMultiRegion
    from fcdgan_tpu_torch.demos import demo_wsss

    if flag[0] not in ("--eraser-regions", "--erase-thresh"):
        with pytest.raises(SystemExit):
            demo_wsss.main(["--label-dir", str(tmp_path), "--device", "cpu", *flag])
        return
    _, _, erasers = _run_option(tmp_path, monkeypatch, "--random-eraser", "true", *flag)
    eraser = erasers[0]
    if flag[0] == "--eraser-regions":
        assert isinstance(eraser, RandomEraserMultiRegion) and eraser.multi_region == 2
    else:
        assert isinstance(eraser, RandomEraser) and eraser.erase_thresh == 0.2
