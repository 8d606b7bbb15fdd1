"""``--remat``: the forwards the JAX steps wrap in ``jax.checkpoint`` are
recomputed in the backward (``train.steps.rematerialized``).

On the CPU the recompute repeats the same arithmetic, so a remat step must
equal the step without remat bit for bit: losses, gradients, parameters
after the optimizer, and every BatchNorm's running statistics and
``num_batches_tracked`` (a recompute that updated them again would leave
0.81 r + 0.19 m in place of 0.9 r + 0.1 m, and count the batch twice). Two
steps run in a row, so the second recomputes with the weights the first
step's optimizer wrote. The kernel calls of a remat step are those of the
step without remat plus the forward kernels of the recomputed regions, the
count ``chip_smoke.py`` derives for its remat phase. A remat USSS joint step
is held against the JAX package's ``remat=True`` step (losses rtol 1e-4;
running statistics and gradients atol 1e-5, the bounds of
``tests/test_steps.py:433-470``, else the witness of
``test_torch_usss.py``)."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.models import Generator as JaxGenerator
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.models.vgg import vgg16_random_params
from fcdgan_tpu.train import optim as joptim
from fcdgan_tpu.train import steps as jsteps
from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights
from fcdgan_tpu_torch.ops import channel_sums, conv3x3, fused_ssim, phase_pool, pool_bwd
from fcdgan_tpu_torch.train.optim import adam, rmsprop
from fcdgan_tpu_torch.train.steps import PerceptionConfig, RSSSSteps, USSSSteps, WSSSSteps

from test_torch_siamese_split import _batch, _init, _perturbed, check, grads_of, jax_sd, stats_of
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HW = 32
MSW = (0.5, 0.5)
TAPS = (29,)  # relu5_3: four VGG pools, so the recomputed loss stack pools too
PLAIN = [(conv3x3, "conv3x3_plain", "conv3x3"), (channel_sums, "channel_sums_plain",
                                                 "channel_sums"),
         (channel_sums, "channel_sums_pair_plain", "channel_sums_pair"),
         (phase_pool, "phase_pool_plain", "phase_pool"), (pool_bwd, "pool_bwd_plain", "pool_bwd"),
         (fused_ssim, "ssim_level", "fused_ssim")]


@contextlib.contextmanager
def kernel_calls():
    """Counts, by kernel, the calls of each kernel wrapper's CPU version
    (fused_ssim: its wrapper, whose backward runs the composite)."""
    counts = dict.fromkeys((name for *_, name in PLAIN), 0)
    saved = []
    for mod, attr, name in PLAIN:
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, counted)
    try:
        yield counts
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@pytest.fixture(scope="module")
def vggp():
    return vgg16_random_params(0)


def _nets(mode, nb, seed=0):
    torch.manual_seed(seed)
    nets = {"g": Generator(nb), "s": Segmentor(nb)}
    if mode != "usss":
        nets["d"] = Discriminator(nb)
    return nets


def _steps(mode, nets, vggp, remat):
    g, s = nets["g"], nets["s"]
    vgg = VGG16Weights(vggp, "cpu")
    if mode == "usss":
        return USSSSteps(g, s, adam(g.parameters()), adam(s.parameters()), vgg,
                         PerceptionConfig(TAPS, True), 0.4, 0.65, 0.0,
                         np.array([[HW - 8, HW - 8]] * 2), (4, 4), msssim_weights=MSW,
                         remat=remat)
    d = nets["d"]
    opts = adam(g.parameters()), rmsprop(s.parameters()), rmsprop(d.parameters())
    if mode == "wsss":
        return WSSSSteps(g, s, d, *opts, vgg, PerceptionConfig(TAPS, False), 0.5, 0.0, 0.2,
                         1.6, 1.0, 1.5, msssim_weights=MSW, remat=remat)
    return RSSSSteps(g, s, d, *opts, vgg, PerceptionConfig(TAPS, True), 0.1, 0.0, 0.5, 0.02,
                     1.0, 2.0, np.array([[HW - 8, HW - 8]] * 2), (4, 4), msssim_weights=MSW,
                     remat=remat)


def _run(step, st, t):
    if step == "usss_g_pretrain":
        return st.g_pretrain(t["x"], t["y"], t["w"], 1e-4)
    if step == "usss_s_init":
        return st.s_init(t["x"], t["y"], t["ref"], t["item"], t["w"], 1e-4)
    if step == "usss_joint":
        return st.joint(t["x"], t["y"], t["ref"], t["item"], t["w"], 1e-4, 1e-4)
    if step in ("wsss_g_pretrain", "rsss_g_pretrain"):
        if step == "wsss_g_pretrain":
            return st.g_pretrain(t["nc_x"], t["nc_y"], t["w"], 1e-4)
        return st.g_pretrain(t["x"], t["y"], t["region"], t["w"], 1e-4)
    if step == "wsss_adversarial":
        return st.adversarial(t["x"], t["y"], t["c_ref"], t["nc_x"], t["nc_y"], t["w"],
                              1e-4, 1e-5)
    return st.adversarial(t["x"], t["y"], t["ref"], t["region"], t["item"], t["w"], 1e-4, 5e-6)


def _k(nb):
    """Per forward at HW px: gated 3x3 convs and BNs of G and S, S's pools,
    the VGG pools before relu5_3."""
    from fcdgan_tpu_torch.ops.conv3x3 import gate

    def gated(mod, hw):
        return sum(1 for m in mod.modules() if isinstance(m, torch.nn.Conv2d)
                   and m.kernel_size == (3, 3) and m.stride == (1, 1)
                   and gate(hw, hw, m.in_channels, m.out_channels))

    g, s = Generator(nb), Segmentor(nb)
    levels = [(s.inc, 0), (s.down1, 1), (s.down2, 2), (s.down3, 3), (s.down4, 4),
              (s.up1, 3), (s.up2, 2), (s.up3, 1), (s.up4, 0)]
    bns = lambda m: sum(isinstance(b, torch.nn.BatchNorm2d) for b in m.modules())  # noqa: E731
    return dict(gc=gated(g, HW), sc=sum(gated(b, HW >> lv) for b, lv in levels),
                gb=bns(g), sb=bns(s), sp=4, vp=4)


def recomputed(step, nb):
    """The kernel calls a remat step adds: the forward kernels of its
    recomputed regions. USSS: G (pretrain, joint) and S (S init, joint),
    and the loss stack, whose VGG passes pool again (the target's pass too
    in the G pretrains), while its MS-SSIM, computed last and without a
    graph, is not recomputed; WSSS and RSSS: G in the pretrain, and the loss
    stack, whose MS-SSIM comes before the VGG and is recomputed."""
    k = _k(nb)
    levels = len(MSW)
    g = dict(conv3x3=k["gc"], channel_sums=k["gb"])
    s = dict(conv3x3=k["sc"], channel_sums=k["sb"], phase_pool=k["sp"])
    table = {
        "usss_g_pretrain": [g, dict(phase_pool=2 * k["vp"])],
        "usss_s_init": [s, dict(phase_pool=k["vp"])],
        "usss_joint": [g, s, dict(phase_pool=k["vp"])],
        "wsss_g_pretrain": [g, dict(phase_pool=2 * k["vp"], fused_ssim=levels)],
        "wsss_adversarial": [dict(phase_pool=k["vp"], fused_ssim=levels)],
        "rsss_g_pretrain": [g, dict(phase_pool=2 * k["vp"], fused_ssim=levels)],
        "rsss_adversarial": [dict(phase_pool=k["vp"], fused_ssim=levels)]}
    out = dict.fromkeys((name for *_, name in PLAIN), 0)
    for part in table[step]:
        for name, n in part.items():
            out[name] += n
    return out


STEPS = ["usss_g_pretrain", "usss_s_init", "usss_joint", "wsss_g_pretrain",
         "wsss_adversarial", "rsss_g_pretrain", "rsss_adversarial"]


@pytest.mark.parametrize("step", STEPS)
def test_remat_step_is_the_step(step, vggp):
    """Two remat steps equal two steps without remat bit for bit on the
    CPU, BN buffers and counts included; the remat steps add exactly the
    recomputed forwards' kernel calls."""
    mode = step.split("_")[0]
    nb = 4 if mode == "rsss" else 3
    batch = _batch(HW, nb, 1)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["item"] = t["item"].long()
    runs = {}
    for remat in (False, True):
        nets = _nets(mode, nb)
        st = _steps(mode, nets, vggp, remat)
        metrics, calls = [], []
        for _ in range(2):
            with kernel_calls() as counts:
                metrics.append(_run(step, st, t))
            calls.append(dict(counts))
        runs[remat] = nets, metrics, calls
    (nets0, m0, c0), (nets1, m1, c1) = runs[False], runs[True]
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for name in nets0:
        sd0, sd1 = nets0[name].state_dict(), nets1[name].state_dict()
        for k in sd0:
            assert torch.equal(sd0[k], sd1[k]), (name, k)  # params, running stats, counts
        for (k, p0), p1 in zip(nets0[name].named_parameters(), nets1[name].parameters()):
            assert (p0.grad is None) == (p1.grad is None), k
            if p0.grad is not None:
                assert torch.equal(p0.grad, p1.grad), (name, k)
    added = recomputed(step, nb)
    for before, after in zip(c0, c1):
        assert {k: after[k] - before[k] for k in after} == added


def test_remat_joint_step_matches_jax_remat(vggp):
    """A remat USSS joint step against the JAX package's ``remat=True`` one
    (its checkpointed ``_g_fwd``, ``_s_fwd`` and ``_cnet_ck``), from the
    same weights: losses, G's and S's running statistics, the gradients."""
    steps = jsteps.USSSSteps(
        JaxGenerator(3), JaxSegmentor(3, bilinear=True), joptim.adam(), joptim.adam(), vggp,
        jsteps.PerceptionConfig((3,), per_band=True), perception_weight=0.4,
        l1_weight=0.65, ssim_weight=0.0, interior_sizes=np.array([[HW - 8, HW - 8]] * 2),
        pad=(4, 4), msssim_weights=MSW, remat=True)
    init = _init(steps, HW, 3)
    batch = _batch(HW, 3, 2)
    x, y, w = (jnp.asarray(batch[k]) for k in ("x", "y", "w"))
    gbs, sbs, l1w, f32 = init["g"]["batch_stats"], init["s"]["batch_stats"], steps.l1w, jnp.float32

    @jax.jit
    def joint(pg, ps):
        def fwd(pg_, ps_):
            y_fake, g_muts = steps._g_fwd(pg_, gbs, x)
            cmap, s_muts = steps._s_fwd(ps_, sbs, x, y)
            gen, l1, perc, ssim = steps._cnet_ck(y, y_fake.astype(f32), cmap.astype(f32), w)
            return (gen + steps.pw * perc + steps.sw * ssim, l1), (
                g_muts["batch_stats"], s_muts["batch_stats"])

        (a, l1), vjp_fn, (g_bs, s_bs) = jax.vjp(fwd, pg, ps, has_aux=True)
        d_pg, d_ps = vjp_fn((jnp.ones((), f32), jnp.full((), l1w, f32)))
        return a + l1w * l1, {"g": g_bs, "s": s_bs}, {"g": jax.tree.map(lambda t: 2 * t, d_pg),
                                                      "s": d_ps}

    want_loss, want_stats, want_grads = joint(init["g"]["params"], init["s"]["params"])

    def port(b):
        from fcdgan_tpu_torch.io.torch_interop import from_jax_variables

        nets = {"g": Generator(3), "s": Segmentor(3)}
        for name, kind in (("g", "generator"), ("s", "segmentor")):
            nets[name].load_state_dict(from_jax_variables(init[name], kind), strict=True)
        st = USSSSteps(nets["g"], nets["s"], adam(nets["g"].parameters()),
                       adam(nets["s"].parameters()), VGG16Weights(vggp, "cpu"),
                       PerceptionConfig((3,), True), 0.4, 0.65, 0.0,
                       np.array([[HW - 8, HW - 8]] * 2), (4, 4), msssim_weights=MSW,
                       remat=True)
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        m = st.joint(t["x"], t["y"], t["ref"], t["item"].long(), t["w"], 1e-4, 1e-4)
        return m, nets

    m, nets = port(batch)
    np.testing.assert_allclose(float(m["NetLoss"]), float(want_loss), rtol=1e-4)
    runs = {}

    def rerun(seed):
        if seed not in runs:
            runs[seed] = port(dict(batch, **_perturbed({"x": batch["x"], "y": batch["y"]},
                                                       seed)))[1]
        return runs[seed]

    kinds = {"g": "generator", "s": "segmentor"}
    for name, kind in kinds.items():
        want = {k: v for k, v in jax_sd(init[name]["params"], want_stats[name], kind).items()
                if k.endswith(("running_mean", "running_var"))}
        check(stats_of(nets[name]), want, lambda seed: stats_of(rerun(seed)[name]), 0, 1e-5)
        want = jax_sd(want_grads[name], init[name]["batch_stats"], kind)
        got = grads_of(nets[name])
        check(got, {k: want[k] for k in got}, lambda seed: grads_of(rerun(seed)[name]), 0, 1e-5)
