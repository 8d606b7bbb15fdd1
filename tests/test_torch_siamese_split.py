"""``--siamese-stats split`` (the reference's per-branch BatchNorm statistics)
held against the JAX package's split mode: the Segmentor and the
Discriminator in train mode (outputs, gradients, the running statistics they
leave), one USSS joint, one WSSS adversarial and one RSSS adversarial step
with split S and D, the eval-mode split Segmentor against the joint one, and
the serving tool's whu train-mode inference.

The JAX package's split Discriminator builds a second trunk for y, with its
own convolutions and BatchNorms (``test_jax_split_discriminator_unties_its
_branches``), where the reference's two passes share one trunk, as the
port's do. So the JAX side here runs that module with both trunks tied to
the one trunk of the joint layout (``TiedSplitD``): its gradient is the sum
over the two trunks, and each BatchNorm's running statistics are those of
the x pass updated by the y pass, as one torch BatchNorm called twice.

Tolerances are those of the joint-mode tests: outputs and densities atol
1e-4 (the Discriminator's probabilities 2e-5), losses rtol 1e-4, running
statistics atol 1e-5, step gradients rtol 2e-3 / atol 2e-5 per element; a
tensor outside must lie no farther from JAX, in norm, than twice as far as
the port's own result moves when its inputs are scaled per element by
(1 + 1e-7 N(0, 1)) under two seeds (the witness of ``test_torch_usss.py``).
The models are held against the JAX function in float64, the gradients
within 3 % of each tensor's norm: at 32 px the float32 gradients of both
packages miss it by up to 1.3 % (this sandbox's CPU), and a Segmentor in
the wrong mode misses it by over 100 % in the median tensor. The steps use the
relu1_2 perception tap: the option changes S and D, not the VGG. The RSSS
step runs at 40 px, as ``test_torch_rsss.py`` explains."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Discriminator as JaxDiscriminator
from fcdgan_tpu.models import Generator as JaxGenerator
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.models.vgg import vgg16_random_params
from fcdgan_tpu.ops import losses as jlosses
from fcdgan_tpu.train import optim as joptim
from fcdgan_tpu.train import steps as jsteps
from fcdgan_tpu.train.state import create_net_state
from fcdgan_tpu_torch.io.torch_interop import from_jax_variables
from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights
from fcdgan_tpu_torch.train import steps as psteps
from fcdgan_tpu_torch.train.optim import adam, rmsprop

from test_torch_serve_whu import seeded_smodel, whu_dirs
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPLIT = "split"
MSW = (0.5, 0.5)
TAPS = (3,)
WITNESS_EPS = 1e-7
KINDS = {"g": "generator", "s": "segmentor", "d": "discriminator"}
f32 = jnp.float32


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def _perturbed(arrays, seed):
    """Each array scaled per element by (1 + WITNESS_EPS * N(0, 1))."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.from_numpy(np.asarray(v)) * (1 + WITNESS_EPS * torch.randn(
        np.shape(v), generator=gen))).numpy() for k, v in arrays.items()}


def check(got, want, rerun, rtol, atol):
    """Each ``got[key]`` within ``rtol``/``atol`` of ``want[key]`` per
    element, else within twice the port's own shift under the witness
    perturbation: ``rerun(seed)`` gives the port's values on perturbed
    inputs, under the same keys."""
    witness = []
    for key, w in want.items():
        g = got[key]
        if np.allclose(g, w, rtol=rtol, atol=atol):
            continue
        if not witness:
            witness.extend(rerun(seed) for seed in (0, 1))
        self_gap = max(np.linalg.norm(g - wt[key]) for wt in witness)
        assert np.linalg.norm(g - w) <= 2 * self_gap, (key, np.linalg.norm(g - w), self_gap)


def stats_of(net):
    return {k: v.numpy().copy() for k, v in net.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def grads_of(net):
    return {k: p.grad.numpy().copy() for k, p in net.named_parameters() if p.grad is not None}


def jax_sd(params, stats, kind):
    return variables_to_torch(params, stats, kind=kind)


class TiedSplitD:
    """The JAX split Discriminator with its two trunks tied to the trunk of
    the joint layout's variables: ``apply`` takes and returns the joint
    layout (TorchConv_0-3 trunk, TorchConv_4-5 classifier, BatchNorm_0-2),
    the running statistics of the y pass applied after the x pass's."""

    def __init__(self, nb):
        self.module = JaxDiscriminator(nb, siamese_stats=SPLIT)

    @staticmethod
    def _split(tree, convs=True):
        out = {f"BatchNorm_{i + k}": tree[f"BatchNorm_{i}"] for i in range(3) for k in (0, 3)}
        if convs:
            out.update({f"TorchConv_{i + k}": tree[f"TorchConv_{i}"]
                        for i in range(4) for k in (0, 4)})
            out.update(TorchConv_8=tree["TorchConv_4"], TorchConv_9=tree["TorchConv_5"])
        return out

    def apply(self, variables, x, y, train=True, mutable=()):
        params, stats = variables["params"], variables["batch_stats"]
        out = self.module.apply({"params": self._split(params),
                                 "batch_stats": self._split(stats, convs=False)},
                                x, y, train=train, mutable=mutable)
        if not mutable:
            return out
        out, muts = out
        new = {f"BatchNorm_{i}": jax.tree.map(
            lambda a, b, r: 0.9 * a + b - 0.9 * r, muts["batch_stats"][f"BatchNorm_{i}"],
            muts["batch_stats"][f"BatchNorm_{i + 3}"], stats[f"BatchNorm_{i}"])
            for i in range(3)}
        return out, {"batch_stats": new}


def test_jax_split_discriminator_unties_its_branches():
    """The JAX package's split Discriminator (discriminator.py:50-61) calls
    its block closures twice, so flax builds a second trunk for y; the
    reference's (Module.py:192-223) and the port's split passes share one."""
    z = jnp.zeros((1, 32, 32, 3))
    v = jax.eval_shape(lambda: JaxDiscriminator(3, siamese_stats=SPLIT).init(
        {"params": jax.random.PRNGKey(0)}, z, z, train=False))
    assert len([k for k in v["params"] if k.startswith("TorchConv")]) == 10  # 2 x 4 + 2
    assert len(v["batch_stats"]) == 6
    port = Discriminator(3, siamese_stats=SPLIT)
    assert port.state_dict().keys() == Discriminator(3).state_dict().keys()


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


MODELS = {  # name: (JAX init module, JAX split model, port class, side, batch)
    "segmentor": (lambda: JaxSegmentor(3, bilinear=True),
                  lambda: JaxSegmentor(3, bilinear=True, siamese_stats=SPLIT),
                  lambda: Segmentor(3, siamese_stats=SPLIT), 32, 2),
    "discriminator": (lambda: JaxDiscriminator(3), lambda: TiedSplitD(3),
                      lambda: Discriminator(3, siamese_stats=SPLIT), 32, 3)}


@pytest.mark.parametrize("kind", list(MODELS))
def test_split_train_mode_matches_jax(kind):
    """Output, the gradients of a fixed projection of it, and the running
    statistics after one split train-mode forward (two BN passes each)."""
    make_init, make_jax, make_port, side, n = MODELS[kind]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, side, side, 3)).astype(np.float32)
    y = (0.8 * x + rng.normal(scale=0.5, size=x.shape)).astype(np.float32)
    model = make_jax()
    v = make_init().init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), jnp.asarray(y),
                         train=False)
    v = jax.tree.map(np.asarray, v)
    out_shape = (n, side, side, 1) if kind == "segmentor" else (n,)
    proj = rng.uniform(0.5, 1.5, size=out_shape).astype(np.float32)

    def loss(params):
        out, muts = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out * proj), (out, muts["batch_stats"])

    with jax.enable_x64(True):  # the float64 reference of output, statistics, gradients
        (_, (want_out, want_bs)), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(lambda a: np.asarray(a, np.float64), v["params"]))
        want_out, want_bs, want_g = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                 (want_out, want_bs, want_g))

    def port(inputs):
        net = make_port()
        net.load_state_dict(from_jax_variables(v, kind), strict=True)
        net.train()
        out = net(_nchw(inputs["x"]), _nchw(inputs["y"]))
        if kind == "segmentor":
            out = out.permute(0, 2, 3, 1)
        (out * torch.from_numpy(proj)).sum().backward()
        return net, out.detach().numpy()

    net, out = port({"x": x, "y": y})
    np.testing.assert_allclose(out, np.asarray(want_out),
                               atol=1e-4 if kind == "segmentor" else 2e-5)
    for name, buf in net.state_dict().items():  # one count per pass, as flax's
        if name.endswith("num_batches_tracked"):
            assert int(buf) == (1 if name.startswith("up") else 2), name  # S's decoder: one
    want_sd = jax_sd(v["params"], want_bs, kind)
    check(stats_of(net), {k: w for k, w in want_sd.items() if k in stats_of(net)},
          lambda seed: stats_of(port(_perturbed({"x": x, "y": y}, seed))[0]), 0, 1e-5)
    want_grads = jax_sd(want_g, v["batch_stats"], kind)
    got = grads_of(net)
    for name, w in want_grads.items():
        if name in got:
            gap = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
            assert gap <= 3e-2, (name, gap)
        elif not name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            np.testing.assert_allclose(w, 0.0, atol=1e-9, err_msg=name)  # a folded conv bias


def test_split_equals_joint_in_eval_mode():
    """Eval mode uses the running statistics, so the two modes are the same
    function, within f32 rounding (the JAX package's tests/test_models.py)."""
    rng = np.random.default_rng(5)
    x, y = (torch.from_numpy(rng.normal(size=(2, 3, 32, 32)).astype(np.float32))
            for _ in range(2))
    joint = Segmentor(3).eval()
    split = Segmentor(3, siamese_stats=SPLIT).eval()
    split.load_state_dict(joint.state_dict(), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(split(x, y).numpy(), joint(x, y).numpy(), atol=1e-5)
    assert Segmentor(3).state_dict().keys() == split.state_dict().keys()
    with pytest.raises(ValueError, match="siamese_stats"):
        Segmentor(3, siamese_stats="both")


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _init(steps, side, nb):
    k = jax.random.PRNGKey(0)
    z = jnp.zeros((2, side, side, nb))
    states = {"g": create_net_state(steps.G, k, (z,)),
              "s": create_net_state(steps.S, jax.random.fold_in(k, 1), (z, z))}
    if hasattr(steps, "D"):
        states["d"] = create_net_state(steps.D, jax.random.fold_in(k, 2), (z, z))
    return {n: {"params": jax.tree.map(np.asarray, st.params), "batch_stats": st.batch_stats}
            for n, st in states.items()}


def _port_nets(init, nb):
    nets = {"g": Generator(nb), "s": Segmentor(nb, siamese_stats=SPLIT)}
    if "d" in init:
        nets["d"] = Discriminator(nb, siamese_stats=SPLIT)
    for name, net in nets.items():
        net.load_state_dict(from_jax_variables(init[name], KINDS[name]), strict=True)
    return nets


def _usss(vggp, batch):
    steps = jsteps.USSSSteps(
        JaxGenerator(3), JaxSegmentor(3, bilinear=True, siamese_stats=SPLIT), joptim.adam(),
        joptim.adam(), vggp, jsteps.PerceptionConfig(TAPS, per_band=True),
        perception_weight=0.4, l1_weight=0.65, ssim_weight=0.0,
        interior_sizes=np.array([[24, 24]] * 4, np.int32), pad=(4, 4), msssim_weights=MSW)
    init = _init(steps, 32, 3)
    x, y, ref, item, w = (jnp.asarray(batch[k]) for k in ("x", "y", "ref", "item", "w"))
    gbs, sbs, l1w = init["g"]["batch_stats"], init["s"]["batch_stats"], steps.l1w

    @jax.jit
    def joint(pg, ps):  # the body of USSSSteps._joint before the optimizer
        def fwd(pg_, ps_):
            y_fake, g_muts = steps._g_fwd(pg_, gbs, x)
            cmap, s_muts = steps._s_fwd(ps_, sbs, x, y)
            gen, l1, perc, ssim = steps._cnet_ck(y, y_fake.astype(f32), cmap.astype(f32), w)
            return (gen + steps.pw * perc + steps.sw * ssim, l1), (
                g_muts["batch_stats"], s_muts["batch_stats"], gen, perc)

        (a, l1), vjp_fn, (g_bs, s_bs, gen, perc) = jax.vjp(fwd, pg, ps, has_aux=True)
        d_pg, d_ps = vjp_fn((jnp.ones((), f32), jnp.full((), l1w, f32)))
        m = {"NetLoss": a + l1w * l1, "generator_loss": gen, "l1_loss": l1,
             "perception_loss": perc}
        return m, {"g": g_bs, "s": s_bs}, {"g": jax.tree.map(lambda t: 2.0 * t, d_pg),
                                           "s": d_ps}

    out = joint(init["g"]["params"], init["s"]["params"])

    def port(b):
        nets = _port_nets(init, 3)
        st = psteps.USSSSteps(nets["g"], nets["s"], adam(nets["g"].parameters()),
                              adam(nets["s"].parameters()), VGG16Weights(vggp, "cpu"),
                              psteps.PerceptionConfig(TAPS, True), 0.4, 0.65, 0.0,
                              np.array([[24, 24]] * 4), (4, 4), msssim_weights=MSW)
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        m = st.joint(t["x"], t["y"], t["ref"], t["item"].long(), t["w"], 1e-4, 1e-4)
        return m, nets

    return init, out, port


def _wsss(vggp, batch):
    weights = dict(perception_weight=0.5, ssim_weight=0.0, g_weight=0.2, l1_weight=1.6,
                   d_weight=1.0, nc_weight=1.5)
    steps = jsteps.WSSSSteps(
        JaxGenerator(3), JaxSegmentor(3, bilinear=True, siamese_stats=SPLIT),
        JaxDiscriminator(3), joptim.adam(), joptim.rmsprop(),
        joptim.rmsprop(), vggp, jsteps.PerceptionConfig(TAPS, per_band=False),
        prob_thresh=0.6, msssim_weights=MSW, **weights)
    init = _init(steps, 32, 3)  # D's variables in the joint layout
    dsplit = TiedSplitD(3)
    c_x, c_y, nc_x, nc_y, w = (jnp.asarray(batch[k]) for k in ("x", "y", "nc_x", "nc_y", "w"))
    gbs, sbs, dbs = (init[n]["batch_stats"] for n in "gsd")
    tx_d = joptim.rmsprop()

    @jax.jit
    def adversarial(pg, ps, pd):  # the body of WSSSSteps._adversarial before S's update
        def s_fwd(ps_):
            cmap_, m1 = steps.S.apply({"params": ps_, "batch_stats": sbs}, c_x, c_y,
                                      train=True, mutable=["batch_stats"])
            ncmap_, m2 = steps.S.apply({"params": ps_, "batch_stats": m1["batch_stats"]},
                                       nc_x, nc_y, train=True, mutable=["batch_stats"])
            return (cmap_.astype(f32), ncmap_.astype(f32)), m2["batch_stats"]

        (cmap, ncmap), s_vjp, s_bs = jax.vjp(s_fwd, ps, has_aux=True)
        keep = 1 - jax.lax.stop_gradient(cmap)

        def d_loss_fn(pd_):
            c_out, muts = dsplit.apply({"params": pd_, "batch_stats": dbs}, c_x * keep,
                                        c_y * keep, train=True, mutable=["batch_stats"])
            nc_out, muts = dsplit.apply({"params": pd_, "batch_stats": muts["batch_stats"]},
                                         nc_x * keep, nc_y * keep, train=True,
                                         mutable=["batch_stats"])
            return (1.0 + jsteps._wmean(nc_out.astype(f32), w)
                    - jsteps._wmean(c_out.astype(f32), w)), muts["batch_stats"]

        (d_loss, d_bs2), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(pd)
        pd_new, _ = joptim.apply_updates(pd, tx_d.init(pd), d_grads, tx_d, 1e-5)
        y_fake = jax.lax.stop_gradient(steps.G.apply(
            {"params": pg, "batch_stats": gbs}, c_x, train=False).astype(f32))

        def s_loss_fn(cmap_s, ncmap_s):
            keep_s = 1 - cmap_s
            c_out, muts = dsplit.apply({"params": pd_new, "batch_stats": d_bs2},
                                        c_x * keep_s, c_y * keep_s, train=True,
                                        mutable=["batch_stats"])
            gen, ssim, perc = steps._cgen_ck(c_y, y_fake, cmap_s, w)
            s_loss = (steps.dw * jsteps._wmean(c_out.astype(f32), w)
                      + steps.l1w * jsteps._wmean(jnp.mean(jnp.abs(cmap_s), axis=(1, 2, 3)), w)
                      + steps.gw * (gen + steps.pw * perc + steps.sw * ssim)
                      + steps.ncw * jsteps._wmean(jnp.mean(ncmap_s ** 2, axis=(1, 2, 3)), w))
            return s_loss, muts["batch_stats"]

        (s_loss, d_bs3), map_grads = jax.value_and_grad(s_loss_fn, argnums=(0, 1),
                                                        has_aux=True)(cmap, ncmap)
        (s_grads,) = s_vjp(map_grads)
        return ({"d_loss": d_loss, "s_loss": s_loss}, {"s": s_bs, "d": d_bs3},
                {"s": s_grads, "d": d_grads})

    out = adversarial(*(init[n]["params"] for n in "gsd"))

    def port(b):
        nets = _port_nets(init, 3)
        g, s, d = nets["g"], nets["s"], nets["d"]
        st = psteps.WSSSSteps(g, s, d, adam(g.parameters()), rmsprop(s.parameters()),
                              rmsprop(d.parameters()), VGG16Weights(vggp, "cpu"),
                              psteps.PerceptionConfig(TAPS, False), prob_thresh=0.6,
                              msssim_weights=MSW, **weights)
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        m = st.adversarial(t["x"], t["y"], t["c_ref"], t["nc_x"], t["nc_y"], t["w"], 1e-4,
                           1e-5)
        return m, nets

    return init, out, port


def _rsss(vggp, batch):
    weights = dict(perception_weight=0.1, ssim_weight=0.0, g_weight=0.5, l1_weight=0.02,
                   d_weight=1.0, r_weight=2.0)
    interior = np.array([[32, 32], [24, 20], [32, 32], [32, 24]], np.int32)
    steps = jsteps.RSSSSteps(
        JaxGenerator(4), JaxSegmentor(4, bilinear=True, siamese_stats=SPLIT),
        JaxDiscriminator(4), joptim.adam(), joptim.rmsprop(),
        joptim.rmsprop(), vggp, jsteps.PerceptionConfig(TAPS, per_band=True),
        interior_sizes=interior, pad=(4, 4), msssim_weights=MSW, **weights)
    init = _init(steps, 40, 4)  # D's variables in the joint layout
    dsplit = TiedSplitD(4)
    x, y, region, w = (jnp.asarray(batch[k]) for k in ("x", "y", "region", "w"))
    gbs, sbs, dbs = (init[n]["batch_stats"] for n in "gsd")
    tx_d = joptim.rmsprop()

    @jax.jit
    def adversarial(pg, ps, pd):  # the body of RSSSSteps._adversarial before S's update
        def s_fwd(ps_):
            cmap_, m = steps.S.apply({"params": ps_, "batch_stats": sbs}, x, y, train=True,
                                     mutable=["batch_stats"])
            return cmap_.astype(f32), m["batch_stats"]

        cmap, s_vjp, s_bs = jax.vjp(s_fwd, ps, has_aux=True)
        keep = 1 - jax.lax.stop_gradient(cmap)
        y_unc = y * (1 - region) + x * region

        def d_loss_fn(pd_):
            c_out, muts = dsplit.apply({"params": pd_, "batch_stats": dbs}, x * keep,
                                        y * keep, train=True, mutable=["batch_stats"])
            nc_out, muts = dsplit.apply({"params": pd_, "batch_stats": muts["batch_stats"]},
                                         x * keep, y_unc * keep, train=True,
                                         mutable=["batch_stats"])
            return (1.0 + jsteps._wmean(nc_out.astype(f32), w)
                    - jsteps._wmean(c_out.astype(f32), w)), muts["batch_stats"]

        (d_loss, d_bs2), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(pd)
        pd_new, _ = joptim.apply_updates(pd, tx_d.init(pd), d_grads, tx_d, 5e-6)
        y_fake = jax.lax.stop_gradient(steps.G.apply(
            {"params": pg, "batch_stats": gbs}, x, train=False).astype(f32))

        def s_loss_fn(cmap_s):
            keep_s = 1 - cmap_s
            c_out, muts = dsplit.apply({"params": pd_new, "batch_stats": d_bs2}, x * keep_s,
                                        y * keep_s, train=True, mutable=["batch_stats"])
            gen, ssim, perc = steps._cgen_ck(y, y_fake, cmap_s, w)
            s_loss = (steps.dw * jsteps._wmean(c_out.astype(f32), w)
                      + steps.l1w * jlosses.region_loss(cmap_s, region, "l1", sample_weight=w)
                      + steps.gw * (gen + steps.pw * perc + steps.sw * ssim)
                      + steps.rw * jlosses.region_loss(cmap_s, 1 - region, "mse",
                                                       sample_weight=w))
            return s_loss, muts["batch_stats"]

        (s_loss, d_bs3), g_cmap = jax.value_and_grad(s_loss_fn, has_aux=True)(cmap)
        (s_grads,) = s_vjp(g_cmap)
        return ({"d_loss": d_loss, "s_loss": s_loss}, {"s": s_bs, "d": d_bs3},
                {"s": s_grads, "d": d_grads})

    out = adversarial(*(init[n]["params"] for n in "gsd"))

    def port(b):
        nets = _port_nets(init, 4)
        g, s, d = nets["g"], nets["s"], nets["d"]
        st = psteps.RSSSSteps(g, s, d, adam(g.parameters()), rmsprop(s.parameters()),
                              rmsprop(d.parameters()), VGG16Weights(vggp, "cpu"),
                              psteps.PerceptionConfig(TAPS, True), interior_sizes=interior,
                              pad=(4, 4), msssim_weights=MSW, **weights)
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        m = st.adversarial(t["x"], t["y"], t["ref"], t["region"], t["item"].long(), t["w"],
                           1e-4, 5e-6)
        return m, nets

    return init, out, port


def _batch(side, nb, seed, n=2):
    rng = np.random.default_rng(seed)

    def pair(change):
        x = rng.normal(size=(n, side, side, nb)).astype(np.float32)
        y = (x * 0.9 + 0.1 + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
        if change:
            y[:, 8:20, 10:22, :] += 2.0
        return x, y

    x, y = pair(True)
    nc_x, nc_y = pair(False)
    ref = np.ones((n, side, side, 1), np.float32)
    ref[:, 8:20, 10:22] = 2.0
    region = np.zeros((n, side, side, 1), np.float32)
    region[0::2, 4:24, 6:26] = 1.0
    region[1::2, 6:22, 8:24] = 1.0
    return dict(x=x, y=y, nc_x=nc_x, nc_y=nc_y, ref=ref, c_ref=ref - 1, region=region,
                item=np.arange(n), w=np.ones(n, np.float32))


# (JAX step and port step, side, bands, batch): RSSS at batch 4, so that each
# split D pass normalizes its last 3 x 3 maps over as many samples (36) as
# the joint pass of test_torch_rsss.py, where JAX's float32 D gradient is
# accurate (ROADMAP.md C)
STEPS = {"usss_joint": (_usss, 32, 3, 2), "wsss_adversarial": (_wsss, 32, 3, 2),
         "rsss_adversarial": (_rsss, 40, 4, 4)}


@pytest.fixture(scope="module")
def vggp():
    return vgg16_random_params(0)


@pytest.mark.parametrize("step", list(STEPS))
def test_split_step_matches_jax(step, vggp):
    """One step with split S (and D) from the JAX weights: its losses, the
    running statistics of every net it runs in train mode, and the gradients
    of every net it steps."""
    build, side, nb, n = STEPS[step]
    batch = _batch(side, nb, 0, n)
    init, (want_m, want_stats, want_grads), port = build(vggp, batch)
    m, nets = port(batch)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, err_msg=k)
    runs = {}

    def rerun(seed):
        if seed not in runs:
            b = dict(batch, **_perturbed({k: batch[k] for k in ("x", "y", "nc_x", "nc_y")},
                                         seed))
            runs[seed] = port(b)[1]
        return runs[seed]

    for name, bs in want_stats.items():
        kind = KINDS[name]
        want = {k: v for k, v in jax_sd(init[name]["params"], bs, kind).items()
                if k.endswith(("running_mean", "running_var"))}
        check(stats_of(nets[name]), want, lambda seed: stats_of(rerun(seed)[name]), 0, 1e-5)
    for name, g in want_grads.items():
        want = jax_sd(g, init[name]["batch_stats"], KINDS[name])
        got = grads_of(nets[name])
        for k in set(want) - set(got):
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                np.testing.assert_array_equal(want[k], 0.0, err_msg=k)  # folded conv bias
        check(got, {k: want[k] for k in got}, lambda seed: grads_of(rerun(seed)[name]),
              2e-3, 2e-5)
    for name in set(nets) - set(want_stats):  # the frozen G runs in eval mode
        want = jax_sd(init[name]["params"], init[name]["batch_stats"], KINDS[name])
        for k, v in stats_of(nets[name]).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the serving tool
# ---------------------------------------------------------------------------


def test_whu_train_mode_split_matches_jax(tmp_path):
    """``--mode whu --bn-mode train --siamese-stats split`` against the JAX
    tool's split path (3 changed slices at batch 2), density images within
    one grey level, and different from the joint statistics' images."""
    from fcdgan_tpu.data.synthetic import make_whu_dataset
    from fcdgan_tpu.tools import infer as jax_infer
    from fcdgan_tpu_torch.data.raster import read_image
    from fcdgan_tpu_torch.tools import infer as port_infer

    side = 48
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    make_whu_dataset(jdir, n_changed=3, n_unchanged=1, size=side, seed=4)
    shutil.copytree(jdir, pdir)
    smodel = str(tmp_path / "SModel.pkl")
    seeded_smodel(smodel, 3, side)
    common = dict(mode="whu", smodel=smodel, bn_mode="train", batch_size=2,
                  compute_dtype="float32", prob_thresh=0.1, progress=False)
    jout = jax_infer.run(jax_infer.InferConfig(
        platform="cpu", outdir=str(tmp_path / "jax_split"), siamese_stats=SPLIT,
        **whu_dirs(jdir), **common))
    outs = {mode: port_infer.run(port_infer.InferConfig(
        device="cpu", outdir=str(tmp_path / f"port_{mode}"), siamese_stats=mode,
        **whu_dirs(pdir), **common)) for mode in ("joint", SPLIT)}
    names = sorted(os.listdir(jout["density_dir"]))
    assert len(names) == 3 and names == sorted(os.listdir(outs[SPLIT]["density_dir"]))
    moved = 0.0
    for name in names:
        want = read_image(os.path.join(jout["density_dir"], name))[..., 0] / 255.0
        got, joint = (read_image(os.path.join(outs[m]["density_dir"], name))[..., 0] / 255.0
                      for m in (SPLIT, "joint"))
        np.testing.assert_allclose(got, want, atol=1 / 255 + 1e-6)
        moved = max(moved, np.abs(got - joint).max())
    assert moved > 2 / 255  # the per-branch statistics change the densities
