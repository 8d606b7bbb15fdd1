"""The optimizer layouts of the port (``train/optim.py``): leaf, flat and
grouped Adam and RMSprop against the JAX layouts of the same name
(``fcdgan_tpu.train.optim``) and against the port's leaf optimizers, over
several steps with changing learning rates on a ragged parameter tree shaped
like ``tests/test_optim_fused.py``'s (its HWIO kernels moved to OIHW).

Bounds: the port's flat and grouped layouts against its leaf, and every port
layout against the JAX layout of the same name, rtol 1e-6 / atol 1e-7 (the
bound of ``test_optim_fused.py``): each layout computes torch's update
element for element, and the JAX one multiplies its unit-LR update by the
rate, one rounding apart."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fcdgan_tpu.train import optim as joptim
from fcdgan_tpu_torch.io.checkpoint import TrainCheckpointer
from fcdgan_tpu_torch.train import optim
from fcdgan_tpu_torch.train.optim import LayoutOptimizer, adam, rmsprop, set_lr

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LRS = [2e-4, 2e-4, 1e-4, 1e-4, 5e-5, 5e-5]
RTOL, ATOL = 1e-6, 1e-7
# (name, JAX shape, port shape): conv kernels HWIO -> OIHW
TREE = [("conv1.kernel", (3, 3, 16, 32), (32, 16, 3, 3)), ("conv1.bias", (32,), (32,)),
        ("bn.scale", (32,), (32,)), ("bn.bias", (32,), (32,)),
        ("head.kernel", (1, 1, 32, 1), (1, 32, 1, 1))]


def _to_port(name, a):
    return np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a


def _draws(seed, steps=len(LRS)):
    """JAX-layout parameters and ``steps`` gradient trees, numpy, seeded."""
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=s).astype(np.float32) for n, s, _ in TREE}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s, _ in TREE}
             for _ in range(steps)]
    return params, grads


def _jax_run(tx, params, grads, lrs=LRS):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    opt = jax.jit(tx.init)(p)
    step = jax.jit(lambda p, o, g, lr: joptim.apply_updates(p, o, g, tx, lr))
    for g, lr in zip(grads, lrs):
        p, opt = step(p, opt, {k: jnp.asarray(v) for k, v in g.items()}, lr)
    return {k: _to_port(k, np.asarray(v)) for k, v in p.items()}


def _port_params(params):
    return [torch.nn.Parameter(torch.from_numpy(_to_port(n, params[n]).copy()))
            for n, _, _ in TREE]


def _port_step(opt, ps, g, lr):
    for p, (n, _, _) in zip(ps, TREE):
        p.grad = None if g is None else torch.from_numpy(_to_port(n, g[n]).copy())
    set_lr(opt, lr)
    opt.step()


def _port_run(make, params, grads, lrs=LRS):
    ps = _port_params(params)
    opt = make(ps)
    for g, lr in zip(grads, lrs):
        _port_step(opt, ps, g, lr)
    return {n: p.detach().numpy() for p, (n, _, _) in zip(ps, TREE)}


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def _jax_leaf(algorithm):
    if algorithm == "adam":
        return optax.chain(optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8, eps_root=0.0),
                           optax.scale(-1.0))
    return optax.chain(joptim._scale_by_torch_rms(0.99, 1e-8), optax.scale(-1.0))


def _jax_layout(algorithm, layout, small):
    if layout == "leaf":
        return _jax_leaf(algorithm)
    if layout == "flat":
        return (joptim._flat_adam(0.9, 0.99, 1e-8) if algorithm == "adam"
                else joptim._flat_rmsprop(0.99, 1e-8))
    return (joptim._grouped_adam(0.9, 0.99, 1e-8, small_elems=small) if algorithm == "adam"
            else joptim._grouped_rmsprop(0.99, 1e-8, small_elems=small))


def _port_layout(algorithm, layout, small):
    if layout == "leaf":
        return lambda ps: optim.build(ps, algorithm, "leaf")
    return lambda ps: LayoutOptimizer(ps, algorithm, None if layout == "flat" else small)


# small=64: the 4608-element kernel keeps its own moments, the 32-element
# leaves share the flat vector; GROUP_SMALL (the default) groups every leaf
@pytest.mark.parametrize("algorithm", ["adam", "rmsprop"])
@pytest.mark.parametrize("layout,small", [("leaf", None), ("flat", None), ("grouped", 64),
                                          ("grouped", optim.GROUP_SMALL)],
                         ids=["leaf", "flat", "grouped64", "grouped_default"])
def test_layout_matches_the_jax_layout_of_the_same_name(algorithm, layout, small):
    params, grads = _draws(0)
    _close(_port_run(_port_layout(algorithm, layout, small), params, grads),
           _jax_run(_jax_layout(algorithm, layout, small), params, grads))


@pytest.mark.parametrize("algorithm", ["adam", "rmsprop"])
@pytest.mark.parametrize("small", [None, 64, 0, 1 << 30],
                         ids=["flat", "grouped64", "all_big", "all_small"])
def test_flat_and_grouped_match_the_ports_leaf(algorithm, small):
    """The flat layout, the grouped one at a split threshold, and the
    degenerate groupings (every parameter big, every parameter small)."""
    params, grads = _draws(1)
    _close(_port_run(lambda ps: LayoutOptimizer(ps, algorithm, small), params, grads),
           _port_run(lambda ps: optim.build(ps, algorithm, "leaf"), params, grads))


@pytest.mark.parametrize("algorithm", ["adam", "rmsprop"])
def test_a_parameter_without_gradient_stays_put(algorithm):
    """The conv bias a train-mode BN folds away never has a gradient: torch's
    optimizers skip it, the layouts step it with a zero gradient, and it does
    not move in either."""
    params, grads = _draws(2)
    for g in grads:
        g["conv1.bias"] = None
    runs = {}
    for name, make in (("leaf", lambda ps: optim.build(ps, algorithm, "leaf")),
                       ("flat", lambda ps: LayoutOptimizer(ps, algorithm)),
                       ("grouped", lambda ps: LayoutOptimizer(ps, algorithm, 64))):
        ps = _port_params(params)
        opt = make(ps)
        for g, lr in zip(grads, LRS):
            for p, (n, _, _) in zip(ps, TREE):
                p.grad = None if g[n] is None else torch.from_numpy(_to_port(n, g[n]).copy())
            set_lr(opt, lr)
            opt.step()
        runs[name] = {n: p.detach().numpy() for p, (n, _, _) in zip(ps, TREE)}
    np.testing.assert_array_equal(runs["flat"]["conv1.bias"], params["conv1.bias"])
    _close(runs["flat"], runs["leaf"])
    _close(runs["grouped"], runs["leaf"])


def test_the_environment_selects_the_layout(monkeypatch):
    ps = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(1 << 16))]
    monkeypatch.delenv("FCDGAN_OPT", raising=False)
    monkeypatch.delenv("FCDGAN_FUSED_OPT", raising=False)
    assert type(adam(ps)) is torch.optim.Adam and type(rmsprop(ps)) is torch.optim.RMSprop
    monkeypatch.setenv("FCDGAN_FUSED_OPT", "1")
    for opt in (adam(ps), rmsprop(ps)):
        assert isinstance(opt, LayoutOptimizer) and opt.small_elems is None
    assert (adam(ps).algorithm, rmsprop(ps).algorithm) == ("adam", "rmsprop")
    monkeypatch.setenv("FCDGAN_OPT", "grouped")  # FCDGAN_OPT wins over FCDGAN_FUSED_OPT
    for opt in (adam(ps), rmsprop(ps)):
        assert isinstance(opt, LayoutOptimizer) and opt.small_elems == optim.GROUP_SMALL
    monkeypatch.setenv("FCDGAN_OPT", "leaf")
    assert type(adam(ps)) is torch.optim.Adam
    monkeypatch.setenv("FCDGAN_OPT", "fused")
    with pytest.raises(ValueError, match="FCDGAN_OPT"):
        adam(ps)


@pytest.mark.parametrize("algorithm", ["adam", "rmsprop"])
@pytest.mark.parametrize("layout", ["leaf", "flat", "grouped"])
def test_state_round_trips_through_a_checkpoint(algorithm, layout, tmp_path, monkeypatch):
    """Three steps, a ``TrainCheckpointer`` save, a restore into fresh
    parameters and a fresh optimizer of the same layout, three more steps:
    bit-equal to six uninterrupted steps. Another layout refuses the state."""
    monkeypatch.setenv("FCDGAN_OPT", layout)
    make = adam if algorithm == "adam" else rmsprop
    params, grads = _draws(3)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ps = torch.nn.ParameterList(_port_params(params))

    whole = Net()
    opt = make(whole.parameters())
    for g, lr in zip(grads, LRS):
        _port_step(opt, list(whole.ps), g, lr)

    first = Net()
    opt1 = make(first.parameters())
    for g, lr in zip(grads[:3], LRS[:3]):
        _port_step(opt1, list(first.ps), g, lr)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), every=1)
    assert ckpt.maybe_save("joint", 0, net=(first, opt1))
    resumed = Net()
    opt2 = make(resumed.parameters())
    assert ckpt.restore({"net": (resumed, opt2)}) == {"phase": "joint", "epoch": 0}
    for g, lr in zip(grads[3:], LRS[3:]):
        _port_step(opt2, list(resumed.ps), g, lr)
    for a, b in zip(resumed.parameters(), whole.parameters()):
        assert torch.equal(a, b)
    other = "grouped" if layout == "flat" else "flat"
    saved = torch.load(str(tmp_path / "ck" / "net.pt"), weights_only=True)["optimizer"]
    with pytest.raises(ValueError, match="cannot be loaded"):
        optim.build(Net().parameters(), algorithm, other).load_state_dict(saved)


def test_a_usss_joint_step_in_each_layout():
    """One USSS joint step of the full-width nets (32 px, 2 tiles) from the
    same weights in each layout: G's and S's parameters after the step, flat
    and grouped against leaf, within the bound above."""
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    y = x * 0.9 + 0.1
    ref = torch.ones(2, 32, 32, 1)
    vgg = VGG16Weights(vgg16_random_params(), "cpu")
    torch.manual_seed(0)
    init_g, init_s = Generator(3).state_dict(), Segmentor(3).state_dict()
    after = {}
    for layout in ("leaf", "flat", "grouped"):
        g, s = Generator(3), Segmentor(3)
        g.load_state_dict(init_g)
        s.load_state_dict(init_s)
        steps = USSSSteps(g, s, optim.build(g.parameters(), "adam", layout),
                          optim.build(s.parameters(), "adam", layout),
                          vgg, PerceptionConfig((29,), True), 0.4, 0.65, 0.0,
                          np.array([[24, 24]] * 2), (4, 4), msssim_weights=(0.5, 0.5))
        m = steps.joint(x, y, ref, torch.arange(2), torch.ones(2), 1e-4, 1e-4)
        assert np.isfinite(float(m["NetLoss"]))
        after[layout] = {f"{net}.{k}": v.detach().numpy().copy()
                         for net, mod in (("g", g), ("s", s))
                         for k, v in mod.named_parameters()}
    _close(after["flat"], after["leaf"])
    _close(after["grouped"], after["leaf"])
    moved = [k for k in after["leaf"] if not np.array_equal(
        after["leaf"][k], (init_g if k[0] == "g" else init_s)[k[2:]].numpy())]
    assert len(moved) > len(after["leaf"]) // 2
