"""The CUDA-graph path of the USSS joint step and the WSSS adversarial
step, on the CPU: the tensor learning rate that ``set_lr`` fills
(``train/optim.py``), which optimizers a graph can hold (``capturable``),
how one is made capturable and saved (``make_capturable``,
``state_dict``), the reasons a step stays eager
(``USSSSteps.eager_because``, ``WSSSSteps.eager_because``), the recorder's
step counters, the steps' lack of reference cycles and the out-of-memory
test of a failed capture.
The graphs themselves run only on a card (``tests/test_torch_cuda.py``,
marker ``cuda``). Imports no JAX."""

import gc
import weakref

import numpy as np
import pytest
import torch

from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
from fcdgan_tpu_torch.parallel import mesh
from fcdgan_tpu_torch.io.checkpoint import TrainCheckpointer
from fcdgan_tpu_torch.ops import ssim as ssim_mod
from fcdgan_tpu_torch.train import optim
from fcdgan_tpu_torch.train.optim import capturable, make_capturable, set_lr
from fcdgan_tpu_torch.train.steps import (PerceptionConfig, USSSSteps, WSSSSteps,
                                          _out_of_memory)
from fcdgan_tpu_torch.utils.timing import recording

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LRS = [1e-3, 1e-3, 5e-4, 5e-4, 2e-4]
HW, PAD = 32, (4, 4)


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(shape, generator=g))
            for shape in ((8, 4, 3, 3), (8,), (1, 8, 1, 1))]


def _grads(step, params):
    g = torch.Generator().manual_seed(100 + step)
    return [torch.randn(p.shape, generator=g) for p in params]


def test_set_lr_fills_a_tensor_rate_in_place_and_assigns_a_float():
    ps = _params()
    tensor_opt = torch.optim.Adam(ps, lr=torch.tensor(0.0), foreach=False)
    float_opt = torch.optim.Adam(_params(), lr=0.0)
    rate = tensor_opt.param_groups[0]["lr"]
    set_lr(tensor_opt, 1e-3)
    set_lr(float_opt, 1e-3)
    assert tensor_opt.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(1e-3)
    assert isinstance(float_opt.param_groups[0]["lr"], float)
    assert float_opt.param_groups[0]["lr"] == 1e-3 and "lr_value" not in float_opt.param_groups[0]
    version = rate._version
    set_lr(tensor_opt, 1e-3)  # the same rate: nothing written, nothing launched
    assert rate._version == version
    set_lr(tensor_opt, 2e-4)
    assert rate._version == version + 1 and float(rate) == pytest.approx(2e-4)
    assert tensor_opt.param_groups[0]["lr_value"] == 2e-4


def _changed_rate_runs(make):
    """``make(params, rate)``'s optimizer stepped over ``LRS`` with a tensor
    rate and with a float rate, and with a float rate kept at the first: the
    parameters after every step of each run."""
    runs = {}
    for name, rate, lrs in (("tensor", torch.tensor(0.0), LRS), ("float", 0.0, LRS),
                            ("kept", 0.0, [LRS[0]] * len(LRS))):
        ps = _params()
        opt = make(ps, rate)
        runs[name] = []
        for step, lr in enumerate(lrs):
            for p, g in zip(ps, _grads(step, ps)):
                p.grad = g
            set_lr(opt, lr)
            opt.step()
            runs[name].append([p.detach().clone() for p in ps])
    return runs


def _assert_the_rate_moved(runs):
    """The tensor-rate run's parameters are the float-rate run's after every
    step, within f32 rounding, and those of the kept-rate run only until the
    rate changes."""
    for step, (t, f, k) in enumerate(zip(runs["tensor"], runs["float"], runs["kept"])):
        for a, b in zip(t, f):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        changed = step >= LRS.index(LRS[2])  # the first step at the second rate
        assert changed != all(torch.allclose(a, c, rtol=1e-6, atol=1e-7)
                              for a, c in zip(t, k)), step


def test_a_changed_tensor_rate_takes_effect_on_the_next_step():
    """Adam with a tensor rate (torch's single-tensor Adam: its capturable
    form wants CUDA parameters) against Adam with a float rate, the rate
    changed between steps: the same parameters after every step, within
    f32 rounding (rtol 1e-6: the tensor rate divides as a tensor), and not
    those of a run whose rate stayed at the first."""
    _assert_the_rate_moved(_changed_rate_runs(
        lambda ps, rate: torch.optim.Adam(ps, lr=rate, betas=optim.BETAS, eps=optim.EPS,
                                          foreach=False)))


@pytest.mark.parametrize("foreach", [False, True])
def test_set_lr_moves_an_rmsprops_tensor_rate(foreach):
    """RMSprop as ``build`` makes it, with a tensor rate: ``set_lr`` fills
    the rate in place (the same tensor, one write a change), and the changed
    rate takes effect on the next step, single-tensor and multi-tensor (the
    card's form) alike, as with a float rate."""
    def make(ps, rate):
        return torch.optim.RMSprop(ps, lr=rate, alpha=optim.RMS_ALPHA, eps=optim.EPS,
                                   foreach=foreach)

    opt = make(_params(), torch.tensor(0.0))
    rate = opt.param_groups[0]["lr"]
    set_lr(opt, LRS[0])
    version = rate._version
    set_lr(opt, LRS[0])
    set_lr(opt, LRS[2])
    assert opt.param_groups[0]["lr"] is rate and rate._version == version + 1
    assert float(rate) == pytest.approx(LRS[2])
    _assert_the_rate_moved(_changed_rate_runs(make))


def test_the_cpu_adam_keeps_a_float_rate():
    """``build`` makes the plain Adam, and a CPU joint step leaves it so."""
    opt = optim.build(_params(), "adam", "leaf")
    assert isinstance(opt.param_groups[0]["lr"], float)
    assert not opt.param_groups[0]["capturable"] and capturable(opt)
    st = _steps()
    st.joint(*_batch(2, 0), 1e-3, 1e-3)
    for o in (st.opt_g, st.opt_s):
        assert all(isinstance(g["lr"], float) and not g["capturable"] for g in o.param_groups)


@pytest.mark.parametrize("kind,want", [
    ("capturable adam", True), ("float rate", True), ("flat", False), ("grouped", False),
    ("rmsprop", True), ("rate on another device", True), ("capturable rmsprop", True),
    ("flat rmsprop", False), ("grouped rmsprop", False), ("fused rmsprop", False)])
def test_capturable_names_the_optimizers_a_graph_can_hold(kind, want, monkeypatch):
    """A leaf Adam or RMSprop can be made capturable whatever its rate is
    now (``make_capturable`` moves the rate onto the parameters' device); a
    layout optimizer cannot, ``FCDGAN_FUSED_OPT=1``'s flat one included."""
    ps = _params()
    if kind == "fused rmsprop":
        monkeypatch.delenv("FCDGAN_OPT", raising=False)
        monkeypatch.setenv("FCDGAN_FUSED_OPT", "1")
        opt = optim.rmsprop(ps)
    elif kind == "capturable rmsprop":
        opt = torch.optim.RMSprop(ps, lr=torch.tensor(0.0), capturable=True)
    elif kind in ("flat rmsprop", "grouped rmsprop"):
        opt = optim.build(ps, "rmsprop", kind.split()[0])
    elif kind == "capturable adam":
        opt = torch.optim.Adam(ps, lr=torch.tensor(0.0), capturable=True)
    elif kind == "float rate":
        opt = torch.optim.Adam(ps, lr=0.0)
    elif kind == "rate on another device":
        opt = torch.optim.Adam(ps, lr=torch.tensor(0.0), capturable=True)
        opt.param_groups[0]["lr"] = torch.tensor(3e-4, device="meta")
    elif kind == "rmsprop":
        opt = optim.build(ps, "rmsprop", "leaf")
    else:
        opt = optim.build(ps, "adam", kind)
    assert capturable(opt) is want
    if want and kind != "rate on another device":
        make_capturable(opt)
        rate = opt.param_groups[0]["lr"]
        assert isinstance(rate, torch.Tensor) and rate.device == ps[0].device


def _stepped(n_steps, seed=0, algorithm="adam"):
    """A plain leaf ``algorithm`` (adam or rmsprop) over fresh parameters
    after ``n_steps`` steps."""
    ps = _params(seed)
    opt = optim.build(ps, algorithm, "leaf")
    for step in range(n_steps):
        for p, g in zip(ps, _grads(step, ps)):
            p.grad = g
        set_lr(opt, LRS[step])
        opt.step()
    return ps, opt


@pytest.mark.parametrize("algorithm,n_steps", [
    pytest.param("adam", 0, id="0"), pytest.param("adam", 2, id="2"),
    ("rmsprop", 0), ("rmsprop", 2), ("rmsprop", "loaded")])
def test_make_capturable_turns_a_leaf_adam_in_place(algorithm, n_steps):
    """Each group of a leaf Adam or RMSprop capturable, its rate a 0-d
    float32 tensor holding the rate it had (and ``lr_value``), each step
    count on the parameters' device; a second call changes nothing, and
    ``set_lr`` then fills the rate. ``loaded``: an RMSprop ``build`` made,
    loaded from the plain state of two steps (its step counts on the host),
    keeps its moments."""
    loaded, moments = n_steps == "loaded", None
    n_steps = 2 if loaded else n_steps
    ps, opt = _stepped(n_steps, algorithm=algorithm)
    if loaded:
        sd = optim.state_dict(opt)
        ps = [torch.nn.Parameter(p.detach().clone()) for p in ps]
        opt = optim.build(ps, algorithm, "leaf")
        opt.load_state_dict(sd)
        assert not opt.param_groups[0]["capturable"]
        moments = [opt.state[p]["square_avg"] for p in ps]
    before = opt.param_groups[0]["lr"]
    make_capturable(opt)
    group = opt.param_groups[0]
    rate = group["lr"]
    assert group["capturable"] and rate.shape == () and rate.dtype == torch.float32
    assert float(rate) == pytest.approx(before) and group["lr_value"] == before
    steps = [opt.state[p]["step"] for p in ps if p in opt.state]
    assert len(steps) == (len(ps) if n_steps else 0)
    assert all(t.device == p.device and float(t) == n_steps for t, p in zip(steps, ps))
    make_capturable(opt)
    assert opt.param_groups[0]["lr"] is rate
    assert all(opt.state[p]["step"] is t for t, p in zip(steps, ps))
    set_lr(opt, 7e-4)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(7e-4)
    if moments is not None:
        assert all(opt.state[p]["square_avg"] is m for p, m in zip(ps, moments))


@pytest.mark.parametrize("algorithm,via", [
    pytest.param("adam", "state_dict", id="state_dict"),
    pytest.param("adam", "checkpoint", id="checkpoint"),
    ("rmsprop", "state_dict"), ("rmsprop", "checkpoint")])
def test_a_capturable_adams_state_loads_as_the_plain_one(algorithm, via, tmp_path):
    """``optim.state_dict`` (and so ``TrainCheckpointer``) saves a capturable
    Adam or RMSprop as the plain one: a float rate, ``capturable`` off, no
    ``lr_value``. It loads into the optimizer ``build`` makes on the CPU,
    whose next step equals that of one that was never made capturable."""
    ps, opt = _stepped(2, algorithm=algorithm)
    twin_ps, twin = _stepped(2, algorithm=algorithm)
    make_capturable(opt)
    set_lr(opt, LRS[2])
    net = torch.nn.Module()
    if via == "state_dict":
        sd = optim.state_dict(opt)
    else:
        ck = TrainCheckpointer(str(tmp_path / "ck"), every=1)
        assert ck.maybe_save("joint", 0, net=(net, opt))
    assert opt.param_groups[0]["capturable"]  # the optimizer itself is left as it was
    loaded_ps = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    loaded = optim.build(loaded_ps, algorithm, "leaf")
    if via == "state_dict":
        loaded.load_state_dict(sd)
    else:
        ck.restore({"net": (net, loaded)})
    group = loaded.param_groups[0]
    assert isinstance(group["lr"], float) and group["lr"] == LRS[2]
    assert not group["capturable"] and "lr_value" not in group
    set_lr(twin, LRS[2])
    for p, q, g in zip(loaded_ps, twin_ps, _grads(2, ps)):
        p.grad, q.grad = g, g.clone()
    loaded.step()
    twin.step()
    for p, q in zip(loaded_ps, twin_ps):
        assert torch.equal(p, q)


def _steps(layout="leaf", remat=False):
    torch.manual_seed(0)
    g, s = Generator(3), Segmentor(3)
    opts = [optim.build(n.parameters(), "adam", layout) for n in (g, s)]
    return USSSSteps(g, s, *opts, VGG16Weights(vgg16_random_params(0), "cpu"),
                     PerceptionConfig((3,), True), 0.4, 0.65, 0.0,
                     np.array([[HW - 8, HW - 8]] * 4, np.int32), PAD,
                     msssim_weights=(0.5, 0.5), remat=remat)


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, HW, HW, 3)).astype(np.float32))
    y = x * 0.9 + 0.1
    return x, y, torch.ones(b, HW, HW, 1), torch.arange(b) % 4, torch.ones(b)


@pytest.mark.parametrize("case,reason", [
    ("graph", None), ("remat", "remat"),
    ("flat", "an optimizer step that cannot be captured"),
    ("grouped", "an optimizer step that cannot be captured"),
    ("process group", "a process group"), ("anomaly", "anomaly detection")])
def test_eager_because_names_each_fallback(case, reason, monkeypatch):
    """On a CUDA device the joint step is graphed unless remat, a layout
    optimizer, a process group or anomaly detection keeps it eager; the
    device is only named here, nothing runs on it."""
    cuda = torch.device("cuda", 0)
    st = _steps(layout=case if case in ("flat", "grouped") else "leaf",
                remat=case == "remat")
    assert st.eager_because(torch.device("cpu")) == "not a CUDA device"
    if case == "process group":
        monkeypatch.setattr(mesh, "active", lambda: True)
    with torch.autograd.set_detect_anomaly(case == "anomaly"):
        assert st.eager_because(cuda) == reason


@pytest.mark.parametrize("layout,remat", [("leaf", False), ("leaf", True), ("flat", False),
                                          ("grouped", False)])
def test_a_cpu_joint_step_counts_eager_steps_only(layout, remat):
    """On the CPU every joint call is an eager step, in every layout and
    with remat, whatever the batch's shape; the same results as the eager
    step body called directly."""
    st, twin = _steps(layout, remat), _steps(layout, remat)
    with recording() as rec:
        got = [st.joint(*_batch(b, i), lr, lr) for i, (b, lr) in
               enumerate(zip((2, 2, 1), LRS))]
    assert rec.counters.get("step.eager") == 3
    assert not any(k.startswith("step.graph") for k in rec.counters)
    for i, (b, lr) in enumerate(zip((2, 2, 1), LRS)):
        set_lr(twin.opt_g, lr)
        set_lr(twin.opt_s, lr)
        want = twin._joint(*_batch(b, i))
        assert all(torch.equal(got[i][k], want[k]) for k in want), i
    for p, q in zip(st.S.parameters(), twin.S.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("remat", [False, True])
def test_the_steps_hold_no_reference_cycle(remat):
    """With the cyclic collector off, dropping the steps after a joint step
    frees them at once: nothing in them refers back to them, so the graphs
    of a card's steps, and their memory pool, go with them."""
    st = _steps(remat=remat)
    st.joint(*_batch(2, 0), 1e-3, 1e-3)
    gone = weakref.ref(st)
    gc.disable()
    try:
        del st
        assert gone() is None
    finally:
        gc.enable()


def _raised(outer, inner=None):
    try:
        try:
            if inner is not None:
                raise inner
        finally:
            raise outer
    except Exception as e:
        return e


@pytest.mark.parametrize("case,want", [
    ("an allocation failed inside the capture",
     _raised(RuntimeError("CUDA error: operation failed due to a previous error during "
                          "capture"), torch.cuda.OutOfMemoryError("CUDA out of memory"))),
    ("the graph could not be instantiated",
     _raised(RuntimeError("CUDA error: out of memory"))),
    ("another fault", _raised(RuntimeError("CUDA error: an illegal memory access"),
                              ValueError("a shape")))])
def test_a_capture_cut_short_by_memory_is_told_apart(case, want):
    """``_out_of_memory``: an OutOfMemoryError anywhere in the chain, or a
    CUDA error that says out of memory, is the device's memory; any other
    fault is raised as it came."""
    assert _out_of_memory(want) is (case != "another fault")


def test_the_ssim_constants_are_made_once_a_device():
    """The Gaussian window and the level weights a step reads are one tensor
    per key for good, with the values they had when made fresh."""
    win = ssim_mod._window(11, 1.5, torch.device("cpu"))
    assert ssim_mod._window(11, 1.5, torch.device("cpu")) is win
    assert torch.equal(win, torch.from_numpy(ssim_mod.gaussian_window(11, 1.5)))
    w = ssim_mod._level_weights((0.5, 0.5), torch.float32, torch.device("cpu"))
    assert ssim_mod._level_weights((0.5, 0.5), torch.float32, torch.device("cpu")) is w
    assert w.tolist() == [0.5, 0.5]


# -- the WSSS adversarial step ---------------------------------------------------
def _wsss_steps(layout="leaf", remat=False, siamese_stats="joint", continuous=True):
    torch.manual_seed(0)
    g, s = Generator(3), Segmentor(3, siamese_stats=siamese_stats)
    d = Discriminator(3, siamese_stats=siamese_stats)
    return WSSSSteps(g, s, d, optim.build(g.parameters(), "adam", layout),
                     optim.build(s.parameters(), "rmsprop", layout),
                     optim.build(d.parameters(), "rmsprop", layout),
                     VGG16Weights(vgg16_random_params(0), "cpu"),
                     PerceptionConfig((3,), False), 0.5, 0.0, 0.2, 1.6, 1.0, 1.5, 0.6,
                     discriminator_continuous=continuous, msssim_weights=(0.5, 0.5),
                     remat=remat)


def _pairs(b, seed):
    """(c_x, c_y, c_ref, nc_x, nc_y, w) of ``b`` changed and unchanged pairs."""
    rng = np.random.default_rng(seed)
    c_x, nc_x = (torch.from_numpy(rng.normal(size=(b, HW, HW, 3)).astype(np.float32))
                 for _ in range(2))
    c_ref = torch.from_numpy((rng.random((b, HW, HW, 1)) > 0.7).astype(np.float32))
    return c_x, c_x * 0.8 + 0.2 * c_ref, c_ref, nc_x, nc_x * 0.9 + 0.1, torch.ones(b)


@pytest.mark.parametrize("case,reason", [
    ("graph", None), ("split", None), ("hard mask", None), ("remat", "remat"),
    ("flat", "an optimizer step that cannot be captured"),
    ("grouped", "an optimizer step that cannot be captured"),
    ("process group", "a process group"), ("anomaly", "anomaly detection")])
def test_wsss_eager_because_names_each_fallback(case, reason, monkeypatch):
    """On a CUDA device the adversarial step is graphed unless remat, a
    layout optimizer, a process group or anomaly detection keeps it eager;
    per-branch BN statistics (``--siamese-stats split``) and D's hard mask
    are graphed. The device is only named here, nothing runs on it."""
    cuda = torch.device("cuda", 0)
    st = _wsss_steps(layout=case if case in ("flat", "grouped") else "leaf",
                     remat=case == "remat",
                     siamese_stats="split" if case == "split" else "joint",
                     continuous=case != "hard mask")
    assert st.eager_because(torch.device("cpu")) == "not a CUDA device"
    if case == "process group":
        monkeypatch.setattr(mesh, "active", lambda: True)
    with torch.autograd.set_detect_anomaly(case == "anomaly"):
        assert st.eager_because(cuda) == reason


@pytest.mark.parametrize("layout,remat", [("leaf", False), ("leaf", True), ("grouped", False)])
def test_a_cpu_adversarial_step_counts_eager_steps_only(layout, remat):
    """On the CPU every adversarial call is an eager step, in every layout
    and with remat, whatever the batch's shape, and both RMSprops keep their
    float rates; the same results as the eager step body called directly
    after the modes (G eval, S and D train) and the rates are set."""
    st, twin = _wsss_steps(layout, remat), _wsss_steps(layout, remat)
    calls = list(zip((2, 2, 1), LRS))
    with recording() as rec:
        got = [st.adversarial(*_pairs(b, i), lr, lr / 10) for i, (b, lr) in enumerate(calls)]
    assert rec.counters.get("step.eager") == 3
    assert not any(k.startswith("step.graph") for k in rec.counters)
    twin.G.eval()
    for i, (b, lr) in enumerate(calls):
        set_lr(twin.opt_s, lr)
        set_lr(twin.opt_d, lr / 10)
        want = twin._adversarial(*_pairs(b, i))
        assert all(torch.equal(got[i][k], want[k]) for k in want), i
    for net, other in ((st.S, twin.S), (st.D, twin.D)):
        for p, q in zip(net.parameters(), other.parameters()):
            assert torch.equal(p, q)
    assert all(isinstance(g["lr"], float) and not g.get("capturable")
               for opt in (st.opt_s, st.opt_d) for g in opt.param_groups)


@pytest.mark.parametrize("remat", [False, True])
def test_the_wsss_steps_hold_no_reference_cycle(remat):
    """With the cyclic collector off, dropping the WSSS steps after an
    adversarial step frees them at once, so on a card their graphs and the
    graphs' memory pool go with them."""
    st = _wsss_steps(remat=remat)
    st.adversarial(*_pairs(2, 0), 1e-3, 1e-4)
    gone = weakref.ref(st)
    gc.disable()
    try:
        del st
        assert gone() is None
    finally:
        gc.enable()
