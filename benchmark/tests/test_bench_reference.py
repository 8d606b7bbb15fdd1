"""The frozen reference (``benchmark/reference``) against the program at
small sizes on the CPU in float32: a USSS joint step, a WSSS adversarial
step and a stitched density; and the benchmark's isolation from JAX, the
JAX package, and (for the reference) the program."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import compare, synthetic
from benchmark.reference import models, serve, steps
from benchmark.weights import init_state

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
CFG = {"vgg_tap": 29, "msssim_weights": [0.5, 0.5], "perception_weight": 0.4,
       "l1_weight": 0.65, "ssim_weight": 0.0}
WSSS = {"vgg_tap": 29, "msssim_weights": [0.5, 0.5], "perception_weight": 0.5,
        "ssim_weight": 0.0, "g_weight": 0.2, "l1_weight": 1.6, "d_weight": 1.0,
        "nc_weight": 1.5}


def _pair(names, seed=7, c=3):
    """Reference nets and the program's, from one seeded state each."""
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor

    classes = {"G": Generator, "S": Segmentor, "D": Discriminator}
    ref = models.nets(names, c)
    state = {k: init_state(ref[k], seed, i, "cpu") for i, k in enumerate(names)}
    prog = {k: classes[k](c) for k in names}
    for k in names:
        ref[k].load_state_dict(state[k])
        prog[k].load_state_dict(state[k])
    return ref, prog


def _vggs():
    from fcdgan_tpu_torch.models.vgg import VGG16Weights

    params = models.vgg16_params(0)
    return models.VGG16(params, "cpu"), VGG16Weights(params, "cpu")


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def _grads(nets, names):
    return {f"{k}.{n}": p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
            for k in names for n, p in nets[k].named_parameters()}


def _params(nets, names):
    return {f"{k}.{n}": p.detach().clone() for k in names for n, p in nets[k].named_parameters()}


def _agree(prog, ref, names, before):
    rg, pg = _grads(ref, names), _grads(prog, names)
    keep = compare.kept_leaves(rg)
    assert _worst_norm_gap(pg, rg, keep) < 5e-3
    rc = compare.changes(_params(ref, names), before)
    pc = compare.changes(_params(prog, names), before)
    assert _worst_norm_gap(pc, rc, keep) < 2e-2


def _worst_norm_gap(prog, ref, keep):
    """The worst kept leaf's gap of norms over the larger of its reference
    norm and the median leaf's (a ReLU's mask flipped by rounding moves a
    leaf's direction more than its norm)."""
    norm = {k: (float(prog[k].norm()), float(ref[k].norm())) for k in keep}
    med = float(np.median([r for _, r in norm.values()]))
    return max(abs(p - r) / max(r, med) for p, r in norm.values())


def test_usss_joint_step_matches_the_program():
    from fcdgan_tpu_torch.train.optim import adam
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

    b, p, c, pad = 2, 48, 3, 4
    ref, prog = _pair(("G", "S"))
    rv, pv = _vggs()
    gen = torch.Generator().manual_seed(3)
    x, y = torch.randn(b, c, p, p, generator=gen), torch.randn(b, c, p, p, generator=gen)
    w = torch.ones(b)
    before = _params(ref, ("G", "S"))
    got = steps.usss_joint(ref["G"], ref["S"], steps.Adam(ref["G"].parameters()),
                           steps.Adam(ref["S"].parameters()), rv, CFG,
                           {"x": x, "y": y, "weight": w}, 1e-5)
    st = USSSSteps(prog["G"], prog["S"], adam(prog["G"].parameters()),
                   adam(prog["S"].parameters()), pv, PerceptionConfig((29,), True), 0.4, 0.65,
                   0.0, np.tile([[p - 2 * pad, p - 2 * pad]], (b, 1)), (pad, pad),
                   msssim_weights=(0.5, 0.5))
    m = st.joint(_nhwc(x), _nhwc(y), torch.ones(b, p, p, 1), torch.arange(b), w, 1e-5, 1e-5)
    for k in ("NetLoss", "ssim_loss"):
        assert float(m[k]) == pytest.approx(got[k], rel=1e-5)
    _agree(prog, ref, ("G", "S"), before)


def test_wsss_adversarial_step_matches_the_program():
    from fcdgan_tpu_torch.train.optim import adam, rmsprop
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, WSSSSteps

    b, p, c = 3, 48, 3
    ref, prog = _pair(("G", "S", "D"))
    rv, pv = _vggs()
    gen = torch.Generator().manual_seed(5)
    bt = {k: torch.randn(b, c, p, p, generator=gen) for k in ("c_x", "c_y", "nc_x", "nc_y")}
    bt["weight"] = torch.ones(b)
    before = _params(ref, ("S", "D"))
    got = steps.wsss_adversarial(ref["G"], ref["S"], ref["D"],
                                 steps.RMSprop(ref["S"].parameters()),
                                 steps.RMSprop(ref["D"].parameters()), rv, WSSS, bt, 1e-4, 1e-6)
    st = WSSSSteps(prog["G"], prog["S"], prog["D"], adam(prog["G"].parameters()),
                   rmsprop(prog["S"].parameters()), rmsprop(prog["D"].parameters()), pv,
                   PerceptionConfig((29,), False), 0.5, 0.0, 0.2, 1.6, 1.0, 1.5, 0.6,
                   msssim_weights=(0.5, 0.5))
    m = st.adversarial(_nhwc(bt["c_x"]), _nhwc(bt["c_y"]), torch.zeros(b, p, p, 1),
                       _nhwc(bt["nc_x"]), _nhwc(bt["nc_y"]), bt["weight"], 1e-4, 1e-6)
    for k in ("d_loss", "s_loss", "ssim_loss"):
        assert float(m[k]) == pytest.approx(got[k], rel=1e-5)
    _agree(prog, ref, ("S", "D"), before)


def test_stitched_density_matches_the_program(tmp_path):
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.eval.inference import stitched_inference

    x, y, _ = synthetic.scene_pair(torch.Generator().manual_seed(11), 70, 100, 3,
                                   [(10, 12, 20, 15)])
    t1, t2, out = (str(tmp_path / n) for n in ("T1.tif", "T2.tif", "d.tif"))
    synthetic.write_tiff(t1, x)
    synthetic.write_tiff(t2, y)
    stats = (str(tmp_path / "s1.txt"), str(tmp_path / "s2.txt"))
    scaler = Normalize(*dataset_meanstd(*stats, ScenePairDataset(
        t1, t2, patch_size=(48, 48), overlap_padding=(0, 0))))
    ref, prog = _pair(("S",))
    ref["S"].load_state_dict(init_state(ref["S"], 9, 0, "cpu", "he_uniform"))
    prog["S"].load_state_dict(ref["S"].state_dict())
    ds = ScenePairDataset(t1, t2, out_path=out, enhance=scaler, patch_size=(48, 48),
                          overlap_padding=(4, 4))
    stitched_inference(ds, prog["S"].eval(), 4, "cpu")
    got = synthetic.read_tiff(out)[..., 0]
    want = serve.density(ref["S"], x, y, 48, 4, "cpu")
    assert got.shape == want.shape == (70, 100)
    assert compare.density_gap(got, want) < 1e-5
    assert want.std() > 0.05  # the seeded network's density varies over the scene


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(d):
    for base, _, files in os.walk(d):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "fcdgan_tpu"), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        for name in _imports(path):
            assert name.split(".")[0] != "fcdgan_tpu_torch", path
    code = ("import sys, benchmark.reference.models, benchmark.reference.losses, "
            "benchmark.reference.steps, benchmark.reference.train, benchmark.reference.serve, "
            "benchmark.reference.data\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'fcdgan_tpu_torch']")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_a_run_loads_no_jax():
    """A whole small run of the serving cell on the CPU, then ``sys.modules``
    compared by whole top-level names."""
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import run, control, harness\n"
        "import benchmark.traffic.train_loop, benchmark.traffic.serve_closed_loop\n"
        "b = harness.spec()\n"
        "[harness.metric_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "ov = {'scenes': [[64, 64]], 'profile_scenes': 1, 'config': {'patch': 48, 'pad': 4}}\n"
        "res = run.run_cell('usss-serve.scenes8', 5, 0.2, True, 'cpu', overrides=ov,"
        " t0=time.perf_counter())\n"
        "assert 'checks' in res\n"
        "bad = run.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'fcdgan_tpu_torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=600)
