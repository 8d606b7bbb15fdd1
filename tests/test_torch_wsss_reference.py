"""The WSSS adversarial step against the benchmark's plain float32 reference
(``benchmark/reference``), from a state the program held, on the CPU at a
small size (32 px slices, batch 2, two MS-SSIM scales, float32); the
``wchange_gap`` and ``<net>_descent_gap`` numbers that check it in the
benchmark; the step's spans;
and the work counts of the slice pass."""

import statistics

import pytest
import torch

from benchmark import compare, compare_steps, work, work_slices
from benchmark.reference import from_state, models
from benchmark.weights import init_state
from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights
from fcdgan_tpu_torch.train.optim import adam, rmsprop
from fcdgan_tpu_torch.train.steps import PerceptionConfig, WSSSSteps
from fcdgan_tpu_torch.utils.timing import recording

from torch_threads import one_torch_thread  # noqa: F401

B, P, C = 2, 32, 3
CFG = {"bands": C, "vgg_tap": 29, "msssim_weights": [0.5, 0.5], "perception_weight": 0.5,
       "ssim_weight": 0.0, "g_weight": 0.2, "l1_weight": 1.6, "d_weight": 1.0,
       "nc_weight": 1.5, "schedules": {
           "s_adversarial": {"lr_start": 1e-4, "lr_max": 1e-3, "lr_min": 1e-6,
                             "warmup_epochs": 5, "sustain_epochs": 0, "exp_decay": 0.8},
           "d_adversarial": {"lr_start": 1e-6, "lr_max": 1e-5, "lr_min": 1e-8,
                             "warmup_epochs": 5, "sustain_epochs": 0, "exp_decay": 0.8}}}
LR_S, LR_D = 1e-4, 1e-6  # the schedules at epoch 0
PHASES = ["adv.s_forward", "adv.d_update", "adv.s_loss", "adv.s_backward", "adv.s_optimizer"]


class Batches:
    """The reference's batch maker over fixed NHWC batches, one a row id."""

    def __init__(self, batches):
        self.batches = batches

    def batch(self, rows, device):
        b = self.batches[int(rows["id"])]
        return {k: (v.permute(0, 3, 1, 2).contiguous() if v.dim() == 4 else v).to(device)
                for k, v in b.items() if k != "c_ref"}


def _batch(seed):
    gen = torch.Generator().manual_seed(seed)
    b = {k: torch.randn(B, P, P, C, generator=gen) for k in ("c_x", "c_y", "nc_x", "nc_y")}
    b["c_ref"] = torch.zeros(B, P, P, 1)
    b["weight"] = torch.ones(B)
    return b


def _program(seed=7):
    ref = models.nets(("G", "S", "D"), C)
    state = {k: init_state(ref[k], seed, i, "cpu") for i, k in enumerate(("G", "S", "D"))}
    nets = {"G": Generator(C), "S": Segmentor(C), "D": Discriminator(C)}
    for k, net in nets.items():
        net.load_state_dict(state[k])
    opt = {"G": adam(nets["G"].parameters()), "S": rmsprop(nets["S"].parameters()),
           "D": rmsprop(nets["D"].parameters())}
    steps = WSSSSteps(nets["G"], nets["S"], nets["D"], opt["G"], opt["S"], opt["D"],
                      VGG16Weights(models.vgg16_params(0), "cpu"),
                      PerceptionConfig((29,), False), 0.5, 0.0, 0.2, 1.6, 1.0, 1.5, 0.6,
                      msssim_weights=(0.5, 0.5))
    return state, nets, opt, steps


def _state(nets, opt):
    return {"nets": {k: {n: t.detach().clone() for n, t in nets[k].state_dict().items()}
                     for k in ("S", "D")},
            "sq": {k: {n: opt[k].state[p]["square_avg"].detach().clone()
                       if p in opt[k].state else torch.zeros_like(p)
                       for n, p in nets[k].named_parameters()} for k in ("S", "D")}}


def _step(steps, b):
    m = steps.adversarial(b["c_x"], b["c_y"], b["c_ref"], b["nc_x"], b["nc_y"], b["weight"],
                          LR_S, LR_D)
    return {k: float(m[k]) for k in ("d_loss", "s_loss")}


def _leaves(nets, what):
    """Each parameter (``data``) or its ``grad`` (zeros for None: the bias of
    a conv that a BatchNorm follows is folded into it and takes none)."""
    return {f"{k}.{n}": (p if what == "data" else p.grad if p.grad is not None
                         else torch.zeros_like(p)).detach().clone()
            for k in ("S", "D") for n, p in nets[k].named_parameters()}


@pytest.fixture(scope="module")
def second_step():
    """The program's second step from the state its first one left (RMSprop
    holding g^2), and the reference's step from that same state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        init, nets, opt, steps = _program()
        batches = [_batch(1), _batch(2)]
        _step(steps, batches[0])
        before = _state(nets, opt)
        losses = _step(steps, batches[1])
        prog = {"losses": losses, "grads": _leaves(nets, "grad"),
                "after": _leaves(nets, "data")}
        prog["change"] = {k: prog["after"][k].double()
                          - before["nets"][k.split(".")[0]][k.split(".", 1)[1]].double()
                          for k in prog["after"]}
        (ref,) = from_state.wsss_steps(CFG, init["G"], [before], [{"id": 1}], Batches(batches),
                                       models.vgg16_params(0), "cpu")
        return prog, ref, before
    finally:
        torch.set_num_threads(n)


def test_a_step_from_a_given_state_has_the_references_losses(second_step):
    prog, ref, _ = second_step
    for k in ("d_loss", "s_loss"):  # one float32 forward each side: rounding only
        assert prog["losses"][k] == pytest.approx(ref["losses"][k], rel=1e-5)


@pytest.mark.parametrize("net", ["S", "D"])
def test_a_step_from_a_given_state_leaves_the_references_grad(second_step, net):
    prog, ref, _ = second_step
    keep = [k for k in compare.kept_leaves(ref["grads"]) if k.startswith(net + ".")]
    assert keep
    gaps = compare.leaf_gaps(prog["grads"], ref["grads"], keep)
    # float32 on both sides: the median leaf within rounding (about 1e-5);
    # a ReLU input within rounding of 0 flips its mask now and then, which
    # moves the worst leaf by up to a few 1e-3
    assert statistics.median(gaps.values()) < 1e-4
    assert max(gaps.values()) < 5e-3


def test_a_step_from_a_given_state_leaves_the_references_parameters(second_step):
    prog, ref, before = second_step
    keep = compare.kept_leaves(ref["grads"])
    gaps = compare_steps.wchange_gaps(prog["change"], ref["change"], ref["grads"], keep)
    assert max(gaps.values()) < 1e-3  # as the gradients: float32 rounding both sides
    # the parameters after the step, each leaf's gap over the norm of its
    # change: RMSprop's step is about 10 lr sign(g) where g^2 is new, so an
    # element whose gradient is within rounding of 0 may step the other way
    rel = {}
    for k in keep:
        net, name = k.split(".", 1)
        want = before["nets"][net][name].double() + ref["change"][k]
        rel[k] = float((prog["after"][k].double() - want).norm() / ref["change"][k].norm())
    assert statistics.median(rel.values()) < 1e-3 and max(rel.values()) < 1e-2


# -- wchange_gap ------------------------------------------------------------------
def _leaf_pair(seed=3, n=4000):
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(n, generator=gen, dtype=torch.float64)
    return {"w": g}, {"w": -10.0 * 1e-4 * torch.sign(g)}  # RMSprop's first step


@pytest.mark.parametrize("fault,low,high", [
    ("unchanged", 1.0, 1.0),     # no change at all reads 1 exactly
    ("flipped", 0.0, 0.01),      # the 2 % of elements nearest g = 0 flipped
    ("scaled", 0.5, 0.5),        # the change at half its size
])
def test_wchange_gap_reads_what_it_must(fault, low, high):
    grads, change = _leaf_pair()
    c = change["w"]
    if fault == "unchanged":
        prog = torch.zeros_like(c)
    elif fault == "flipped":
        small = grads["w"].abs().argsort()[:len(c) // 50]
        prog = c.clone()
        prog[small] = -prog[small]
    else:
        prog = 0.5 * c
    (gap,) = compare_steps.wchange_gaps({"w": prog}, change, grads, ["w"]).values()
    assert low - 1e-12 <= gap <= high + 1e-12
    # unweighted, the flipped copy reads as large as a fault
    if fault == "flipped":
        assert float((prog - c).abs().sum() / c.abs().sum()) == pytest.approx(0.04)


# -- <net>_descent_gap -------------------------------------------------------------
@pytest.mark.parametrize("fault,low,high", [
    ("unchanged", 1.0, 1.0),   # no change at all reads 1 exactly
    ("flipped", 0.0, 1e-3),    # the 2 % of elements nearest g = 0 flipped
    ("scaled", 0.5, 0.5),      # the change at half its size
    ("reversed", 2.0, 2.0),    # a step up the loss
])
def test_descent_gap_reads_what_it_must(fault, low, high):
    grads, change = _leaf_pair()
    c = change["w"]
    if fault == "unchanged":
        prog = torch.zeros_like(c)
    elif fault == "flipped":
        small = grads["w"].abs().argsort()[:len(c) // 50]
        prog = c.clone()
        prog[small] = -prog[small]
    else:
        prog = (0.5 if fault == "scaled" else -1.0) * c
    got = compare_steps.descent_gaps({"S.w": prog}, {"S.w": c}, {"S.w": grads["w"]}, ["S.w"])
    assert list(got) == ["s_descent_gap"]
    assert low - 1e-12 <= got["s_descent_gap"] <= high + 1e-12


def test_descent_gap_is_taken_net_by_net():
    """Each net's number sums its own leaves only: S's step left out reads 1
    for S and 0 for D."""
    grads, change = _leaf_pair()
    ref = {"S.a": change["w"], "S.b": 2 * change["w"], "D.a": change["w"]}
    g = {k: grads["w"] for k in ref}
    prog = dict(ref, **{"S.a": torch.zeros_like(change["w"]),
                        "S.b": torch.zeros_like(change["w"])})
    assert compare_steps.descent_gaps(prog, ref, g, list(ref)) == {"d_descent_gap": 0.0,
                                                                   "s_descent_gap": 1.0}


def test_worst_of_steps_takes_each_numbers_worst_step():
    grads, change = _leaf_pair()
    leaves = {f"l{i}": grads["w"] * (i + 1) for i in range(3)}
    ref = [{"losses": {"a": 1.0}, "grads": leaves,
            "change": {k: change["w"] for k in leaves}} for _ in range(2)]
    prog = [dict(ref[0]), dict(ref[1], losses={"a": 1.01})]
    got = compare_steps.worst_of_steps(prog, ref, ["a"])
    assert got["loss_gap"] == pytest.approx(0.01) and got["grad_gap"] == 0.0
    assert got["wchange_gap"] == 0.0
    assert compare_steps.worst_of_steps(compare_steps.unchanged(prog), ref,
                                        ["a"])["wchange_gap"] == 1.0


# -- the step's spans -------------------------------------------------------------
def test_the_adversarial_step_records_its_phases(one_torch_thread):
    _, nets, opt, steps = _program()
    with recording() as rec:
        _step(steps, _batch(4))
    (root,) = [s for s in rec.spans if s.name == "adv"]
    kids = sorted((s for s in rec.spans if s.parent == root.id), key=lambda s: s.start)
    assert [s.name for s in kids] == PHASES
    assert root.parent is None and len(rec.spans) == 1 + len(PHASES)
    assert all(root.start <= s.start <= s.end <= root.end for s in kids)
    before = _leaves(nets, "data")
    _step(steps, _batch(5))  # no recording open: the step still runs and steps
    assert any(not torch.equal(before[k], v) for k, v in _leaves(nets, "data").items())


# -- the slice pass's work ---------------------------------------------------------
@pytest.mark.parametrize("n,p", [(2, 48), (3, 40)])
def test_slice_pass_flops_match_the_flop_counter(n, p):
    from torch.utils.flop_counter import FlopCounterMode

    s = models.Segmentor(C).train()
    x = torch.randn(n, C, p, p)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        s(x, x)
    assert fc.get_total_flops() == work_slices.slice_pass_flops(n, p, C)


def test_slice_pass_launches_are_the_programs_counts():
    """A train-mode S forward on 15 pairs of 200 px: the 3 conv3x3 convs of
    the gate, one channel_sums a BatchNorm (18), 4 phase_pool pools."""
    groups = work.by_group(work_slices.slice_pass_launches(15, 200, C, "bfloat16"))
    assert {g: v["launches"] for g, v in groups.items()} == {
        "conv3x3": 3, "channel_sums": 18, "phase_pool": 4}
    # the sums read each bf16 activation once and write two f32 vectors: the
    # encoder's BatchNorms on both dates (30 images), the decoder's on 15
    bns = [(30, h, c) for h, c in ((200, 64), (100, 128), (50, 256), (25, 512), (12, 512))
           for _ in range(2)]
    bns += [(15, h, c) for h, c in ((25, 1024), (25, 512), (50, 512), (50, 256), (100, 256),
                                    (100, 128), (200, 128), (200, 128))]
    sums = sum(n * h * h * c * 2 + 2 * c * 4 for n, h, c in bns)
    assert groups["channel_sums"]["bound_s"] == pytest.approx(sums / work.PEAK_BYTES, rel=1e-3)


# -- the benchmark's check, whole -------------------------------------------------
@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_the_adversarial_cells_check_passes_the_program_and_fails_a_stuck_step(
        tmp_path, monkeypatch, fault, one_torch_thread):
    """The cell's driver at a small size in float32 passes the program; with
    S's and D's RMSprop steps made to leave the state unchanged it reads
    ``wchange_gap`` and each net's descent gap 1, past the cell's limits."""
    import time

    from benchmark import harness
    from benchmark.traffic import adversarial_loop
    from fcdgan_tpu_torch.train import steps as program_steps

    if fault:
        monkeypatch.setattr(program_steps, "_apply", lambda *pairs: None)
    ov = {"profile_steps": 1, "config": {"slice": 32, "batch": 2, "n_changed": 4,
                                         "n_unchanged": 4, "msssim_weights": [0.5, 0.5],
                                         "compute_dtype": "float32"}}
    r = harness.Run("wsss-adv.whu600", 2 ** 33 + 9, 0.0, False, torch.device("cpu"),
                    str(tmp_path), time.perf_counter(), ov)
    rec = adversarial_loop.run(r)
    judged = harness.judge(rec["checks"], r.cell["limits"])
    if fault:
        for name in ("wchange_gap", "s_descent_gap", "d_descent_gap"):
            assert rec["checks"][name] == 1.0 and not judged[name]["ok"], name
    else:
        # float32 on both sides: rounding, and a ReLU mask flipped now and then
        assert rec["checks"]["grad_gap"] < 1e-3 and rec["checks"]["wchange_gap"] < 1e-3
        assert rec["checks"]["loss_gap"] < 1e-5
        assert rec["checks"]["s_descent_gap"] < 1e-3 and rec["checks"]["d_descent_gap"] < 1e-3
        assert all(c["ok"] for c in judged.values())
