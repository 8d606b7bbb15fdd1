"""The train steps on two gloo ranks: each rank runs the single-device step
on its slice of the global batch, and the result is the global batch's.
(The USSS joint step on two ranks against the JAX step is in
``tests/test_torch_usss.py``, beside the JAX outputs it reuses.)

  * The WSSS and RSSS adversarial steps against the single-process port
    step on the same padded batch (three samples and a weight-0 duplicate):
    metrics within 1e-5 relative, confusion equal, BatchNorm buffers within
    1e-5 of their largest value (f32 reduction order only), and the summed
    gradients per tensor within 1e-5 of the net's largest gradient or, in norm,
    within twice the gap between the port's own step and the same step on
    the batch scaled by one float32 rounding (one seed; the witness of
    ``test_torch_wsss.py``): at these sizes S's gradients move by up to
    about 1 % under such a rounding. The stepped parameters within 1e-5 of
    their largest value plus 1e-3 of the element's own update, wherever the
    two gradients agree within 1e-3 of themselves (the first Adam or RMSprop
    update then agrees within 1e-3 of itself). RMSprop's first update is
    about ten times the rate times the gradient's sign, so an element whose
    gradient lies within the gap of zero steps either way.
  * Both ranks' parameters and BatchNorm buffers bit-equal.
  * A non-finite metric on one rank makes ``nan_checked`` raise on both.
"""

import numpy as np
import pytest
import torch

from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor

import torch_parallel_workers as workers
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401


WITNESS_EPS = 1e-7  # about one float32 rounding of the batch


def _np_state(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def _assert_ranks_equal(ranks):
    for net, sd in ranks[0]["state"].items():
        for k, v in sd.items():
            np.testing.assert_array_equal(ranks[1]["state"][net][k], v, err_msg=(net, k))


def _adversarial_batch(mode):
    rng = np.random.default_rng(0)
    hw, nb = (32, 3) if mode == "wsss" else (40, 4)
    weight = np.array([1, 1, 1, 0], np.float32)  # three samples, a weight-0 duplicate

    def pair(change):
        x = rng.normal(size=(3, hw, hw, nb)).astype(np.float32)
        y = (x * 0.9 + 0.1 + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
        if change:
            y[:, 8:20, 10:22, :] += 2.0
        return np.concatenate([x, x[:1]]), np.concatenate([y, y[:1]])

    c_x, c_y = pair(True)
    if mode == "wsss":
        nc_x, nc_y = pair(False)
        c_ref = np.zeros((4, hw, hw, 1), np.float32)
        c_ref[:, 8:20, 10:22] = 1.0
        return dict(c_x=c_x, c_y=c_y, c_ref=c_ref, nc_x=nc_x, nc_y=nc_y, weight=weight), nb
    ref = np.ones((4, hw, hw, 1), np.float32)
    ref[:, 8:20, 10:22] = 2.0
    region = np.zeros((4, hw, hw, 1), np.float32)
    region[:, 6:22, 8:24] = 1.0
    return dict(x=c_x, y=c_y, ref=ref, region=region, item=np.array([0, 1, 2, 0]),
                weight=weight), nb


def _scaled(batch, seed):
    rng = np.random.default_rng(seed)
    return {k: (v * (1 + WITNESS_EPS * rng.normal(size=v.shape))).astype(v.dtype)
            if k in ("x", "y", "c_x", "c_y", "nc_x", "nc_y") else v for k, v in batch.items()}


def _close_or_witnessed(got, want, scale, witnesses, what):
    """Within 1e-5 of ``scale``, or in norm within twice the witness gap."""
    if np.abs(got - want).max() <= 1e-5 * scale:
        return
    self_gap = max(np.linalg.norm(w() - want) for w in witnesses)
    assert np.linalg.norm(got - want) <= 2 * self_gap, what


def _adversarial_case(mode):
    """(state, batch, interior) of ``mode``'s adversarial step: seeded nets
    of the batch's band count."""
    batch, nb = _adversarial_batch(mode)
    hw = (batch["c_x"] if mode == "wsss" else batch["x"]).shape[1]
    interior = np.array([[hw - 8, hw - 8]] * 3, np.int64)
    torch.manual_seed(0)
    state = {n: _np_state(net) for n, net in (("g", Generator(nb)), ("s", Segmentor(nb)),
                                              ("d", Discriminator(nb)))}
    return state, batch, interior


@pytest.fixture(scope="module")
def adversarial_ranks(tmp_path_factory):
    """Both modes' steps on two gloo ranks, in one spawn of the ranks."""
    cases = {mode: _adversarial_case(mode) for mode in ("wsss", "rsss")}
    return cases, run_ranks(workers.adversarial_steps,
                            ({mode: (*case, (4, 4)) for mode, case in cases.items()},),
                            tmp_path_factory.mktemp("adversarial"))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("mode", ["wsss", "rsss"])
def test_adversarial_step_on_two_ranks_matches_one_process(mode, adversarial_ranks):
    cases, rank_outs = adversarial_ranks
    state, batch, interior = cases[mode]
    args = (mode, state, batch, interior, (4, 4))
    ranks = [r[mode] for r in rank_outs]
    want = workers.adversarial_step(None, *args)
    _assert_ranks_equal(ranks)
    got = ranks[0]
    np.testing.assert_array_equal(got["metrics"]["confusion"], want["metrics"]["confusion"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    cache = {}

    def witness(seed):
        if seed not in cache:
            cache[seed] = workers.adversarial_step(
                None, mode, state, _scaled(batch, seed), interior, (4, 4))
        return cache[seed]

    for net in ("g", "s", "d"):
        assert sorted(got["grads"][net]) == sorted(want["grads"][net])
        largest = max((float(np.abs(v).max()) for v in want["grads"][net].values()), default=0)
        for k, v in want["grads"][net].items():
            _close_or_witnessed(got["grads"][net][k], v, largest,
                                [lambda: witness(1)["grads"][net][k]],
                                (net, "grad", k))
        for k, v in want["state"][net].items():
            p = got["state"][net][k]
            if v.dtype.kind != "f":
                np.testing.assert_array_equal(p, v, err_msg=k)
                continue
            tol = 1e-5 * np.abs(v).max() + 1e-3 * np.abs(v - state[net][k])
            same = np.ones(v.shape, bool)
            if k in want["grads"][net]:
                g, g1 = got["grads"][net][k], want["grads"][net][k]
                same = np.abs(g - g1) <= 1e-3 * np.abs(g1)
            assert (np.abs(p - v) <= tol)[same].all(), (net, k)


def test_nan_on_one_rank_raises_on_every_rank(tmp_path):
    """``nan_checked`` all-reduces its finding: rank 0's NaN metric raises
    ``FloatingPointError`` on both ranks, and neither hangs."""
    msgs = run_ranks(workers.nan_checked_step, (), tmp_path)
    assert msgs[0] == "phase joint, epoch 1: NetLoss is nan"
    assert msgs[1] == "phase joint, epoch 1: a non-finite value on another rank"
