"""What decides ``correct`` has to fail what it must, at sizes a CPU test
run holds: the control (the reference in float8 in the program's place)
reads past a cell's limits, and a whole run with the timed path broken
underneath (a step that leaves the state unchanged, half of each batch left
out, a served answer altered where it is produced) comes out not correct,
while the same run unbroken is correct."""

import time

import numpy as np
import pytest
import torch

from benchmark import control, harness, run

torch.set_num_threads(2)

TRAIN = {
    "usss-train.scene2048": {
        "scene_px": 96, "rects": [[20, 24, 18, 14], [60, 60, 16, 20]], "profile_steps": 1,
        "config": {"patch": 48, "pad": 4, "batch": 3, "msssim_weights": [0.5, 0.5]}},
    "wsss-train.whu600": {
        "profile_steps": 1,
        "config": {"slice": 48, "batch": 3, "n_changed": 9, "n_unchanged": 9,
                   "msssim_weights": [0.5, 0.5]}},
}
SERVE = {"usss-serve.scenes8": {"scenes": [[96, 96], [128, 80]], "profile_scenes": 1,
                                "batch": 4, "config": {"patch": 48, "pad": 4}}}
F32 = {"compute_dtype": "float32"}


def _bench(cell):
    """``BENCHMARK.json``, with ``cell`` added on one chip where it holds the
    cell out (its files stay under ``benchmark/``)."""
    bench = harness.spec()
    if all(w["name"] != cell for w in bench["workloads"]):
        c = harness.cell(cell)
        bench["workloads"].append({"name": cell, "config": c["config"], "traffic": c["traffic"],
                                   "chips": 1, "why": c["why"]})
    return bench


def _run(cell, overrides, seed=2 ** 33 + 17):
    ov = {**overrides, "config": {**overrides["config"], **F32}}
    return run.run_cell(cell, seed, 0.2, False, "cpu", overrides=ov, bench=_bench(cell),
                        t0=time.perf_counter())


@pytest.mark.parametrize("cell", sorted({**TRAIN, **SERVE}))
def test_the_control_fails_the_cells_limits(cell):
    limits = harness.cell(cell)["limits"]
    got = control.readings(cell, 2 ** 33 + 3, "cpu", {**TRAIN, **SERVE}[cell])["fp8"]["numbers"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)


@pytest.mark.parametrize("cell", sorted({**TRAIN, **SERVE}))
def test_a_sound_run_is_correct(cell):
    res = _run(cell, {**TRAIN, **SERVE}[cell])
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    from fcdgan_tpu_torch.train import steps

    apply = steps._apply

    def unchanged(*updates):
        params = [p for opt, _ in updates for g in opt.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        apply(*updates)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)

    monkeypatch.setattr(steps, "_apply", unchanged)
    res = _run(cell, TRAIN[cell])
    assert not res["correct"] and res["checks"]["change_gap"]["value"] > 0.9


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_half_of_each_batch_left_out_is_caught(cell, monkeypatch):
    from fcdgan_tpu_torch.train import steps

    def halved(fn, n_batch_args):
        def step(self, *args):
            n = len(args[n_batch_args - 1])
            keep = max(n // 2, 1)
            cut = [a[:keep] if i < n_batch_args else a for i, a in enumerate(args)]
            return fn(self, *cut)
        return step

    monkeypatch.setattr(steps.USSSSteps, "joint", halved(steps.USSSSteps.joint, 5))
    monkeypatch.setattr(steps.WSSSSteps, "adversarial", halved(steps.WSSSSteps.adversarial, 6))
    res = _run(cell, TRAIN[cell])
    assert not res["correct"], res["checks"]


def test_a_served_answer_altered_is_caught(monkeypatch):
    from fcdgan_tpu_torch.data import device_cache

    finish = device_cache.DeviceSceneCache.stitched_density_finish

    def altered(handle, density_dtype="float32"):
        d = np.array(finish(handle, density_dtype))
        d[:8, :8] = 1.0 - d[:8, :8]
        return d

    monkeypatch.setattr(device_cache.DeviceSceneCache, "stitched_density_finish",
                        staticmethod(altered))
    res = _run("usss-serve.scenes8", SERVE["usss-serve.scenes8"])
    assert not res["correct"], res["checks"]
