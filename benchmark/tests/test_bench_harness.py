"""The harness takes new cells, configurations, metrics and kernel groups as
files found by name, and ``BENCHMARK.json`` keeps to the contract's
names, units and keys."""

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, readers, run, trace, work

torch.set_num_threads(2)

BENCH = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.spec()


def test_new_files_are_found_by_name(tmp_path):
    for d in ("workloads", "configs", "metrics", "kernel_groups"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "cfg-new.json").write_text(json.dumps({"mode": "usss", "bands": 4}))
    (tmp_path / "workloads" / "cell-new.x1.json").write_text(json.dumps(
        {"config": "cfg-new", "traffic": "train_loop", "params": {}, "limits": {}}))
    (tmp_path / "metrics" / "new_metric.train.py").write_text(
        "def read(record):\n    return record.get('x')\n")
    (tmp_path / "kernel_groups" / "new_kernel.json").write_text(json.dumps(
        {"priority": 1, "patterns": ["new_kernel_symbol"]}))
    c = harness.cell("cell-new.x1", base=str(tmp_path))
    assert harness.config(c["config"], base=str(tmp_path))["bands"] == 4
    assert harness.metric_reader("new_metric.train", base=str(tmp_path)).read({"x": 3}) == 3
    groups = trace.kernel_groups(str(tmp_path / "kernel_groups"))
    assert trace.group_of("void new_kernel_symbol<8>(float*)", groups) == "new_kernel"
    assert trace.group_of("something_else", groups) == "other"
    assert harness.traffic(c["traffic"]).run is not None


def test_names_must_be_names():
    for bad in ("a b", "a/b", "", "x" * 65, ".x"):
        with pytest.raises(ValueError):
            harness.check_name(bad)


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32 and all(LINE.match(w) for w in bench["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert harness.config(c["name"])["reduced"] == c["reduced"]
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.cell(w["name"])
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.metric_reader(m["name"]).read)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len(harness.metrics_for(bench, cell, False)) >= 2
        assert harness.metrics_for(bench, cell, True)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_kernel_groups_name_their_work():
    groups = trace.kernel_groups()
    assert [g for g, _ in groups][:6] == ["nccl", "conv3x3", "pool_bwd", "phase_pool",
                                          "channel_sums", "fused_ssim"]
    for g, spec in groups:
        assert isinstance(spec["priority"], int) and spec["patterns"]
        for fn in spec.get("work", []):
            assert work.conv3x3 and callable(getattr(work, fn))
    kernels = {g for g, s in groups if s.get("work")}
    assert kernels == set(readers.KERNELS["train"])


def test_nearest_rank():
    assert readers.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert readers.nearest_rank([3.0], 0.95) == 3.0


def _small_serve(trace_on):
    ov = {"scenes": [[64, 64], [80, 48]], "profile_scenes": 2, "batch": 2,
          "config": {"patch": 48, "pad": 4}}
    return run.run_cell("usss-serve.scenes8", 2 ** 33 + 5, 0.3, trace_on, "cpu",
                        overrides=ov, t0=time.perf_counter())


def test_a_small_run_prints_the_contracts_line():
    res = _small_serve(True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"density_gap"}
    assert {"busy_s", "window_s", "memory_peak_bytes", "count", "kind"} <= set(res["device"])
    assert {"device_ms_per_mpx.serve", "idle_share.serve", "mfu.serve"} <= set(res["metrics"])


def test_no_card_no_result():
    """Without a CUDA card the command prints no result and exits 3."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "usss-serve.scenes8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
def test_a_small_run_on_the_card(card):
    ov = {"scenes": [[256, 256]], "profile_scenes": 1, "config": {"patch": 220, "pad": 10}}
    res = run.run_cell("usss-serve.scenes8", 17, 1.0, True, card, overrides=ov,
                       t0=time.perf_counter())
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["idle_share.serve"]["value"] < 100
