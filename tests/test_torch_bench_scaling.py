"""``--scaling`` of the port's benchmark entry: weak scaling with one
process a rank (``parallel.mesh``), each point in a subprocess of its own,
as gloo ranks on the CPU at 32 px tiles, one tile a rank; and on the GPU
the JAX bench's error row for a point past the card count."""

import pytest
import torch

from fcdgan_tpu_torch.tools import bench

from torch_bench_lines import CPU, PATCH
from torch_bench_lines import check as _check
from torch_bench_lines import lines as _lines


def test_scaling_on_gloo_ranks(capsys, monkeypatch):
    """n = 1 and 2 as gloo ranks, each in its own subprocess: the step's
    collective calls (the same count for every world) and the global batch."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = bench.bench_scaling(CPU, ns=(1, 2), timeout=240, batch_per_rank=1, hw=PATCH,
                               reps=1)
    lines = _lines(capsys)
    assert rows == lines
    for n, line in zip((1, 2), lines):
        assert "error" not in line, line
        _check(line, f"usss_dp_scaling_n{n}", "ms/step")
        assert (line["devices"], line["global_batch"]) == (n, n)
    assert lines[0]["all_reduce_ops"] == lines[1]["all_reduce_ops"] > 0


def test_scaling_past_the_cards_prints_the_jax_error_row(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    bench.bench_scaling("cuda", ns=(2, 4))
    assert _lines(capsys) == [
        {"metric": f"usss_dp_scaling_n{n}", "value": -1.0, "unit": "ms/step",
         "vs_baseline": -1.0, "error": f"need {n} devices, have 1"} for n in (2, 4)]
