"""The port's benchmark entry (``fcdgan_tpu_torch/tools/bench.py``) on the CPU
at tiny sizes, its USSS modes: each mode's JSON line under the JAX bench's
metric name and unit with its fields, the driver's tile and batch counts
against the JAX dataset and loader (``fcdgan_tpu.data``, no JAX step
compiled) of the same sizes, the out-of-memory row of ``--batch-sweep``,
the CLI's dispatch, and no run without a GPU unless the CPU is asked for.
The adversarial modes are in ``test_torch_bench_adversarial.py``,
``--scaling`` in ``test_torch_bench_scaling.py``.

The sizes: 32 px tiles (overlap 4) of 48 px scenes, batches of 1 to 4,
2-scale MS-SSIM, one warm and one timed step or epoch, the full-width
models in the default bf16."""

import json
import os

import pytest
import torch

from fcdgan_tpu_torch.tools import bench

from torch_bench_lines import CPU, MSW, PAD, PATCH, SCENE
from torch_bench_lines import check as _check
from torch_bench_lines import lines as _lines
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_scene_counts(tmp_path, batch):
    """Tiles and epoch batches of the JAX ScenePairDataset and the JAX
    driver's resident loader over the bench's scene at these sizes."""
    from fcdgan_tpu.data.datasets import ScenePairDataset
    from fcdgan_tpu.data.device_cache import IndexBatchLoader
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene

    paths = make_usss_scene(str(tmp_path / "jax"), SCENE, SCENE, 3, dtype="uint16")
    ds = ScenePairDataset(paths["x"], paths["y"], ref_path=paths["ref"],
                          patch_size=(PATCH, PATCH), overlap_padding=PAD)
    return len(ds), len(IndexBatchLoader(ds, batch, shuffle=True, seed=0, tail="short"))


def test_default_mode_step_then_driver(capsys, tmp_path):
    out = bench.main_default(CPU, batch=4, hw=PATCH, warm=1, n_steps=1, msssim_weights=MSW,
                             scene_px=SCENE, epochs=1, pad=PAD)
    (line,) = _lines(capsys)
    assert line == json.loads(json.dumps(out))
    _check(line, "usss_driver_joint_epochs_per_s", "epochs/s")
    assert line["step_mpx_per_s"] > 0 and line["step_vs_baseline"] == -1.0
    assert line["driver_frac_of_step"] == pytest.approx(line["mpx_per_s"]
                                                        / line["step_mpx_per_s"])
    assert line["mpx_per_s"] == pytest.approx(
        line["tiles_per_epoch"] * PATCH ** 2 * line["value"] / 1e6)
    assert (line["tiles_per_epoch"], line["batches_per_epoch"]) == _jax_scene_counts(tmp_path, 4)
    assert (line["scene_px"], line["scene_dtype"], line["feed"]) == (SCENE, "uint16",
                                                                      "scene_cache")
    assert line["device_normalize"] is False
    assert set(line["budget_ms_per_batch"]) == {"load_s", "put_s", "dispatch_s"}
    assert line["epoch_sync_ms"] >= 0 and len(line["net_losses"]) == 1
    assert "slab_waits" not in line


@pytest.mark.parametrize("feed,dtype,want", [("window", "uint16", "scene_window"),
                                             ("stream", "float32", "stream")])
def test_driver_feeds(feed, dtype, want, capsys, monkeypatch):
    """``FCDGAN_DRIVER_FEED`` window and stream and ``FCDGAN_DRIVER_DTYPE``:
    the rolling window lists its slab waits; a float32 scene on the host
    loaders (native float32 tiles)."""
    monkeypatch.setenv("FCDGAN_DRIVER_FEED", feed)
    monkeypatch.setenv("FCDGAN_DRIVER_DTYPE", dtype)
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.08")  # one tile row a slab
    bench.bench_driver(CPU, scene_px=SCENE, epochs=1, batch=4, patch=PATCH, pad=PAD,
                       msssim_weights=MSW)
    (line,) = _lines(capsys)
    _check(line, "usss_driver_joint_epochs_per_s", "epochs/s")
    assert (line["feed"], line["scene_dtype"], line["tiles_per_epoch"]) == (want, dtype, 4)
    if feed == "window":
        assert line["slab_waits"]["n"] >= 1 and line["slab_waits"]["total_s"] >= 0
    else:
        assert line["device_normalize"] is False


@pytest.mark.parametrize("dd", ["float32", "uint8"])
def test_inference(dd, capsys, monkeypatch):
    monkeypatch.delenv("FCDGAN_SERVE_BS", raising=False)
    bench.bench_inference(CPU, dd, scene_px=SCENE, patch=PATCH, pad=PAD, batch=2, reps=1,
                          chain=2)
    (line,) = _lines(capsys)
    _check(line, f"usss_infer_throughput_{dd}", "Mpx/s", baseline=1.0 if dd == "float32"
           else None)
    assert line["feed"] == "auto" and line["served_feed"] == "resident"
    assert line["serve_bs"] == "32" and "FCDGAN_SERVE_BS" not in os.environ
    assert len(line["reps_mpx_per_s"]) == len(line["rep_wall_s"]) == 1
    assert line["stalls_discarded"] == [] and line["device_compute_mpx_per_s"] > 0
    assert len(line["f32_reps_mpx_per_s"]) == 1


def test_pretrain(capsys):
    bench.bench_pretrain(CPU, batch=1, hw=PATCH, n_steps=1, msssim_weights=MSW)
    (line,) = _lines(capsys)
    _check(line, "usss_pretrain_throughput", "Mpx/s", baseline=None)
    assert line["vs_baseline"] == pytest.approx(line["value"]
                                                / line["stacked_target_grad_mpx_s"])


def test_batch_sweep_prints_an_out_of_memory_row_and_retries_with_remat(capsys,
                                                                         monkeypatch):
    real = bench.usss_setup
    made = []

    def setup(device, bs, hw, remat=None, **kw):
        steps, data = real(device, bs, hw, remat=remat, **kw)
        made.append((bs, remat))
        if bs == 2 and not remat:
            def joint(*a):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (a patched step)")
            steps.joint = joint
        return steps, data

    monkeypatch.setattr(bench, "usss_setup", setup)
    rows = bench.bench_batch_sweep(CPU, batches=(1, 2), hw=PATCH, n_steps=1,
                                   msssim_weights=MSW)
    lines = _lines(capsys)
    assert rows == lines and made == [(1, None), (2, None), (2, True)]
    assert [ln["metric"] for ln in lines] == ["usss_train_throughput_bs1",
                                              "usss_train_throughput_bs2",
                                              "usss_train_throughput_bs2_remat"]
    _check(lines[0], "usss_train_throughput_bs1", "Mpx/s")
    assert lines[1]["value"] == -1.0 and lines[1]["error"] == "OutOfMemoryError"
    _check(lines[2], "usss_train_throughput_bs2_remat", "Mpx/s")


def test_a_failure_other_than_memory_stops_the_sweep(monkeypatch):
    def setup(*a, **kw):
        raise ValueError("not a memory error")

    monkeypatch.setattr(bench, "usss_setup", setup)
    with pytest.raises(ValueError, match="not a memory error"):
        bench.bench_batch_sweep(CPU, batches=(1,), hw=PATCH)


@pytest.mark.parametrize("argv,fn,args", [
    ([], "main_default", ()), (["--driver", "--epochs", "2"], "bench_driver", (1024, 2)),
    (["--inference", "--density-dtype", "uint8"], "bench_inference", ("uint8", 1024)),
    (["--pretrain"], "bench_pretrain", ()), (["--wsss"], "bench_wsss", ()),
    (["--rsss"], "bench_rsss", ()), (["--wsss-driver"], "bench_wsss_driver", (3,)),
    (["--rsss-driver", "--scene-px", "512"], "bench_rsss_driver", (3, 512)),
    (["--batch-sweep"], "bench_batch_sweep", ()), (["--scaling"], "bench_scaling", ())],
    ids=lambda v: v if isinstance(v, str) else None)
def test_cli_runs_each_mode_on_the_device_asked_for(argv, fn, args, monkeypatch):
    calls = []
    monkeypatch.setattr(bench, fn, lambda *a, **kw: calls.append((a, kw)))
    bench.main(["--device", "cpu"] + argv)
    ((a, kw),) = calls
    assert a[0] == CPU and a[1:] == args
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(argv)  # cuda unless the CPU is asked for


def test_no_gpu_no_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--scaling-worker", "1"])
    with pytest.raises(ValueError, match="FCDGAN_DRIVER_FEED"):
        monkeypatch.setenv("FCDGAN_DRIVER_FEED", "relay")
        bench.bench_driver(CPU)
