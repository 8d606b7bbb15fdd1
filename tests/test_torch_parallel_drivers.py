"""The drivers on ranks of their own, on the CPU: a two-process multi-host
USSS run (``--num-processes 2 --process-id i``, each process writing into
its own directory, as in the JAX package) whose densities are bit-equal to
each other, and failures: a rank that raises stops the others and fails
the launcher, and a NaN under ``--debug-nans`` makes the spawning driver
exit non-zero; nothing waits past its deadline. (``--n-devices 2`` of each
driver and of the serving tool against one process: the ``--n-devices``
cases of ``test_unported_options_raise`` in ``test_torch_usss.py``,
``test_torch_wsss.py``, ``test_torch_rsss_data.py`` and
``test_torch_isolation.py``.)"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USSS_ARGS = ["--device", "cpu", "--patch-size", "32,32", "--overlap-padding", "4,4",
             "--msssim-weights", "0.5,0.5", "--batch-size", "2", "--init-num-epochs-g", "0",
             "--init-num-epochs-s", "0", "--num-epochs", "1", "--log-tensorboard", "false",
             "--progress", "false", "--save-checkpoints", "false"]


def _start(argv):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "fcdgan_tpu_torch.demos.demo_usss", *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout=240.0):
    """Each process's (exit code, stderr); every one killed at the deadline."""
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_multihost_processes_write_the_same_densities(tmp_path):
    """Two processes of one multi-host world (a file rendezvous, no port)
    read the same global batches, train on their halves and each write the
    full artifact set: the density rasters are bit-equal, and the host feed
    (no resident cache under multi-host) ran."""
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene

    make_usss_scene(str(tmp_path), 48, 48, 3, rects=((10, 12, 14, 12),), seed=2)
    store = "file://" + str(tmp_path / "rendezvous")
    procs = [_start(["--dir", str(tmp_path), "--outdir", str(tmp_path / f"p{i}"), *USSS_ARGS,
                     "--num-processes", "2", "--process-id", str(i),
                     "--coordinator-address", store]) for i in (0, 1)]
    for rc, err in _finish(procs):
        assert rc == 0, err[-3000:]
    dens = [open_raster(str(tmp_path / f"p{i}" / "ChangeDensity.tif")).read_block()
            for i in (0, 1)]
    assert dens[0].shape == (48, 48, 1) and np.isfinite(dens[0]).all()
    np.testing.assert_array_equal(dens[0], dens[1])
    for i in (0, 1):
        assert os.path.isfile(tmp_path / f"p{i}" / "ChangeDensity_acc_color.tif")


def test_a_failing_rank_stops_every_rank():
    """Rank 1 raises while rank 0 waits in a collective: rank 0's collective
    fails or the launcher stops it, and the launcher raises the first
    failure it sees; nothing waits and nothing falls back to one rank."""
    from torch.multiprocessing.spawn import ProcessException

    import torch_parallel_workers as workers
    from fcdgan_tpu_torch.parallel import mesh

    t0 = time.monotonic()
    with pytest.raises(ProcessException, match="terminated"):
        mesh.launch(workers.fail_on_rank_one, 2, "cpu")
    assert time.monotonic() - t0 < 120


def test_nan_fails_the_spawning_driver(tmp_path):
    """A NaN rate under ``--debug-nans`` on two ranks: the ranks raise
    ``FloatingPointError`` and the driver that spawned them exits non-zero."""
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene

    make_usss_scene(str(tmp_path), 48, 48, 3, rects=((10, 12, 14, 12),), seed=2)
    (rc, err), = _finish([_start(["--dir", str(tmp_path), *USSS_ARGS, "--n-devices", "2",
                                  "--lr-scale", "nan", "--debug-nans", "true"])])
    assert rc != 0
    assert "FloatingPointError" in err and "phase joint, epoch 1" in err
