"""``run_ranks``: a function on spawned gloo ranks, for the data-parallel tests.

Each rank is a process of its own (start method ``spawn``) on one intra-op
thread, joined to the others through a ``FileStore`` under the test's
``tmp_path``, so no TCP port is raced for. Each rank saves its result (or
its traceback) to a file. The join has a deadline: past it every rank is
killed and the test fails, so a deadlock in a collective fails one test and
never hangs the tier."""

import os
import time
import traceback

import torch


def _rank_entry(rank, size, store, fn, args, out_dir):
    torch.set_num_threads(1)
    from fcdgan_tpu_torch.parallel import mesh

    path = os.path.join(out_dir, f"rank{rank}")
    try:
        with mesh.world_group(rank, size, "file://" + store, torch.device("cpu")):
            result = fn(rank, *args)
        torch.save(result, path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, args, tmp_path, n=2, timeout=240.0):
    """``fn(rank, *args)`` on ``n`` gloo ranks; their results in rank order.
    A rank that raises fails the call with its traceback; ranks still
    running at ``timeout`` seconds are killed and the call fails."""
    import multiprocessing

    import pytest

    ctx = multiprocessing.get_context("spawn")
    out_dir = str(tmp_path / "ranks")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_rank_entry, args=(r, n, store, fn, args, out_dir))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    errors = [open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(n)
              if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if errors:
        pytest.fail("a rank raised:\n" + "\n".join(errors))
    if hung:
        pytest.fail(f"{len(hung)} rank(s) still running after {timeout} s: killed")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        pytest.fail(f"ranks exited with {bad}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]
