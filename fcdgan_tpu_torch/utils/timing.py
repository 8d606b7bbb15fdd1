"""Progress-line formatting and the drivers' profiler scope (the JAX
package's ``utils/timing.py``).

``time_show`` keeps value parity with the reference progress formatter
(CommonFunc.py:226-243): seconds -> "1d 2h 3m 4.5s". ``maybe_profile`` is
the counterpart of the JAX ``maybe_profile`` (:54-62): a ``torch.profiler``
trace of the block, written into a directory.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional


@contextlib.contextmanager
def maybe_profile(logdir: Optional[str], cuda: bool = True) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA
    ones when ``cuda``) written into ``logdir`` as a TensorBoard/Chrome
    ``*.pt.trace.json`` when the block ends; nothing without ``logdir``."""
    if not logdir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def time_show(seconds: float) -> str:
    """Seconds -> '1d 2h 3m 4.5s' (parity: CommonFunc.py:226-243)."""
    t = seconds
    time_d = time_h = time_m = ""
    time_s = "{:.1f}s".format(t % 60)
    if int(t / 60) > 0:
        t = int(t / 60)
        time_m = "{}m ".format(t % 60)
        if int(t / 60) > 0:
            t = int(t / 60)
            time_h = "{}h ".format(t % 60)
            if int(t / 24) > 0:
                t = int(t / 24)
                time_d = "{}d ".format(t)
    return "{}{}{}{}".format(time_d, time_h, time_m, time_s)


def progress_line(processed: int, total: int, per_iter_s: float, remaining_s: float) -> str:
    """One '\\r' progress line (format parity: Demo_USSS.py:175-176)."""
    return ("\rProcessing batch: {}/{}; Processing speed per iter: {}; "
            "Processing time remaining: {}".format(
                processed, total, time_show(per_iter_s), time_show(remaining_s)))
