"""Progress-line formatting (copy of the JAX package's ``utils/timing.py``).

``time_show`` keeps value parity with the reference progress formatter
(CommonFunc.py:226-243): seconds -> "1d 2h 3m 4.5s".
"""

from __future__ import annotations


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
