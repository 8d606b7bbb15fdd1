"""The arithmetic that the metric readers (``metrics/<metric>.py``) share.

Each takes a run's record (``harness``) and returns a number, or None
where the run has nothing to read: another kind of cell, no trace, or a
kernel whose launches in the profiled window are not those that
``work`` derives from the shapes (its work would then be counted wrong).
"""

from __future__ import annotations

import math
import sys
from typing import Optional, Sequence

from . import work


def _of(record: dict, kind: str) -> bool:
    return record.get("kind") == kind


def rate_mpx(record: dict, kind: str) -> Optional[float]:
    """Pixels of the whole window over its seconds, in Mpx/s."""
    if not _of(record, kind):
        return None
    return record["window_px"] / record["window_s"] / 1e6


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile by nearest rank: the smallest value with at least
    ``q`` of the values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s)), 1) - 1]


def span_ms_per(record: dict, kind: str, names: Sequence[str], per: str) -> Optional[float]:
    """Host milliseconds of the named spans over the window, per ``per``
    (a count of the record)."""
    if not _of(record, kind) or not record.get(per):
        return None
    return 1e3 * sum(sum(record["spans"].get(n, ())) for n in names) / record[per]


def _trace(record: dict, kind: str) -> Optional[dict]:
    return record.get("trace") if _of(record, kind) else None


def group_ms_per_unit(record: dict, kind: str, group: str) -> Optional[float]:
    tr = _trace(record, kind)
    if tr is None:
        return None
    return 1e3 * tr["group_s"].get(group, 0.0) / tr["units"]


def idle_share(record: dict, kind: str) -> Optional[float]:
    tr = _trace(record, kind)
    if tr is None or tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])


def busy_ms_per_mpx(record: dict, kind: str) -> Optional[float]:
    tr = _trace(record, kind)
    if tr is None or not tr.get("px"):
        return None
    return 1e3 * tr["busy_s"] / (tr["px"] / 1e6)


def roofline(record: dict, kind: str, groups: Sequence[str]) -> Optional[float]:
    """The kernels' least time for their work in the profiled window over
    their device time there, in %; None unless every group's launches are
    the derived ones."""
    tr = _trace(record, kind)
    if tr is None:
        return None
    bound = device = 0.0
    for g in groups:
        want = tr["expected"].get(g, {"launches": 0, "bound_s": 0.0})
        got = tr["launches"].get(g, 0)
        if got != want["launches"] or got == 0:
            print(f"{g}: {got} launches in the profiled window, {want['launches']} derived",
                  file=sys.stderr)
            return None
        bound += want["bound_s"]
        device += tr["group_s"][g]
    return 100.0 * bound / device


def mfu(record: dict, kind: str) -> Optional[float]:
    """Model FLOPs of the window over its seconds, in % of the bf16 dense
    peak; with ``--trace 1`` the window follows the profiled steps."""
    if not _of(record, kind) or record.get("trace") is None:
        return None
    return 100.0 * record["model_flops"] / record["window_s"] / work.MFU_PEAK


KERNELS = {"train": ("conv3x3", "pool_bwd", "phase_pool", "channel_sums", "fused_ssim"),
           "serve": ("conv3x3", "phase_pool")}
