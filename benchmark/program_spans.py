"""Per-layer metrics from the program's own spans (``utils.timing``), which
a traffic driver records over its profiled units only (``program_spans``:
each span's seconds by name). A run whose program has no such span, or a
run without ``--trace 1``, has nothing to read: None."""

from __future__ import annotations

from typing import Optional


def _seconds(record: dict, kind: str, name: str) -> Optional[float]:
    if record.get("kind") != kind or record.get("trace") is None:
        return None
    spans = record.get("program_spans", {}).get(name)
    return sum(spans) if spans else None


def ms_per_unit(record: dict, kind: str, name: str) -> Optional[float]:
    """Host ms of the span ``name`` over the profiled units (steps or requests)."""
    s = _seconds(record, kind, name)
    return None if s is None else 1e3 * s / record["trace"]["units"]


def ms_per_mpx(record: dict, kind: str, name: str) -> Optional[float]:
    """Host ms of the span ``name`` over the Mpx of the profiled units."""
    s = _seconds(record, kind, name)
    px = record["trace"].get("px") if s is not None else None
    return None if not px else 1e3 * s / (px / 1e6)
