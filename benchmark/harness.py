"""What the benchmark finds by name: cells (``workloads/<cell>.json``),
configurations (``configs/<config>.json``), traffic drivers
(``traffic/<driver>.py``), metric readers (``metrics/<metric>.py``) and
kernel groups (``kernel_groups/<group>.json``), and the ``Run`` that a
traffic driver fills in.

A traffic driver is a module with ``run(r: Run) -> dict``: it builds the
program under test from the cell's configuration and the seed, warms it up,
measures for ``r.seconds``, then checks what the window produced against
the reference and returns the run's record: a dict of the window's counts,
spans, seconds and trace, and the numbers compared (``checks``). A metric
reader is a module with ``read(record) -> float | None``; None leaves the
metric out of the result line.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import re
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(base: str, *parts: str) -> dict:
    with open(os.path.join(base, *parts)) as f:
        return json.load(f)


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def cell(name: str, base: str = HERE) -> dict:
    return _json(base, "workloads", check_name(name) + ".json")


def config(name: str, base: str = HERE) -> dict:
    return _json(base, "configs", check_name(name) + ".json")


def traffic(name: str):
    """The traffic driver module ``traffic/<name>.py``."""
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", name):
        raise ValueError(f"not a traffic driver name: {name!r}")
    return importlib.import_module(f"benchmark.traffic.{name}")


def _load_file(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: str = HERE):
    """The reader module ``metrics/<name>.py``."""
    path = os.path.join(base, "metrics", check_name(name) + ".py")
    return _load_file(path, "benchmark_metric_" + re.sub(r"\W", "_", name))


def spec(path: Optional[str] = None) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    without ``--trace``, the per-layer ones with it."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows if cell_name in m.get("workloads", [cell_name])]


class Run:
    """One run of one cell: its arguments, its clock and its host spans.

    ``spans[name]`` holds the seconds of each ``timed(name)`` block;
    while ``window`` (a ``trace.Window``) is set, the block is also given
    to it as a host span."""

    def __init__(self, cell_name: str, seed: int, seconds: float, trace: bool, device,
                 workdir: str, t0: float, overrides: Optional[dict] = None):
        self.cell_name = cell_name
        self.cell = cell(cell_name)
        self.params = {**self.cell["params"], **(overrides or {})}
        self.config = {**config(self.cell["config"]), **self.params.pop("config", {})}
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.workdir = workdir
        self.t0 = t0
        self.spans: Dict[str, List[float]] = {}
        self.setup_phases: Dict[str, float] = {}
        self.window = None

    @contextlib.contextmanager
    def phase(self, name: str):
        """A part of set-up, timed for the record (not a metric)."""
        t = time.perf_counter()
        yield
        self.setup_phases[name] = self.setup_phases.get(name, 0.0) + time.perf_counter() - t

    @contextlib.contextmanager
    def timed(self, name: str):
        t = time.perf_counter()
        yield
        e = time.perf_counter()
        self.spans.setdefault(name, []).append(e - t)
        if self.window is not None:
            self.window.host_span(name, t, e)


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number that has a limit beside it; a number over its limit, or
    not a number, fails."""
    out = {}
    for name, limit in limits.items():
        value = checks[name]
        ok = value == value and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
