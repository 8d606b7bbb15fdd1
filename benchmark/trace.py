"""A ``torch.profiler`` window reduced to what the per-layer metrics read.

On a card the profiler records device activity only (CUDA kernels and
copies through CUPTI), with no host operators, so that it slows the host's
dispatch as little as it can. ``busy_s`` is the union of the kernel and
copy intervals (user annotations, which span kernels already counted, are
left out), the arithmetic of the program's
``tools/profile_serve.device_summary``; each kernel name goes to the first
kernel group (``kernel_groups/*.json``, lowest ``priority`` first) one of
whose patterns it contains, else to ``other``. The harness's host spans
are kept on the host's clock (``Window.host_span``) and laid on the
device's by the window's first operation, a one-element fill launched just
after a synchronize: an idle gap between two device intervals is put down
to the innermost host span open at its middle.

"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GROUP_DIR = os.path.join(HERE, "kernel_groups")


def kernel_groups(directory: str = GROUP_DIR) -> List[Tuple[str, dict]]:
    """(name, spec) of every kernel group file, in matching order."""
    groups = []
    for f in sorted(os.listdir(directory)):
        if f.endswith(".json"):
            with open(os.path.join(directory, f)) as fh:
                groups.append((f[:-5], json.load(fh)))
    return sorted(groups, key=lambda g: (g[1]["priority"], g[0]))


def group_of(name: str, groups) -> str:
    low = name.lower()
    return next((g for g, spec in groups if any(p in low for p in spec["patterns"])), "other")


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(prof, wall_s: float, host_spans=(), t_mark: float = 0.0,
              groups=None) -> Dict:
    """Busy seconds, device seconds and launches by group, the top device
    operations, and idle seconds by the host span that was open.
    ``host_spans``: (name, start, end) in seconds of the host's clock, on
    which ``t_mark`` is the launch of the window's first device operation."""
    groups = kernel_groups() if groups is None else groups
    by_name: Dict[str, List[float]] = {}
    dev = []
    for ev in prof.events():
        t = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False):
                continue
            rec = by_name.setdefault(ev.name, [0.0, 0])
            rec[0] += t.elapsed_us() / 1e6
            rec[1] += 1
            dev.append((t.start, t.end))
    busy = _union(dev)
    offset = (busy[0][0] - t_mark * 1e6) if busy else 0.0  # host us -> device us
    host = [(s * 1e6 + offset, e * 1e6 + offset, name) for name, s, e in host_spans]
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        open_ = [(e - s, name) for s, e, name in host if s <= mid <= e]
        name = min(open_)[1] if open_ else "outside the benchmark's spans"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
    group_s: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    for name, (s, n) in by_name.items():
        g = group_of(name, groups)
        group_s[g] = group_s.get(g, 0.0) + s
        launches[g] = launches.get(g, 0) + n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall_s, "busy_s": sum(e - s for s, e in busy) / 1e6,
            "group_s": group_s, "launches": launches,
            "device_ops": [[n[:120], v[0]] for n, v in top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10]}


class Window:
    """``with Window(device) as w:`` profiles a block: what runs before
    ``w.start()`` warms the profiler up and is dropped; what runs after it,
    up to a synchronize, is the window; ``w.summary`` is ``summarize`` of it.
    ``w.host_span(name, start, end)`` keeps a host span of the window."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.summary = None
        self._start = None
        self._spans: List[Tuple[str, float, float]] = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        cuda = self.device.type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU],
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self._prof.__enter__()
        return self

    def start(self):
        self._sync()
        self._prof.step()
        self._spans.clear()
        self._start = time.perf_counter()
        if self.device.type == "cuda":
            torch.ones(1, device=self.device)  # the window's first device operation

    def host_span(self, name: str, start: float, end: float):
        if self._start is not None:
            self._spans.append((name, start, end))

    def __exit__(self, *exc):
        self._sync()
        wall = time.perf_counter() - self._start if self._start is not None else 0.0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof, wall, self._spans, self._start)
        return False
