"""Progress-line formatting, the drivers' profiler scope, and the program's
spans and counters (the JAX package's ``utils/timing.py``, extended).

``time_show`` keeps value parity with the reference progress formatter
(CommonFunc.py:226-243): seconds -> "1d 2h 3m 4.5s". ``maybe_profile`` is
the counterpart of the JAX ``maybe_profile`` (:54-62): a ``torch.profiler``
trace of the block, written into a directory.

The recorder: ``span(name)`` marks a phase of the program on the host's
``time.perf_counter()`` clock, ``count(name, n)`` adds to a named counter.
Both do nothing unless a ``recording()`` block is open, which turns them on
and hands back what they recorded (a ``Recording``). Off, ``span`` returns
one shared object after one check, and reads no clock. A span never
synchronizes the device: it times the host's enqueue of the work inside
it. ``maybe_profile`` records too, and then each span also enters
``torch.profiler.record_function``, so the phases show on the trace's
timeline beside the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, NamedTuple, Optional

MAX_SPANS = 65536


class Span(NamedTuple):
    """One closed span: ``start`` and ``end`` in seconds of
    ``time.perf_counter()``; ``parent`` is the ``id`` of the span that was
    open around it on the same ``thread`` (its ident), or None."""
    name: str
    start: float
    end: float
    parent: Optional[int]
    thread: int
    id: int


class Recording:
    """What one ``recording()`` block recorded: the last ``max_spans``
    spans in the order they closed (``dropped`` counts the older ones let
    go) and the counters."""

    def __init__(self, max_spans: int = MAX_SPANS, annotate: bool = False):
        self.spans: "collections.deque[Span]" = collections.deque(maxlen=max_spans)
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.annotate = annotate
        self._lock = threading.Lock()
        self._ids = itertools.count()

    def _add(self, s: Span) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def self_seconds(self) -> Dict[int, float]:
        """Each recorded span's seconds less those of its recorded children,
        by ``id``."""
        out = {s.id: s.end - s.start for s in self.spans}
        for s in self.spans:
            if s.parent in out:
                out[s.parent] -= s.end - s.start
        return out


_recording: Optional[Recording] = None
_open = threading.local()  # .stack: the ids of the spans open on this thread


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "start", "annotation")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.annotation = None
        if self.rec.annotate:
            import torch

            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _open.stack.pop()
        self.rec._add(Span(self.name, self.start, end, self.parent, threading.get_ident(),
                           self.id))
        return False


def span(name: str):
    """``with span(name):`` records the block as a span while a
    ``recording()`` is open; otherwise the shared no-op."""
    rec = _recording
    if rec is None:
        return _NULL
    return _Span(rec, name)


def open_ids() -> tuple:
    """The ids of the spans open on this thread, outermost first."""
    return tuple(getattr(_open, "stack", None) or ())


@contextlib.contextmanager
def within(ids: tuple) -> Iterator[None]:
    """Spans opened on this thread inside the block nest under ``ids`` (an
    ``open_ids()`` of another thread), as if they were opened there: a
    worker's spans under the span that started the worker. Such a child
    overlaps its parent's children on the other thread, so the parent's
    ``self_seconds`` may come out below zero."""
    before = getattr(_open, "stack", None)
    _open.stack = list(ids)
    try:
        yield
    finally:
        _open.stack = before if before is not None else []


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a ``recording()`` is open."""
    rec = _recording
    if rec is not None:
        rec._count(name, n)


@contextlib.contextmanager
def recording(max_spans: int = MAX_SPANS, annotate: bool = False) -> Iterator[Recording]:
    """Record the spans and counters of every thread for the block, into
    the ``Recording`` it yields (kept in memory; nothing is written).
    ``annotate``: each span also enters ``torch.profiler.record_function``.
    An inner block records alone until it closes."""
    global _recording
    outer, rec = _recording, Recording(max_spans, annotate)
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer


@contextlib.contextmanager
def maybe_profile(logdir: Optional[str], cuda: bool = True) -> Iterator[Optional[Recording]]:
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA
    ones when ``cuda``) written into ``logdir`` as a TensorBoard/Chrome
    ``*.pt.trace.json`` when the block ends, with the program's spans on
    its timeline (the block is a ``recording(annotate=True)``, which it
    yields); nothing without ``logdir``."""
    if not logdir:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        with recording(annotate=True) as rec:
            yield rec


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
