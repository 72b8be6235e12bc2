"""The port's tracer: spans of its layers and counts of their host work.

Spans record while a ``torch.profiler`` session records, and at no other
time: ``span`` checks the profiler's flag once and, off, returns one
shared no-op context. A span keeps its name, its start and end in
nanoseconds from ``time.time_ns()`` (the clock the profiler converts its
host and device timestamps to, so spans sit on the trace's clock), the
index of its parent span and the items it handles (queries, documents).
Spans open on one thread nest under each other; a span opened with none
open is a root, one per public call of the engine (``engine.*``), and
keeps the ``sync`` and ``sync_bytes`` counted while it was open (the
process-wide totals' rise). They stay in memory until ``reset``.

Counts are always on: ``count`` adds to a process-wide total. ``host``
and ``host_item`` are the device-to-host reads of the traced paths,
counted as ``sync`` (once a read) and ``sync_bytes``; the kernels'
launches count as ``launch.<kernel>``.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        engine.retrieve(queries)
    obs.spans()     # [Span("engine.retrieve", ...), Span("boundary.admit",
                    #  ...), ...], each root followed by what it called;
                    # the root's counts {"sync": 4, "sync_bytes": ...}
    obs.counters()  # {"sync": 4, "sync_bytes": ..., "launch.qboundary": 1}
    obs.reset()
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import torch

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_spans: List["Span"] = []
_totals: Dict[str, int] = {}
_local = threading.local()
_lock = threading.Lock()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start: int                # time.time_ns() at entry
    end: int                  # time.time_ns() at exit (0 while open)
    parent: Optional[int]     # index in spans() of the enclosing span
    items: int = 0
    counts: Optional[Dict[str, int]] = None  # a root's syncs, at its exit


_ROOT_COUNTS = ("sync", "sync_bytes")


class _Open:
    """The context of one recorded span."""
    __slots__ = ("rec", "stack", "before")

    def __init__(self, name: str, items: int):
        self.rec = Span(name, 0, 0, None, int(items))
        self.before = None

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        with _lock:
            if stack:
                self.rec.parent = stack[-1]
            else:
                self.before = [_totals.get(k, 0) for k in _ROOT_COUNTS]
            stack.append(len(_spans))
            _spans.append(self.rec)
        self.rec.start = time.time_ns()
        return self.rec

    def __exit__(self, *exc) -> None:
        self.rec.end = time.time_ns()
        self.stack.pop()
        if self.before is not None:
            with _lock:
                self.rec.counts = {k: _totals.get(k, 0) - b for k, b
                                   in zip(_ROOT_COUNTS, self.before)}


def span(name: str, items: int = 0):
    """A context that records a span named ``name`` while a profiler
    records, and does nothing otherwise."""
    if not _recording():
        return _OFF
    return _Open(name, items)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _totals[name] = _totals.get(name, 0) + n


def _sync(nbytes: int) -> None:
    count("sync")
    count("sync_bytes", nbytes)


def host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted as one ``sync`` of ``t``'s bytes on any
    device."""
    _sync(t.nbytes)
    return t.cpu()


def host_item(t: torch.Tensor):
    """``t.item()``, the scalar read behind ``int()`` or ``bool()`` of a
    tensor, counted as ``host`` counts."""
    _sync(t.element_size())
    return t.item()


def spans() -> List[Span]:
    """The spans recorded since the last ``reset``, in the order they
    opened."""
    return list(_spans)


def counters() -> Dict[str, int]:
    """The totals of every counter since it was last reset."""
    return dict(_totals)


def reset(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix``; with no prefix
    every counter, and forget the spans."""
    with _lock:
        if not prefix:
            _spans.clear()
            _totals.clear()
            return
        for name in [n for n in _totals if n.startswith(prefix)]:
            del _totals[name]
