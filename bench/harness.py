"""The benchmark's core: cells found by name, the parts they are made of
found by name, spans, the end-to-end arithmetic, the trace's reduction
and the result line.

Everything that belongs to one configuration, one traffic mix, one
operation, one engine kind or one per-layer metric is a file of its own,
found by the name that ``BENCHMARK.json`` or the file before it gives:

* ``configs/<config>.json``: the system under test; its ``"engine"``
  names the engine kind;
* ``engines/<kind>.py``: ``build(config, device, seed)`` -> the system,
  ``check(outputs)`` -> the comparison with the plain reference, its
  ``LIMITS``, and ``control()`` -> the context a control run runs in;
* ``traffic/<mix>.json``: the fill, one cycle of the closed loop and the
  data; each entry of the cycle names its operation;
* ``ops/<op>.py``: ``Op(workload)`` with ``warm(entries)`` for set-up,
  ``run(entry)`` for one call in the window and ``check(outputs)``, and
  its ``LIMITS``; a configuration's ``check_limits`` add to both;
* ``data/<kind>.py``: the mix's data (``generator``);
* ``metrics/<metric>.py``: ``read(ctx)`` -> a number, or None where the
  run has nothing for it to read.

A name with no file is an error before anything runs.

The end-to-end arithmetic is fixed here and keyed by the metric's name:
``<op>_p<q>_ms`` is the q-th percentile (nearest rank) of every ``<op>``
call of the window; ``<op>_<unit>_per_s`` and ``<op>_qps`` are all the
items of every ``<op>`` call over the whole window; ``setup_s`` is
process start to window start. One call of the system is one span,
named by its operation. A suffix after a dot names the same arithmetic
for cells that need a bound of their own.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import random
import re
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# --------------------------------------------------------------------------- #
# finding a cell's parts by name
# --------------------------------------------------------------------------- #


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict     # configs/<config>.json
    mix: dict        # traffic/<mix>.json
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    return Cell(name, config, mix, int(w["chips"]),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def part(folder: str, name: str):
    """The module ``bench/<folder>/<name>.py`` (an operation, an engine
    kind or a data kind)."""
    if not name.isidentifier() or not (BENCH_DIR / folder
                                       / f"{name}.py").is_file():
        raise ValueError(f"no {folder} part named {name!r}: it would be "
                         f"bench/{folder}/{name}.py")
    return importlib.import_module(f"bench.{folder}.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Span:
    name: str              # the operation: ingest, read, ...
    index: int             # order among this op's calls
    items: int             # documents, queries or tokens
    start: float           # seconds (host clock; the trace's in a traced run)
    end: float
    busy: Optional[float] = None   # device seconds under the span (traced)
    parent: Optional[int] = None   # index in Recorder.spans

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Recorder:
    """Spans around the system's public calls, kept in memory. In a traced
    run each is also a ``torch.profiler.record_function`` range named
    ``bench.<op>``, so that the trace carries it on its own clock."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self.spans: List[Span] = []
        self._open: List[int] = []
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, items: int):
        idx = self._count.get(name, 0)
        self._count[name] = idx + 1
        sp = Span(name, idx, int(items), 0.0, 0.0,
                  parent=self._open[-1] if self._open else None)
        self.spans.append(sp)
        self._open.append(len(self.spans) - 1)
        ctx = contextlib.nullcontext()
        if self.profiled:
            import torch
            ctx = torch.profiler.record_function(f"bench.{name}")
        with ctx:
            sp.start = time.perf_counter()
            try:
                yield sp
            finally:
                sp.end = time.perf_counter()
                self._open.pop()


class Reservoir:
    """A seeded uniform sample of at most ``size`` items of a stream whose
    length is known only at its end."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.items = size, 0, []
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1

    def clear(self) -> None:
        self.seen, self.items = 0, []


# --------------------------------------------------------------------------- #
# end-to-end arithmetic
# --------------------------------------------------------------------------- #


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of
    the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def end_to_end(name: str, spans: List[Span], window_s: float,
               setup_s: float) -> Optional[float]:
    name = name.split(".", 1)[0]
    if name == "setup_s":
        return setup_s
    m = re.fullmatch(r"([a-z]+)_p(\d+)_ms", name)
    if m:
        durs = [s.seconds for s in spans if s.name == m.group(1)]
        return 1e3 * percentile(durs, float(m.group(2))) if durs else None
    m = re.fullmatch(r"([a-z]+)_(?:[a-z]+_per_s|qps)", name)
    if m:
        items = sum(s.items for s in spans if s.name == m.group(1))
        return items / window_s if items else None
    raise ValueError(f"no end-to-end arithmetic for {name!r}")


def window_bounds(spans: List[Span]):
    top = [s for s in spans if s.parent is None]
    return min(s.start for s in top), max(s.end for s in top)


# --------------------------------------------------------------------------- #
# the device timeline
# --------------------------------------------------------------------------- #


def merge(intervals) -> List[tuple]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class Timeline:
    """Device activity as a merged union, with the covered time of any
    interval in O(log n)."""

    def __init__(self, intervals):
        self.iv = merge(intervals)
        self.starts = [a for a, _ in self.iv]
        self.cum = [0.0]
        for a, b in self.iv:
            self.cum.append(self.cum[-1] + (b - a))

    def covered(self, a: float, b: float) -> float:
        """Seconds of device activity inside [a, b]."""
        if b <= a or not self.iv:
            return 0.0
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        s0, e0 = self.iv[i]
        total -= max(0.0, min(e0, a) - s0)        # the head before a
        s1, e1 = self.iv[j - 1]
        total -= max(0.0, e1 - max(s1, b))        # the tail after b
        return max(total, 0.0)

    def gaps(self, a: float, b: float) -> List[tuple]:
        """Idle intervals inside [a, b]."""
        out, cur = [], a
        for s, e in self.iv:
            if e <= a:
                continue
            if s >= b:
                break
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if cur < b:
            out.append((cur, b))
        return out


@dataclasses.dataclass
class Trace:
    """What a traced run's reduction yields."""
    timeline: Timeline
    busy_s: float
    window_s: float
    device_ops: List[list]
    idle_gaps: List[list]


def reduce_trace(device_events, host_events, spans: List[Span]) -> Trace:
    """``device_events``: (start_s, end_s, name) of every kernel, copy and
    set on the card; ``host_events``: (start_s, end_s, name, top) of the
    host's ranges (``bench.<op>`` annotations and operators; ``top`` marks
    an operator called from the harness or a span directly). Moves the
    spans onto the trace's clock and fills in their device time."""
    ann = sorted((e for e in host_events if e[2].startswith("bench.")),
                 key=lambda e: e[0])
    by_name: Dict[str, list] = {}
    for a, b, name, _ in ann:
        by_name.setdefault(name[len("bench."):], []).append((a, b))
    for name in {s.name for s in spans}:
        mine = [s for s in spans if s.name == name]
        got = by_name.get(name, [])
        if len(got) != len(mine):
            raise RuntimeError(f"trace has {len(got)} bench.{name} ranges, "
                               f"the run {len(mine)}")
        for s, (a, b) in zip(mine, got):
            s.start, s.end = a, b
    tl = Timeline((a, b) for a, b, _ in device_events)
    for s in spans:
        s.busy = tl.covered(s.start, s.end)
    w0, w1 = window_bounds(spans)
    busy = tl.covered(w0, w1)
    per_op: Dict[str, float] = {}
    for a, b, name in device_events:
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            per_op[name] = per_op.get(name, 0.0) + (hi - lo)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tl.gaps(w0, w1), key=lambda g: g[0] - g[1])[:10]
    tops = sorted((e for e in host_events
                   if e[3] and not e[2].startswith("bench.")),
                  key=lambda e: e[0])
    top_starts = [e[0] for e in tops]
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s.start <= mid <= s.end]
        where = inner[-1].name if inner else "harness"
        best, best_ov = None, 0.0
        k = bisect.bisect_right(top_starts, b)
        for e in tops[max(0, k - 64):k]:
            ov = min(e[1], b) - max(e[0], a)
            if ov > best_ov:
                best, best_ov = e[2], ov
        labelled.append([f"{where}:{best}" if best else where, b - a])
    return Trace(tl, busy, w1 - w0, [list(x) for x in ops], labelled)


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("user_annotation", "cpu_op")


def _activity(e) -> str:
    """A trace event's kind; where the profiler's events do not name it
    (older PyTorch), from the device and the ``bench.`` prefix."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    from torch.autograd import DeviceType
    span = e.name().startswith("bench.")
    if e.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if span else "kernel"
    return "user_annotation" if span else "cpu_op"


def profiler_events(prof):
    """(device events, host events) of a ``torch.profiler`` run, in
    seconds on the trace's clock: every kernel, copy and set on the card,
    and the host's ``bench.<op>`` ranges and operators, each operator
    marked ``top`` where no other operator encloses it."""
    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)
    dev, host = [], []
    for e in raw:
        kind = _activity(e)
        a = (e.start_ns() - base) * 1e-9
        b = a + e.duration_ns() * 1e-9
        if kind in DEVICE_ACTIVITIES:
            dev.append((a, b, e.name()))
        elif kind in HOST_ACTIVITIES:
            host.append((a, b, e.name()))
    host.sort(key=lambda h: (h[0], -h[1]))
    marked, stack = [], []
    for a, b, name in host:
        while stack and stack[-1][1] <= a:
            stack.pop()
        inside = [n for _, _, n in stack if not n.startswith("bench.")]
        marked.append((a, b, name, not inside))
        stack.append((a, b, name))
    return dev, marked


# --------------------------------------------------------------------------- #
# per-layer metrics and the result line
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Outputs:
    """What a run hands the check once its window has closed: the
    program's state as host arrays (its memory freed), the workload's
    record of what it sent and got, and the generator to draw the same
    inputs again. ``rows`` is set by the engine kind's check: the
    memory's rows as the reference has them, for the operations' checks."""
    cell: Cell
    workload: object
    gen: object
    state: dict
    seed: int
    device: object
    control: bool
    rows: object = None


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads."""
    cell: Cell
    spans: List[Span]
    trace: Trace
    work: dict      # the reference's counts of the checked calls' work
    system: dict    # static facts of the system under test (sizes)


def per_layer(cell: Cell, ctx: Context) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that no run may load, compared
    whole (``repro_torch`` is the port, ``repro`` the JAX package)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
