"""The program's own spans (``repro_torch.obs``) on the trace's clock.

While a traced run's profiler records, the port's tracer records a root
span for each public call of the engine (``engine.retrieve``,
``engine.insert_documents``) and a span for each layer under it, stamped
with ``time.time_ns()``, the clock the profiler converts its own
timestamps to. The harness's span of the i-th call of an operation
(``ctx.spans``, on the trace's clock less the trace's first timestamp)
encloses the program's i-th root span of the window, so the one clock
offset between them (program time less trace time) lies in each call's
bracket: at least ``end_prog - end_bench``, at most ``start_prog -
start_bench``. The midpoint of all the brackets' intersection places
every call's spans on the trace's clock. The card's idle time inside the
harness's span (the gaps of ``ctx.trace.timeline``) then goes to the
innermost program span open at that moment, or to the harness where
none is.

``calls`` returns None where the window has none of the root spans, or
the program has no tracer: a metric that reads it reads nothing there.
"""
from __future__ import annotations

import bisect
import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

HARNESS = ""        # the idle time outside the program's root span
SLACK_NS = 20_000   # how far a bracket may be empty before it is an error
STALE_S = 1e-3      # roots starting this long before the window are older


@dataclasses.dataclass
class Call:
    """One call of the program inside one harness span."""
    items: int                  # the root span's items
    idle: Dict[str, float]      # seconds of card idle time by innermost
                                # program span's name (HARNESS: none open)
    counts: Dict[str, int]      # the root span's syncs and bytes


def offset(bench: Sequence[Tuple[float, float]],
           roots: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """The clock offset in ns and the width in ns of the brackets'
    intersection: ``bench`` the harness's spans (start, end) in seconds
    on the trace's clock, ``roots`` the program's root spans (start, end)
    in ns, in call order. Raises where the counts differ or the
    intersection is empty by more than ``SLACK_NS``."""
    if len(bench) != len(roots):
        raise RuntimeError(f"{len(roots)} program root spans in the window "
                           f"against {len(bench)} harness spans")
    lo = max(ep - round(eb * 1e9) for (_, eb), (_, ep) in zip(bench, roots))
    hi = min(sp - round(sb * 1e9) for (sb, _), (sp, _) in zip(bench, roots))
    if lo - hi > SLACK_NS:
        raise RuntimeError(f"no one clock offset places every program span "
                           f"in its harness span: the brackets miss by "
                           f"{(lo - hi) / 1e3:.1f} us")
    return (lo + hi) // 2, hi - lo


def window(bench: Sequence[Tuple[float, float]],
           roots: Sequence[Tuple[int, int]]) -> List[int]:
    """Indices of the roots of the traced window: the last root lies in
    the last harness span, and on that call's clock the window's roots
    start no earlier than the first harness span, less ``STALE_S``
    (roots of an earlier traced run in the same process start before)."""
    if not bench or not roots:
        return []
    anchor = offset(bench[-1:], roots[-1:])[0]
    first = round((bench[0][0] - STALE_S) * 1e9) + anchor
    return [j for j, (sp, _) in enumerate(roots) if sp >= first]


def gaps(timeline, a: float, b: float) -> List[Tuple[float, float]]:
    """``timeline.gaps(a, b)``, starting from the interval at ``a``: the
    harness's walks every interval from the window's start, which is too
    slow once per call over a whole window."""
    iv, out, cur = timeline.iv, [], a
    for j in range(max(bisect.bisect_right(timeline.starts, a) - 1, 0),
                   len(iv)):
        s, e = iv[j]
        if s >= b:
            break
        if e <= a:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < b:
        out.append((cur, b))
    return out


def split_idle(timeline, start: float, end: float,
               tree: Sequence[Tuple[float, float, int, str]]
               ) -> Dict[str, float]:
    """The card's idle seconds inside [start, end], by the innermost span
    of ``tree`` ((start, end, depth, name) on the trace's clock) open at
    that moment, HARNESS where none is."""
    out: Dict[str, float] = {}
    for g0, g1 in gaps(timeline, start, end):
        cuts = sorted({g0, g1} | {t for a, b, _, _ in tree for t in (a, b)
                                  if g0 < t < g1})
        for t0, t1 in zip(cuts, cuts[1:]):
            mid = 0.5 * (t0 + t1)
            open_ = [(d, n) for a, b, d, n in tree if a <= mid <= b]
            name = max(open_)[1] if open_ else HARNESS
            out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def _subtree(spans, children, root: int):
    """(index, depth) of ``root`` and every span under it."""
    out, todo = [], [(root, 0)]
    while todo:
        i, d = todo.pop()
        out.append((i, d))
        todo.extend((c, d + 1) for c in children.get(i, ()))
    return out


def _calls(ctx, root: str, op: str) -> Optional[List[Call]]:
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.spans()
    idx = [i for i, s in enumerate(spans) if s.name == root
           and s.parent is None]
    ours = [s for s in ctx.spans if s.name == op]
    if not idx or not ours:
        return None
    bench = [(s.start, s.end) for s in ours]
    roots = [(spans[i].start, spans[i].end) for i in idx]
    keep = window(bench, roots)
    idx = [idx[j] for j in keep]
    off = offset(bench, [roots[j] for j in keep])[0]
    children: Dict[int, list] = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            children.setdefault(s.parent, []).append(i)
    out = []
    for b, r in zip(ours, idx):
        tree = [((spans[i].start - off) * 1e-9, (spans[i].end - off) * 1e-9,
                 d, spans[i].name) for i, d in _subtree(spans, children, r)]
        out.append(Call(spans[r].items,
                        split_idle(ctx.trace.timeline, b.start, b.end, tree),
                        dict(spans[r].counts or {})))
    return out


_memo: Dict[Tuple[str, str], tuple] = {}


def calls(ctx, root: str, op: str) -> Optional[List[Call]]:
    """The program's ``root`` calls inside the window's ``op`` spans, one
    per span, or None (see the module's docstring); read once per
    context."""
    hit = _memo.get((root, op))
    if hit is not None and hit[0]() is ctx:
        return hit[1]
    out = _calls(ctx, root, op)
    _memo[(root, op)] = (weakref.ref(ctx), out)
    return out


def mean_idle_ms(ctx, root: str, op: str, name: str) -> Optional[float]:
    """Mean card-idle ms a call inside the innermost span ``name``."""
    got = calls(ctx, root, op)
    if not got:
        return None
    return 1e3 * sum(c.idle.get(name, 0.0) for c in got) / len(got)
