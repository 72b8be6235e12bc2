"""The port's tracer (``repro_torch.obs``): spans only under a running
profiler, nested with their parents and on the profiler's clock, counts
always on and a root's syncs kept on the root, the kernels' launch
counts read through it, and the engine's two traced calls as their span
trees with the host reads their routed sites make."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import kernels, obs
from repro_torch.core import hnsw, machine, state
from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_span_without_a_profiler():
    off = obs.span("a", 3)
    assert off is obs.span("b")
    with off:
        obs.count("x", 2)
    assert obs.spans() == []
    assert obs.counters() == {"x": 2}


def test_spans_nest_and_a_root_keeps_its_syncs():
    t = torch.arange(4)
    with _profiled():
        with obs.span("root", 7):
            obs.host(t)
            with obs.span("a"):
                obs.count("x", 2)
                with obs.span("a.1"):
                    obs.host_item(t[0])
            with obs.span("b"):
                pass
        obs.host(t)  # between roots: the totals only
        with obs.span("root2"):
            pass
    obs.count("x")  # after the profiler: the total only
    got = [(s.name, s.parent, s.items, s.counts) for s in obs.spans()]
    assert got == [("root", None, 7, {"sync": 2, "sync_bytes": 40}),
                   ("a", 0, 0, None), ("a.1", 1, 0, None), ("b", 0, 0, None),
                   ("root2", None, 0, {"sync": 0, "sync_bytes": 0})]
    assert obs.counters() == {"x": 3, "sync": 3, "sync_bytes": 72}
    sp = obs.spans()
    for s in sp:
        assert 0 < s.start <= s.end
        if s.parent is not None:
            p = sp[s.parent]
            assert p.start <= s.start and s.end <= p.end
    obs.reset("x")
    assert obs.counters() == {"sync": 3, "sync_bytes": 72}
    assert len(obs.spans()) == 5
    obs.reset()
    assert obs.counters() == {} and obs.spans() == []


def test_host_reads_are_counted_with_their_bytes():
    t = torch.arange(12, dtype=torch.int64)
    assert torch.equal(obs.host(t), t)
    assert obs.host_item(t.sum()) == 66
    assert obs.counters() == {"sync": 2, "sync_bytes": 12 * 8 + 8}


def test_a_span_shares_the_profilers_clock():
    """A span opened inside a ``record_function`` range lies inside that
    range's times in the profiler's events."""
    with _profiled() as prof:
        for _ in range(3):
            with record_function("outer"):
                with obs.span("inner"):
                    torch.ones(4).sum()
                time.sleep(0.001)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "outer")
    inner = [(s.start, s.end) for s in obs.spans()]
    assert len(ranges) == len(inner) == 3
    for (a, b), (s, e) in zip(ranges, inner):
        assert a <= s <= e <= b


def test_launch_counts_read_the_tracer():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"qboundary": 0, "qgemm": 0,
                                       "qtopk": 0, "qcoarse": 0}
    assert kernels.graph_launch_counts() == {"qhnsw_search": 0,
                                             "qhnsw_insert": 0}
    obs.count("launch.qgemm", 2)
    obs.count("launch.qhnsw_insert")
    obs.count("sync")
    assert kernels.launch_counts() == {"qboundary": 0, "qgemm": 2,
                                       "qtopk": 0, "qcoarse": 0}
    assert kernels.graph_launch_counts() == {"qhnsw_search": 0,
                                             "qhnsw_insert": 1}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.graph_launch_counts().values()) == {0}
    assert obs.counters() == {"sync": 1}
    for mod in ("qboundary", "qgemm", "qtopk", "qcoarse", "qhnsw"):
        ops = __import__(f"repro_torch.kernels.{mod}.ops",
                         fromlist=["ops"])
        assert not hasattr(ops, "LAUNCHES")


def _tree(spans, root):
    """(name, items, counts, children) of ``spans[root]``."""
    kids = [i for i, s in enumerate(spans) if s.parent == root]
    s = spans[root]
    return (s.name, s.items, s.counts, [_tree(spans, k) for k in kids])


def test_the_engines_calls_are_their_span_trees(monkeypatch):
    """Each ``insert_documents`` and ``retrieve`` of a CPU engine, with F's
    graph kept as on the card (one link launch per run), records the
    span tree of the layers and the reads of its routed sites: F's
    mirrors (ids, valid, links, meta, levels), its four scalars, the
    log's four fields and the batch's ids; the cursor, the live count and
    the two answers of a read."""
    monkeypatch.setattr(state, "graph_on_host", lambda device: False)
    monkeypatch.setattr(machine, "graph_on_host", lambda device: False)
    # on the card the link is one launch; here the plain version, whose
    # reads are its own: kept apart
    in_link = {"sync": 0, "sync_bytes": 0}
    link_plain = hnsw._link

    def _link(lanes):
        before = obs.counters()
        link_plain(lanes)
        for k in in_link:
            in_link[k] += obs.counters().get(k, 0) - before.get(k, 0)
    monkeypatch.setattr(hnsw, "_link", _link)
    d, n, b = 16, 8, 3
    eng = MemoryAugmentedEngine(d, ServeConfig(capacity=64), device="cpu")
    eng.insert_documents(torch.randn(n, d))  # outside the profiler
    assert obs.spans() == []
    in_link.update(sync=0, sync_bytes=0)
    with _profiled():
        eng.insert_documents(torch.randn(n, d))
        eng.retrieve(torch.randn(b, d), k=2)
    sp = obs.spans()
    roots = [i for i, s in enumerate(sp) if s.parent is None]
    assert [sp[i].name for i in roots] == ["engine.insert_documents",
                                           "engine.retrieve"]
    ins, ret = (_tree(sp, i) for i in roots)
    link = ins[3][1][3][0]
    assert link[:3] == ("hnsw.link", 0, None) and link[3] == []
    mirrors = 64 * (8 + 1 + 4 * 4 + 2 * 8 + 4) + 4 + 4 + 4 + 8
    log = n * (4 + 8 + 8 + 8) + n * 8
    assert ins == ("engine.insert_documents", n,
                   {"sync": 15 + in_link["sync"],
                    "sync_bytes": mirrors + log + 8 * n
                    + in_link["sync_bytes"]}, [
                       ("lm.embed", 0, None, []),
                       ("machine.bulk_apply", 0, None, [link])])
    assert ret == ("engine.retrieve", b,
                   {"sync": 4, "sync_bytes": 8 + 8 + 2 * b * 2 * 8}, [
                       ("boundary.admit", 0, None, []),
                       ("query.plan", 0, None, []),
                       ("query.execute", 0, None, []),
                       ("engine.copy_out", 0, None, [])])
    assert eng.last_plan.route == "exact"
