"""The program's spans on the trace's clock (``bench/program_spans.py``):
the one offset and its errors, the window's roots, the card's idle time
by innermost span, on synthetic spans and timelines; then tiny traced
runs that read every metric of the program's spans."""
import random

import pytest

import _tiny
from bench import harness, program_spans
from repro_torch import obs

NS = 10**9
BASE = 1_700_000_000 * NS   # the program's clock at the trace's zero


def test_one_offset_at_the_middle_of_the_brackets_intersection():
    bench = [(1.0, 1.010), (2.0, 2.004)]
    # the first program span 6 us inside each end: bracket [-6, 6] us;
    # the second 1 us after the start, 3 us before the end: [-3, 1]
    roots = [(BASE + NS + 6_000, BASE + NS + 10_000_000 - 6_000),
             (BASE + 2 * NS + 1_000, BASE + 2 * NS + 4_000_000 - 3_000)]
    assert program_spans.offset(bench, roots) == (BASE - 1_000, 4_000)
    assert program_spans.offset(bench[:1], roots[:1]) == (BASE, 12_000)


def test_a_count_mismatch_and_an_empty_intersection_raise():
    bench = [(1.0, 1.010), (2.0, 2.004)]
    roots = [(BASE + NS, BASE + NS + 9_000_000)]
    with pytest.raises(RuntimeError, match="1 program root spans"):
        program_spans.offset(bench, roots)
    # each bracket holds an offset, but none holds both: [20, 30] us and
    # [-10, -5] us miss by 25 us
    apart = [(BASE + NS + 30_000, BASE + NS + 10_020_000),
             (BASE + 2 * NS - 5_000, BASE + 2 * NS + 3_990_000)]
    with pytest.raises(RuntimeError, match="miss by 25.0 us"):
        program_spans.offset(bench, apart)
    # one 15 us longer than the harness's span passes (the slack), at the
    # middle of its empty bracket
    slack = [(BASE + NS, BASE + NS + 10_015_000)]
    assert program_spans.offset(bench[:1], slack) == (BASE + 7_500, -15_000)


def test_the_window_drops_an_earlier_runs_roots():
    bench = [(1.0, 1.010), (2.0, 2.004)]
    roots = [(BASE - 3 * NS, BASE - 3 * NS + 5_000_000),   # an earlier run
             (BASE + NS + 1_000, BASE + NS + 9_000_000),
             (BASE + 2 * NS + 1_000, BASE + 2 * NS + 3_000_000)]
    assert program_spans.window(bench, roots) == [1, 2]
    assert program_spans.window([], roots) == []


def test_idle_time_goes_to_the_innermost_open_span():
    tl = harness.Timeline([(0.002, 0.004), (0.0065, 0.0075)])
    tree = [(0.001, 0.009, 0, "root"), (0.0015, 0.003, 1, "a"),
            (0.005, 0.008, 1, "b"), (0.006, 0.007, 2, "b.1")]
    got = program_spans.split_idle(tl, 0.0, 0.010, tree)
    want = {program_spans.HARNESS: 0.001 + 0.001, "a": 0.0005,
            "root": 0.0005 + 0.001 + 0.001, "b": 0.001 + 0.0005,
            "b.1": 0.0005}
    assert set(got) == set(want)
    for name, v in want.items():
        assert got[name] == pytest.approx(v, abs=1e-12), name
    assert sum(got.values()) == pytest.approx(
        0.010 - tl.covered(0.0, 0.010), abs=1e-12)


def test_the_gaps_walk_from_the_window_as_the_harness_does():
    rng = random.Random(5)
    iv, t = [], 0.0
    for _ in range(2000):
        d = rng.uniform(1e-6, 3e-4)
        iv.append((t, t + d))
        t += d + rng.choice([0.0, rng.uniform(1e-6, 3e-4)])
    tl = harness.Timeline(iv)
    for _ in range(300):
        a = rng.uniform(-0.01, t + 0.01)
        b = a + rng.uniform(0, 0.005)
        assert program_spans.gaps(tl, a, b) == tl.gaps(a, b)
    assert program_spans.gaps(harness.Timeline([]), 1.0, 2.0) == [(1.0, 2.0)]


def _span(name, start_us, end_us, parent=None, counts=None, items=0):
    return obs.Span(name, BASE + start_us * 1000, BASE + end_us * 1000,
                    parent, items, counts)


def test_calls_align_the_window_and_keep_each_roots_counts(monkeypatch):
    spans = [_span("engine.retrieve", 10, 990, None, {"sync": 3}, 4),
             _span("boundary.admit", 20, 100, 0),
             _span("engine.copy_out", 500, 980, 0),
             _span("engine.insert_documents", 1010, 1990, None, {}, 2),
             _span("engine.retrieve", 2010, 2990, None, {"sync": 3}, 4),
             _span("engine.copy_out", 2500, 2980, 4)]
    monkeypatch.setattr(obs, "spans", lambda: spans)
    bench = [harness.Span("read", 0, 4, 0.0, 0.001),
             harness.Span("ingest", 0, 2, 0.001, 0.002),
             harness.Span("read", 1, 4, 0.002, 0.003)]
    tl = harness.Timeline([(0.0002, 0.0005), (0.0022, 0.0025)])
    ctx = harness.Context(None, bench, harness.Trace(tl, 0, 0, [], []), {},
                          {})
    got = program_spans.calls(ctx, "engine.retrieve", "read")
    assert [c.counts for c in got] == [{"sync": 3}, {"sync": 3}]
    assert [c.items for c in got] == [4, 4]
    first = got[0].idle
    assert first["boundary.admit"] == pytest.approx(80e-6)
    assert first["engine.retrieve"] == pytest.approx(120e-6)
    assert first["engine.copy_out"] == pytest.approx(480e-6)
    assert first[program_spans.HARNESS] == pytest.approx(20e-6)
    assert program_spans.calls(ctx, "engine.retrieve", "read") is got
    assert program_spans.mean_idle_ms(
        ctx, "engine.retrieve", "read", "engine.copy_out") == \
        pytest.approx(0.48)
    assert program_spans.calls(ctx, "engine.retrieve", "gen") is None
    assert program_spans.calls(ctx, "engine.generate", "read") is None


READ_HOST = ("read_boundary_host_ms", "read_plan_host_ms",
             "read_launch_host_ms", "read_copy_out_host_ms",
             "read_engine_host_ms")


def test_a_traced_search_run_splits_read_host_ms():
    out = _tiny.run("search", trace=True, seconds=0.2)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True
    assert set(READ_HOST) | {"read_syncs"} <= set(m)
    assert all(m[k] > 0 for k in READ_HOST)
    assert sum(m[k] for k in READ_HOST) == pytest.approx(
        m["read_host_ms"], rel=0.05)
    assert sum(m[k] for k in READ_HOST) <= m["read_host_ms"]
    assert m["read_syncs"] >= 4
    assert not {k for k in m if k.startswith("ingest_")}


def test_a_traced_stream_run_reads_the_ingest_metrics():
    out = _tiny.run("stream", trace=True, seconds=0.2)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True
    assert {"ingest_apply_host_ms_per_doc", "ingest_embed_host_ms_per_doc",
            "ingest_syncs", "ingest_d2h_kb_per_doc"} <= set(m)
    assert m["ingest_syncs"] >= 15
    assert m["ingest_apply_host_ms_per_doc"] + \
        m["ingest_embed_host_ms_per_doc"] <= m["ingest_host_ms_per_doc"]
    assert set(READ_HOST) <= set(m)


def test_an_untraced_run_reads_no_program_span():
    out = _tiny.run("search")
    assert not set(READ_HOST) & set(out["metrics"])
