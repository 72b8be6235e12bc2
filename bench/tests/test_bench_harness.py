"""The harness's core: parts found by name, the end-to-end arithmetic and
the trace's reduction, on synthetic spans and timelines."""
import json
import re

import pytest

from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_parts_found_by_name():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        engine = harness.part("engines", cell.config["engine"])
        assert all(callable(getattr(engine, f))
                   for f in ("build", "check", "control"))
        assert isinstance(engine.LIMITS, dict)
        for entry in cell.mix["cycle"]:
            mod = harness.part("ops", entry["op"])
            assert isinstance(mod.LIMITS, dict)
            assert all(callable(getattr(mod.Op, f))
                       for f in ("warm", "run", "check"))
        assert harness.part("data", cell.mix["data"]["kind"]).Data
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    with pytest.raises(SystemExit):
        harness.find_cell(bench, "no.such.cell")
    for folder, name in (("ops", "gen"), ("engines", "lm_dense"),
                         ("data", "../harness"), ("ops", "__init__x")):
        with pytest.raises(ValueError, match=f"no {folder} part"):
            harness.part(folder, name)


def test_benchmark_names_and_keys():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024


def _spans(durations, name="read", items=64, gap=0.0):
    out, t = [], 0.0
    for i, d in enumerate(durations):
        out.append(harness.Span(name, i, items, t, t + d))
        t += d + gap
    return out


def test_p95_is_over_every_request():
    durs = [0.001] * 95 + [0.010] * 5
    spans = _spans(durs)
    assert harness.end_to_end("read_p95_ms", spans, 1.0, 0.0) == \
        pytest.approx(1.0)
    spans = _spans([0.001] * 94 + [0.010] * 6)
    assert harness.end_to_end("read_p95_ms", spans, 1.0, 0.0) == \
        pytest.approx(10.0)
    assert harness.percentile([3, 1, 2], 50) == 2
    assert harness.percentile([5], 95) == 5


def test_rates_are_over_the_whole_window():
    spans = _spans([0.2, 0.3], name="ingest", items=512, gap=0.5)
    w0, w1 = harness.window_bounds(spans)
    assert (w0, w1) == (0.0, 1.0)
    assert harness.end_to_end("ingest_docs_per_s", spans, w1 - w0, 0.0) == \
        pytest.approx(1024.0)
    reads = _spans([0.1] * 4, items=256)
    assert harness.end_to_end("read_qps", reads, 0.4, 0.0) == \
        pytest.approx(2560.0)
    assert harness.end_to_end("setup_s", reads, 0.4, 12.5) == 12.5
    assert harness.end_to_end("read_qps.lm", reads, 0.4, 0.0) == \
        pytest.approx(2560.0)
    assert harness.end_to_end("gen_tokens_per_s", reads, 0.4, 0.0) is None


def test_timeline_covered_and_gaps():
    tl = harness.Timeline([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (6.0, 7.0)])
    assert tl.iv == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert tl.covered(0.0, 10.0) == pytest.approx(4.0)
    assert tl.covered(1.0, 3.5) == pytest.approx(1.5)
    assert tl.covered(2.0, 3.0) == 0.0
    assert tl.covered(3.2, 3.4) == pytest.approx(0.2)
    assert tl.covered(-5.0, 0.5) == pytest.approx(0.5)
    assert tl.gaps(0.0, 8.0) == [(2.0, 3.0), (4.0, 6.0), (7.0, 8.0)]


def test_reduce_trace_self_time_and_idle_share():
    spans = [harness.Span("ingest", 0, 10, 0.0, 0.0),
             harness.Span("read", 0, 4, 0.0, 0.0)]
    host = [(10.0, 14.0, "bench.ingest", True),
            (14.5, 15.0, "bench.read", True),
            (12.0, 13.5, "aten::copy_", True)]
    dev = [(10.5, 11.5, "k_insert"), (11.0, 12.0, "k_insert"),
           (14.6, 14.8, "k_search"), (20.0, 21.0, "outside")]
    tr = harness.reduce_trace(dev, host, spans)
    assert (spans[0].start, spans[0].end) == (10.0, 14.0)
    assert spans[0].busy == pytest.approx(1.5)
    assert spans[1].busy == pytest.approx(0.2)
    assert tr.window_s == pytest.approx(5.0)
    assert tr.busy_s == pytest.approx(1.7)
    assert 100 * (1 - tr.busy_s / tr.window_s) == pytest.approx(66.0)
    assert tr.device_ops[0] == ["k_insert", pytest.approx(2.0)]  # summed
    assert all(n != "outside" for n, _ in tr.device_ops)
    # the longest idle gap lies in the ingest span, where a copy ran
    assert tr.idle_gaps[0] == ["ingest:aten::copy_", pytest.approx(2.6)]
    ctx = harness.Context(None, spans, tr, {}, {})
    read = harness.metric_reader("ingest_host_ms_per_doc")
    assert read(ctx) == pytest.approx(1e3 * 2.5 / 10)
    assert harness.metric_reader("read_device_ms")(ctx) == \
        pytest.approx(200.0)
    assert harness.metric_reader("idle_share.ingest")(ctx) == \
        pytest.approx(66.0)
    assert harness.metric_reader("idle_share.search")(ctx) is None
    assert harness.metric_reader("hnsw_search_roofline")(ctx) is None
    assert harness.metric_reader("mfu.ingest")(ctx) is None


def test_reduce_trace_refuses_a_span_count_mismatch():
    spans = [harness.Span("read", 0, 4, 0.0, 0.0)]
    with pytest.raises(RuntimeError):
        harness.reduce_trace([], [], spans)


def test_reservoir_is_seeded_and_uniform_in_size():
    a, b = harness.Reservoir(3, 5), harness.Reservoir(3, 5)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 3
    a.clear()
    assert a.items == [] and a.seen == 0
