"""Whole runs of tiny cells on the CPU: correct when the port is sound,
not correct under the control and under each fault the cells can have,
and no JAX package loaded."""
import json
import pathlib
import subprocess
import sys

import pytest

import _tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("mix", ["stream", "search"])
def test_a_sound_run_is_correct(mix):
    out = _tiny.run(mix)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    names = set(out["metrics"])
    assert "setup_s" in names
    assert ("ingest_docs_per_s" in names) == (mix == "stream")
    assert "read_qps" in names
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_a_traced_run_reads_the_per_layer_metrics():
    out = _tiny.run("stream", trace=True)
    assert out["correct"] is True
    assert {"ingest_host_ms_per_doc", "ingest_device_ms_per_doc",
            "idle_share.ingest"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert "device_ops" in out["breakdown"]


def test_the_control_is_not_correct():
    out = _tiny.run("stream", control=True)
    assert out["correct"] is False
    assert out["checks"]["rows"]["value"] > 0


def _unchanged(monkeypatch):
    from repro_torch.core import machine
    monkeypatch.setattr(machine, "bulk_apply", lambda state, log, **kw: state)


def _half_batch(monkeypatch):
    from repro_torch.serve.engine import MemoryAugmentedEngine
    orig = MemoryAugmentedEngine.insert_documents

    def half(self, docs):
        n = len(docs)
        ids = orig(self, docs[:n // 2])
        self._next_id += n - n // 2
        return ids + list(range(ids[-1] + 1, ids[-1] + 1 + n - n // 2))
    monkeypatch.setattr(MemoryAugmentedEngine, "insert_documents", half)


def _altered_answer(monkeypatch):
    from repro_torch.core import query
    orig = query.execute_plan

    def altered(*a, **kw):
        ids, scores = orig(*a, **kw)
        ids = ids.clone()
        ids[0, -1] += 1
        return ids, scores
    monkeypatch.setattr(query, "execute_plan", altered)


@pytest.mark.parametrize("fault,mix", [
    (_unchanged, "stream"), (_half_batch, "stream"),
    (_altered_answer, "stream"), (_altered_answer, "search")])
def test_each_fault_is_not_correct(monkeypatch, fault, mix):
    fault(monkeypatch)
    assert _tiny.run(mix)["correct"] is False


def _sampled_fill_run(seed):
    """The fill run the search mix's check replays, by its slots."""
    import io
    log = io.StringIO()
    _tiny.run("search", seed=seed, log=log)
    line = next(x for x in log.getvalue().splitlines()
                if x.startswith("cell "))
    work = json.loads(line.split("work ", 1)[1])
    return work["hnsw_insert"]["call"]


@pytest.mark.parametrize("seed", [2**33 + 7, 2**31 + 3])
def test_a_fault_in_a_middle_run_is_caught(monkeypatch, seed):
    """The link of the sampled run (a middle run of the fill, drawn from
    the seed) leaves its last slot out of the graph: later runs never
    repair it, and only the replay of that run can see it."""
    call = _sampled_fill_run(seed)
    batch = _tiny.MIXES["search"]["fill_batch"]
    assert 0 < call < _tiny.MIXES["search"]["fill_rows"] // batch
    from repro_torch.kernels.qhnsw import ref
    orig = ref._insert

    def skip(ws, slot, *a, **kw):
        if slot == (call + 1) * batch - 1:
            return None
        return orig(ws, slot, *a, **kw)
    monkeypatch.setattr(ref, "_insert", skip)
    out = _tiny.run("search", seed=seed)
    assert out["correct"] is False
    assert out["checks"]["graph"]["value"] > 0


def test_a_cycle_with_an_op_that_has_no_module_stops():
    mix = dict(_tiny.MIXES["search"], cycle=[{"op": "gen", "n": 2}])
    with pytest.raises(ValueError, match="ops/gen.py"):
        _tiny.run(mix)


def test_a_config_with_an_engine_kind_that_has_no_module_stops():
    from bench.run import run_cell
    cell = _tiny.cell("search", dict(_tiny.CONFIG, engine="lm_dense"))
    with pytest.raises(ValueError, match="engines/lm_dense.py"):
        run_cell(cell, 1, 0.01, False, "cpu", 0.0)


def test_no_jax_package_is_loaded():
    code = (
        "import sys, json; sys.path[:0] = ['src', '.', 'bench/tests'];"
        "import _tiny; out = _tiny.run('stream');"
        "from bench import harness;"
        "import bench.reference.check;"
        "print(json.dumps([out['correct'], harness.forbidden_modules(),"
        " 'repro_torch' in sys.modules]))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, bad, port = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and port and bad == []
    code = ("import sys; sys.path[:0] = ['.'];"
            "import bench.reference.check, bench.reference.hnsw;"
            "print(sorted({m.split('.')[0] for m in sys.modules} &"
            " {'repro_torch', 'repro', 'jax', 'torch'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr


def test_without_a_card_the_entry_prints_no_result():
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "vdb1536.search",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def _altered_token(monkeypatch):
    from repro_torch.serve.engine import MemoryAugmentedEngine
    orig = MemoryAugmentedEngine._embed_batch

    def altered(self, tokens):
        tokens = tokens.copy()
        tokens[:, 0] = (tokens[:, 0] + 1) % self.cfg.vocab_size
        return orig(self, tokens)
    monkeypatch.setattr(MemoryAugmentedEngine, "_embed_batch", altered)


def _altered_quarter(monkeypatch):
    """A quarter of each batch embedded from other tokens: the median gap
    does not move, its 90th and 99th percentiles do."""
    from repro_torch.serve.engine import MemoryAugmentedEngine
    orig = MemoryAugmentedEngine._embed_batch

    def altered(self, tokens):
        tokens = tokens.copy()
        q = len(tokens) // 4
        tokens[:q] = (tokens[:q] * 7 + 3) % self.cfg.vocab_size
        return orig(self, tokens)
    monkeypatch.setattr(MemoryAugmentedEngine, "_embed_batch", altered)


def test_an_lm_cell_is_correct_and_its_control_is_not():
    out = _tiny.run_lm()
    assert out["correct"] is True, out["checks"]
    gaps = [out["checks"][f"embed_gap_p{q}"]["value"] for q in (50, 90, 99)]
    assert 0 < gaps[0] <= gaps[1] <= gaps[2]
    assert _tiny.run_lm(control=True)["correct"] is False


def test_a_quarter_of_a_batch_altered_fails_the_upper_gaps(monkeypatch):
    _altered_quarter(monkeypatch)
    out = _tiny.run_lm()
    checks = out["checks"]
    assert out["correct"] is False
    assert checks["embed_gap_p50"]["value"] <= \
        checks["embed_gap_p50"]["limit"]
    assert checks["embed_gap_p99"]["value"] > checks["embed_gap_p99"]["limit"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_token])
def test_each_lm_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert _tiny.run_lm()["correct"] is False
