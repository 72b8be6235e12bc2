"""Snapshot formats in the port: v1 blobs, v2 manifests and chunk stores,
and the code table's VLRQ manifests, byte for byte against the reference
package and across it in both directions (the paper's Snapshot Transfer,
§8.1), plus the repository's golden snapshot fixtures."""
import json
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import codes as jcodes  # noqa: E402
from repro.core import commands as jc  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import machine as jm  # noqa: E402
from repro.core import snapshot as jsnap  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.core import codes as tcodes  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import snapshot as tsnap  # noqa: E402

from _torch_parity import (assert_states_equal, cuda_or_skip,  # noqa: E402
                           to_port_log, to_port_state)
from test_torch_codes import _contract_state, assert_tables_equal  # noqa: E402
from test_torch_machine import D, random_log  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def jstate():
    """A reference state from a randomized six-opcode log (links, meta and
    the HNSW graph populated, tombstones present)."""
    return jm.bulk_apply(j_init(32, D), random_log(4))


def _chunk_files(directory):
    return {p.name: p.read_bytes() for p in pathlib.Path(directory).glob("*")}


@pytest.mark.parametrize("contract", ["Q16.16", "Q8.8", "Q32.32"])
def test_v1_bytes_match_reference_both_ways(jstate, contract):
    s = jstate if contract == "Q16.16" else _contract_state(contract, 2)
    t = to_port_state(s)
    blob = tsnap.snapshot_bytes(t)
    assert blob == jsnap.snapshot_bytes(s)
    # reference blob → port, port blob → reference
    t2, h = tsnap.restore_bytes(jsnap.snapshot_bytes(s), device="cpu")
    assert h == jh.hash_pytree(s) == th.hash_pytree(t2)
    assert_states_equal(t2, s)
    assert t2.contract_name == contract and t2.device.type == "cpu"
    s2, h2 = jsnap.restore_bytes(blob)
    assert h2 == h
    assert_states_equal(t, s2)


def test_v1_save_load_and_corruption(jstate, tmp_path):
    t = to_port_state(jstate)
    path = tmp_path / "s.vlr"
    assert tsnap.save(str(path), t) == jh.hash_pytree(jstate)
    t2, h = tsnap.load(str(path), device="cpu")
    assert h == jh.hash_pytree(jstate)
    assert_states_equal(t2, jstate)
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0xFF  # the stored hash
    for restore in (jsnap.restore_bytes,
                    lambda b: tsnap.restore_bytes(b, device="cpu")):
        with pytest.raises(ValueError, match="hash mismatch"):
            restore(bytes(blob))
        with pytest.raises(ValueError, match="not a Valori snapshot"):
            restore(b"XXXX" + bytes(blob[4:]))


@pytest.mark.parametrize("chunk_size", [64, 256, 8192])
def test_v2_manifest_and_chunks_match_reference(jstate, tmp_path, chunk_size):
    t = to_port_state(jstate)
    tstore = tsnap.ChunkStore(tmp_path / "port")
    jstore = jsnap.ChunkStore(tmp_path / "ref")
    tm, tstats = tsnap.snapshot_v2(t, tstore, chunk_size=chunk_size)
    jm_, jstats = jsnap.snapshot_v2(jstate, jstore, chunk_size=chunk_size)
    assert tm == jm_ and tstats == jstats
    assert _chunk_files(tmp_path / "port") == _chunk_files(tmp_path / "ref")
    assert tsnap.manifest_chunk_keys(tm) == jsnap.manifest_chunk_keys(jm_)
    assert tsnap.manifest_cursor(tm) == jsnap.manifest_cursor(jm_) == \
        int(jstate.version)
    # each package restores the other's store
    t2, h = tsnap.restore_v2(jm_, tsnap.ChunkStore(tmp_path / "ref"),
                             device="cpu")
    assert h == jh.hash_pytree(jstate)
    assert_states_equal(t2, jstate)
    s2, h2 = jsnap.restore_v2(tm, jsnap.ChunkStore(tmp_path / "port"))
    assert h2 == h
    assert_states_equal(t, s2)
    # a second snapshot of the same state writes nothing new
    _, again = tsnap.snapshot_v2(t, tstore, chunk_size=chunk_size)
    assert again["chunks_written"] == 0 and again["chunks"] == tstats["chunks"]


def test_v2_detects_chunk_corruption_like_reference(tmp_path):
    genesis = j_init(16, D)
    for pkg, state, name in ((jsnap, genesis, "ref"),
                             (tsnap, to_port_state(genesis), "port")):
        chunks = pkg.ChunkStore(tmp_path / name)
        manifest, _ = pkg.snapshot_v2(state, chunks, chunk_size=64)
        victim = sorted((tmp_path / name).glob("*.chk"))[0]
        raw = bytearray(victim.read_bytes())
        raw[0] ^= 0xFF
        victim.write_bytes(bytes(raw))
        kw = {"device": "cpu"} if pkg is tsnap else {}
        with pytest.raises(ValueError, match="corrupt"):
            pkg.restore_v2(manifest, chunks, **kw)
        with pytest.raises(ValueError, match="not a v2"):
            pkg.restore_v2(b"VLRI" + manifest[4:], chunks, **kw)


def test_restore_any_dispatches_both_formats(jstate, tmp_path):
    t = to_port_state(jstate)
    chunks = tsnap.ChunkStore(tmp_path / "chunks")
    v1 = tsnap.snapshot_bytes(t)
    v2, _ = tsnap.snapshot_v2(t, chunks)
    (_, h1), (_, h2) = (tsnap.restore_any(v1, device="cpu"),
                        tsnap.restore_any(v2, chunks, device="cpu"))
    assert h1 == h2 == jh.hash_pytree(jstate)
    with pytest.raises(ValueError, match="ChunkStore"):
        tsnap.restore_any(v2, device="cpu")
    with pytest.raises(ValueError, match="not a Valori snapshot"):
        tsnap.restore_any(b"nope", device="cpu")


def test_restores_default_to_cuda_and_never_fall_back(jstate, tmp_path,
                                                     monkeypatch):
    t = to_port_state(jstate)
    blob = tsnap.snapshot_bytes(t)
    store = tsnap.ChunkStore(tmp_path / "chunks")
    manifest, _ = tsnap.snapshot_v2(t, store)
    tblob, _ = tcodes.snapshot_table_v2(tcodes.build(t), 1, store)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsnap.restore_bytes(blob),
                 lambda: tsnap.restore_v2(manifest, store),
                 lambda: tsnap.restore_any(blob),
                 lambda: tcodes.restore_table_v2(tblob, store)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# --------------------------------------------------------------------------- #
# golden fixtures written by the reference (scripts/gen_golden_snapshots.py)
# --------------------------------------------------------------------------- #


@pytest.fixture()
def golden(tmp_path):
    """The golden fixtures, with the chunk directory copied under tmp_path
    so that nothing writes into tests/fixtures/."""
    shutil.copytree(FIXTURES / "golden_v2_chunks", tmp_path / "chunks")
    return (json.loads((FIXTURES / "golden.json").read_text()),
            (FIXTURES / "golden_v1.bin").read_bytes(),
            (FIXTURES / "golden_v2_manifest.bin").read_bytes(),
            tmp_path)


def test_golden_fixtures_restore_and_reserialize(golden):
    expect, v1, v2, tmp = golden
    want_hash = int(expect["state_hash"], 16)
    s1, h1 = tsnap.restore_bytes(v1, device="cpu")
    s2, h2 = tsnap.restore_v2(v2, tsnap.ChunkStore(tmp / "chunks"),
                              device="cpu")
    assert h1 == h2 == want_hash == th.hash_pytree(s1)
    assert_states_equal(s1, s2)
    assert tsnap.snapshot_bytes(s1) == v1
    assert len(v1) == expect["v1_bytes"]
    store = tsnap.ChunkStore(tmp / "fresh")
    manifest, stats = tsnap.snapshot_v2(s2, store,
                                        chunk_size=expect["chunk_size"])
    assert manifest == v2 and len(v2) == expect["v2_manifest_bytes"]
    assert stats["chunks_written"] == expect["v2_chunks"]
    assert _chunk_files(tmp / "fresh") == \
        _chunk_files(FIXTURES / "golden_v2_chunks")


@pytest.mark.cuda
def test_golden_fixtures_restore_on_card(golden):
    dev = cuda_or_skip()
    expect, v1, v2, tmp = golden
    want_hash = int(expect["state_hash"], 16)
    s1, h1 = tsnap.restore_bytes(v1)
    s2, h2 = tsnap.restore_v2(v2, tsnap.ChunkStore(tmp / "chunks"),
                              device=dev)
    assert s1.device.type == s2.device.type == "cuda"
    assert h1 == h2 == want_hash == th.hash_state_device(s2)


# --------------------------------------------------------------------------- #
# the code table's VLRQ manifests
# --------------------------------------------------------------------------- #


def _tables(seed=4):
    s = _contract_state("Q16.16", seed, cap=32, n=20, n_dead=2)
    return s, jcodes.build(s), to_port_state(s)


def test_table_manifest_matches_reference_and_roundtrips(tmp_path):
    s, jt, t = _tables()
    tt = tcodes.build(t)
    tstore = tsnap.ChunkStore(tmp_path / "port")
    jstore = jsnap.ChunkStore(tmp_path / "ref")
    tblob, tstats = tcodes.snapshot_table_v2(tt, 17, tstore)
    jblob, jstats = jcodes.snapshot_table_v2(jt, 17, jstore)
    assert tblob == jblob and tstats == jstats
    assert _chunk_files(tmp_path / "port") == _chunk_files(tmp_path / "ref")
    t2, cursor = tcodes.restore_table_v2(jblob, tstore, device="cpu")
    assert cursor == 17
    assert_tables_equal(t2, jt)
    j2, jcursor = jcodes.restore_table_v2(tblob, jstore)
    assert jcursor == 17
    assert_tables_equal(tt, j2)
    assert tcodes.table_manifest_cursor(tblob) == 17
    assert tcodes.table_manifest_chunk_keys(tblob) == \
        jcodes.table_manifest_chunk_keys(jblob)
    assert set(tcodes.table_manifest_chunk_keys(tblob)) <= set(tstore.keys())


def test_table_manifest_incremental_dedup_matches_reference(tmp_path):
    """A second table snapshot after an insert inside the envelope rewrites
    only the dirty chunks, with the reference's stats and bytes."""
    s, jt, t = _tables()
    tt = tcodes.build(t)
    mid = np.asarray(s.vectors)[:20].mean(axis=0).astype(np.int32)
    jlog = jc.insert_batch(jnp.asarray([200], jnp.int64),
                           jnp.asarray(mid[None, :]))
    _, jt2 = jcodes.apply_with_codes(s, jt, jlog)
    _, tt2 = tcodes.apply_with_codes(t, tt, to_port_log(jlog))
    out = {}
    for pkg, snap, tables, name in ((tcodes, tsnap, (tt, tt2), "port"),
                                    (jcodes, jsnap, (jt, jt2), "ref")):
        store = snap.ChunkStore(tmp_path / name)
        _, st1 = pkg.snapshot_table_v2(tables[0], 1, store, chunk_size=256)
        blob2, st2 = pkg.snapshot_table_v2(tables[1], 2, store,
                                           chunk_size=256)
        out[name] = (st1, st2, blob2)
    assert out["port"] == out["ref"]
    st1, st2, blob2 = out["port"]
    assert st1["chunks_written"] == st1["chunks"]
    assert 0 < st2["chunks_written"] < st1["chunks_written"]
    t3, _ = tcodes.restore_table_v2(blob2, tsnap.ChunkStore(tmp_path / "port"),
                                    device="cpu")
    assert_tables_equal(t3, jt2)


def test_table_restore_detects_corruption_like_reference(tmp_path):
    s, jt, t = _tables(seed=9)
    for pkg, snap, table, name in ((tcodes, tsnap, tcodes.build(t), "port"),
                                   (jcodes, jsnap, jt, "ref")):
        store = snap.ChunkStore(tmp_path / name)
        blob, _ = pkg.snapshot_table_v2(table, 3, store)
        bad = bytearray(blob)
        bad[-1] ^= 0xFF  # the stored table hash
        kw = {"device": "cpu"} if pkg is tcodes else {}
        with pytest.raises(ValueError, match="hash"):
            pkg.restore_table_v2(bytes(bad), store, **kw)
        with pytest.raises(ValueError, match="code-table manifest"):
            pkg.restore_table_v2(b"VLR2" + blob[4:], store, **kw)
