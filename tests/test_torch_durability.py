"""The port's DurableStore, SideTable, checkpoint managers and the flat
engine's durable mode against the reference: the same history gives
byte-identical store directories, a store written by either package
recovers in the other with the same ``(t, hash)``, ``restore_at`` equals
the reference's replay prefix at every offset, and a crashed engine
recovers its state hash and retrievals (``tests/test_durability.py``,
``tests/test_group_commit.py``, ``tests/test_serve.py``)."""
import json
import pathlib
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402,F401
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.core import durability as jdur  # noqa: E402
from repro.core import machine as jm  # noqa: E402
from repro.core.state import MemoryState as JState  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.checkpoint import manager as tmanager  # noqa: E402
from repro_torch.core import codes as tcodes  # noqa: E402
from repro_torch.core import durability as tdur  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import machine as tm  # noqa: E402
from repro_torch.core import snapshot as tsnap  # noqa: E402
from repro_torch.core import wal as twal  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

from _torch_durable import (D, assert_same_files, hash_trace,  # noqa: E402
                            random_logs, record_boundaries)
from _torch_parity import state_np, to_port_state  # noqa: E402

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_durable"


def _t_init(cap):
    return t_init(cap, D, device="cpu")


def _store(path, genesis=None, **kw):
    return tdur.DurableStore(path, genesis, device="cpu", **kw)


def _build_pair(tmp_path, seed, n, id_space, cap, every, seg):
    """The same history written by both packages: the whole log appended,
    then a checkpoint every ``every`` commands. Returns (port store,
    port log, reference hash trace)."""
    jlog, tlog = random_logs(seed, n, id_space)
    jstore = jdur.DurableStore(tmp_path / "j", j_init(cap, D),
                               segment_records=seg, chunk_size=256)
    tstore = _store(tmp_path / "t", _t_init(cap), segment_records=seg,
                    chunk_size=256)
    jstore.append(jlog)
    tstore.append(tlog)
    ts = _t_init(cap)
    for t in range(every, n + 1, every):
        ts = tm.bulk_apply(ts, tlog.slice(t - every, t))
        tstore.checkpoint(ts)
        # the reference writes the same state's bits (F's parity is
        # test_torch_machine.py's; restore_at below holds it to replay)
        jstore.checkpoint(JState(**state_np(ts), contract_name="Q16.16"))
    return tstore, tlog, hash_trace(j_init(cap, D), jlog)


# --------------------------------------------------------------------------- #
# DurableStore: bytes, interop, time travel
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed,n,id_space,cap,every,seg", [
    (0, 36, 10, 32, 9, 5), (1, 36, 10, 32, 9, 1024), (11, 48, 5, 6, 7, 5)])
def test_store_bytes_interop_and_restore_at_every_offset(
        tmp_path, seed, n, id_space, cap, every, seg):
    store, _, ref = _build_pair(tmp_path, seed, n, id_space, cap, every, seg)
    assert_same_files(tmp_path / "j", tmp_path / "t")
    assert store.snapshots() == list(range(0, n + 1, every))
    for t in range(n + 1):
        state, h = tdur.restore_at(store, t)
        assert h == ref[t], f"restore_at({t}) diverged from replay prefix"
        assert int(state.version) == t and state.device.type == "cpu"
    # each package recovers the other's store with the same (t, hash)
    _, th_, tt = _store(tmp_path / "j").recover()
    _, jh_, jt = jdur.DurableStore(tmp_path / "t").recover()
    assert (tt, th_) == (jt, jh_) == (n, ref[n])


def test_fixture_written_by_the_reference_recovers(tmp_path):
    """The JAX-written fixture (scripts/gen_golden_torch_durable.py):
    recover() and every recorded restore_at hash; then the port extends it
    and the reference recovers the port's appends with the port's hash."""
    expect = json.loads((FIXTURE / "expected.json").read_text())
    shutil.copytree(FIXTURE / "store", tmp_path / "s")
    store = _store(tmp_path / "s")
    assert store.snapshots() == expect["snapshots"]
    assert [list(s) for s in store.wal.segments()] == expect["segments"]
    state, h, t = store.recover()
    assert (t, f"{h:#018x}") == (expect["recover"]["t"],
                                 expect["recover"]["state_hash"])
    for off, want in expect["restore_at"].items():
        assert f"{store.restore_at(int(off))[1]:#018x}" == want, off
    _, more = random_logs(40, 12, id_space=30, dim=expect["dim"])
    store.append(more)
    state = tm.bulk_apply(state, more)
    store.checkpoint(state)
    _, jh_, jt = jdur.DurableStore(tmp_path / "s").recover()
    assert (jt, jh_) == (t + 12, th.hash_pytree(state))


def test_store_recovers_over_torn_tail_and_lost_region(tmp_path):
    """A snapshot newer than a torn WAL prefix: recover() lands on the
    snapshot, the WAL cursor moves past the lost region, new appends and
    checkpoints work, and the gap is refused."""
    store, _, ref = _build_pair(tmp_path, 14, 20, 8, 32, 10, 1024)
    seg = sorted((tmp_path / "t" / "wal").glob("seg_*.wal"))[-1]
    _, bounds = record_boundaries(seg)
    with open(seg, "r+b") as f:
        f.truncate(bounds[len(bounds) // 2][0] + 3)  # torn below t=20
    reopened = _store(tmp_path / "t")
    assert reopened.wal.torn_tail_dropped > 0
    state, h, t = reopened.recover()
    assert (t, h) == (20, ref[20])
    _, extra = random_logs(15, 8, id_space=8)
    assert reopened.append(extra) == 28
    state2 = tm.bulk_apply(state, extra)
    reopened.checkpoint(state2)
    assert reopened.restore_at(28)[1] == th.hash_pytree(state2)
    with pytest.raises(ValueError, match="gap"):
        reopened.restore_at(15)
    with pytest.raises(ValueError, match="ahead"):
        reopened.checkpoint(tm.bulk_apply(state2, extra))


@pytest.mark.parametrize("damage", ["trailer", "truncated"])
def test_restore_falls_back_over_broken_snapshot(tmp_path, damage):
    store, _, ref = _build_pair(tmp_path, 16, 20, 8, 32, 10, 1024)
    newest = sorted((tmp_path / "t" / "snapshots").glob("t_*.vsn2"))[-1]
    raw = bytearray(newest.read_bytes())
    if damage == "trailer":
        raw[-1] ^= 0xFF
    else:
        raw = raw[:37]
    newest.write_bytes(bytes(raw))
    assert store.restore_at(20)[1] == ref[20]
    _, h, t = store.recover()
    assert (t, h) == (20, ref[20])


def test_retention_rollback_and_chunk_sweep(tmp_path):
    store, tlog, ref = _build_pair(tmp_path, 6, 36, 10, 32, 9, 3)
    n_chunks = len(store.chunks.keys())
    stats = store.retain(2)
    assert store.snapshots() == [27, 36]
    assert stats["snapshots_dropped"] == 3 and stats["wal_segments_dropped"]
    assert stats["oldest_snapshot"] == 27
    assert len(store.chunks.keys()) < n_chunks
    assert set(store.chunks.keys()) == store.referenced_chunk_keys()
    for t in (27, 30, 36):
        assert store.restore_at(t)[1] == ref[t]
    with pytest.raises(ValueError):
        store.restore_at(9)
    with pytest.raises(ValueError):
        store.retain(0)
    store.rollback_to(30)
    assert store.snapshots() == [27] and store.t == 30
    assert store.restore_at(30)[1] == ref[30]
    store.append(tlog.slice(30, 36))
    assert store.restore_at(36)[1] == ref[36]


def test_retention_of_the_tail_segment_keeps_the_wal_appendable(tmp_path):
    genesis = _t_init(32)
    store = _store(tmp_path / "s", genesis, segment_records=1024)
    _, log = random_logs(12, 30, id_space=9)
    store.append(log.slice(0, 20))
    s = tm.bulk_apply(genesis, log.slice(0, 20))
    store.checkpoint(s)
    store.retain(1)  # drops the genesis snapshot and the whole segment
    assert store.snapshots() == [20]
    assert store.append(log.slice(20, 30)) == 30
    assert store.restore_at(30)[1] == th.hash_pytree(
        tm.bulk_apply(s, log.slice(20, 30)))
    with pytest.raises(ValueError, match="genesis"):
        _store(tmp_path / "g", tm.bulk_apply(genesis, log.slice(0, 3)))
    with pytest.raises(ValueError, match="not a DurableStore"):
        _store(tmp_path / "nothing")


def _churny(seed, n):
    return random_logs(seed, n, id_space=5, weights=(1, 4, 2, 1, 1, 4))[1]


def test_scheduled_compaction(tmp_path):
    """Fires on the dead ratio and keeps the replayed state; never below
    min_commands; skips when the t=0 snapshot is gone; a failure inside
    compaction itself propagates."""
    genesis = _t_init(6)
    log = _churny(10, 60)
    ref = th.hash_pytree(tm.replay(genesis, log))
    fire = _store(tmp_path / "a", genesis, segment_records=8,
                  compaction=twal.CompactionPolicy(
                      dead_ratio=0.05, min_commands=20, check_every=20))
    raw = _store(tmp_path / "b", genesis, segment_records=8)
    for i in range(0, 60, 10):
        fire.append(log.slice(i, i + 10))
    raw.append(log)

    def wal_bytes(d):
        return sum(p.stat().st_size for p in (d / "wal").glob("seg_*.wal"))

    assert wal_bytes(tmp_path / "a") < wal_bytes(tmp_path / "b")
    assert fire.restore_at(60)[1] == ref

    never = _store(tmp_path / "c", genesis, segment_records=8,
                   compaction=twal.CompactionPolicy(
                       dead_ratio=0.01, min_commands=10_000, check_every=10))
    never.append(log)
    assert_same_files(tmp_path / "b" / "wal", tmp_path / "c" / "wal")

    policy = twal.CompactionPolicy(dead_ratio=0.01, min_commands=8,
                                   check_every=8)
    orphan = _store(tmp_path / "d", genesis, segment_records=64,
                    compaction=policy)
    for p in (tmp_path / "d" / "snapshots").glob("t_*.vsn2"):
        p.unlink()
    orphan.append(log.slice(0, 24))
    assert orphan.t == 24

    broken = _store(tmp_path / "e", genesis, segment_records=4,
                    compaction=policy)
    broken.append(log.slice(0, 6))
    seg0 = sorted((tmp_path / "e" / "wal").glob("seg_*.wal"))[0]
    data = bytearray(seg0.read_bytes())
    data[-4] ^= 0xFF
    seg0.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        broken.append(log.slice(6, 10))


def test_group_commit_into_a_store_and_torn_group(tmp_path):
    jlog, tlog = random_logs(21, 24, id_space=8)
    ref = hash_trace(j_init(32, D), jlog)
    store = _store(tmp_path / "s", _t_init(32), segment_records=1024)
    gw = twal.GroupCommitWriter(store, twal.GroupCommitPolicy(
        max_batch=8, max_delay_s=3600))
    for i in range(24):
        gw.submit(tlog.slice(i, i + 1))
    assert store.t == 24 and gw.groups == 3
    seg = sorted((tmp_path / "s" / "wal").glob("seg_*.wal"))[-1]
    with open(seg, "ab") as f:
        f.write(b"\x99torn in-flight group bytes\x99")
    _, h, t = _store(tmp_path / "s").recover()
    assert (t, h) == (24, ref[24])


# --------------------------------------------------------------------------- #
# SideTable
# --------------------------------------------------------------------------- #


def test_side_table_matches_reference_and_survives_torn_tail(tmp_path):
    puts = [(1, b"one"), (2, b"two"), (1, b"uno"), (7, b"")]
    tables = {}
    for name, cls in (("j", jdur.SideTable), ("t", tdur.SideTable)):
        tables[name] = cls(tmp_path / f"{name}.sdt")
        for k, v in puts:
            tables[name].put(k, v)
        tables[name].sync()
    jt, tt = tables["j"], tables["t"]
    assert (tmp_path / "j.sdt").read_bytes() == (tmp_path / "t.sdt").read_bytes()
    assert tt.entries == jt.entries == {1: b"uno", 2: b"two", 7: b""}
    for t in tables.values():
        t.close()
        t.close()
    with open(tmp_path / "t.sdt", "ab") as f:
        f.write(b"\xde\xadtorn record prefix")
    torn = tdur.SideTable(tmp_path / "t.sdt")
    assert torn.entries == {1: b"uno", 2: b"two", 7: b""}
    torn.put(3, b"three")
    torn.close()
    assert jdur.SideTable(tmp_path / "t.sdt").entries == \
        {1: b"uno", 2: b"two", 7: b"", 3: b"three"}


def test_side_table_put_sync_race_with_background_syncer(tmp_path):
    table = tdur.SideTable(tmp_path / "r.sdt")
    stop = threading.Event()

    def syncer():
        while not stop.is_set():
            table.sync()

    th_ = threading.Thread(target=syncer)
    th_.start()
    try:
        for i in range(300):
            table.put(i, f"payload-{i}".encode())
    finally:
        stop.set()
        th_.join(timeout=30)
    assert not th_.is_alive()
    table.sync()
    back = tdur.SideTable(tmp_path / "r.sdt")
    assert len(back.entries) == 300 and back.entries[299] == b"payload-299"
    back.close()
    table.close()


# --------------------------------------------------------------------------- #
# checkpoint managers
# --------------------------------------------------------------------------- #


def _trees(seed):
    """The same tree for each package: a dict holding a state, a tuple and
    a list of arrays (leaf paths are keystr strings)."""
    jstate = jm.bulk_apply(j_init(16, D), random_logs(seed, 12, 6)[0])
    arrays = {"w": np.arange(8, dtype=np.int32) * (seed + 1),
              "f": np.linspace(0, 1, 5).astype(np.float32)}
    jtree = {"state": jstate, "opt": (jnp.asarray(arrays["w"]),
                                      [jnp.asarray(arrays["f"])]), "n": None}
    ttree = {"state": to_port_state(jstate),
             "opt": (torch.from_numpy(arrays["w"]),
                     [torch.from_numpy(arrays["f"])]), "n": None}
    return jtree, ttree


@pytest.mark.parametrize("dedup", [False, True])
def test_checkpoints_load_across_packages(tmp_path, dedup):
    jtree, ttree = _trees(0)
    store = tsnap.ChunkStore(tmp_path / "chunks") if dedup else None
    jstore = jmanager.ChunkStore(tmp_path / "chunks") if dedup else None
    h_t = tmanager.save_checkpoint(tmp_path / "t", ttree, 3, store)
    h_j = jmanager.save_checkpoint(tmp_path / "j", jtree, 3, jstore)
    assert h_t == h_j == th.hash_pytree(ttree)
    assert (tmp_path / "t" / "manifest.json").read_text() == \
        (tmp_path / "j" / "manifest.json").read_text()
    back, step, h = tmanager.load_checkpoint(tmp_path / "j", ttree, store)
    assert (step, h) == (3, h_j) and isinstance(back["opt"][1][0],
                                                torch.Tensor)
    assert th.hash_pytree(back) == h_j
    jback, _, jh_ = jmanager.load_checkpoint(tmp_path / "t", jtree, jstore)
    assert jh_ == h_t
    for f, arr in state_np(jback["state"]).items():
        assert np.array_equal(arr, state_np(back["state"])[f]), f
    with pytest.raises(ValueError, match="mismatch"):
        tmanager.load_checkpoint(tmp_path / "t", {"only": ttree["opt"][0]},
                                 store)


@pytest.mark.parametrize("mode", ["async_wait", "async_next_save", "sync"])
def test_checkpoint_errors_are_reraised(tmp_path, monkeypatch, mode):
    mgr = tmanager.CheckpointManager(str(tmp_path / "c"),
                                     async_save=mode != "sync")
    tree = {"w": torch.arange(8, dtype=torch.int32)}
    monkeypatch.setattr(tmanager, "save_checkpoint",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("x")))
    if mode == "sync":
        with pytest.raises(RuntimeError, match="checkpoint save failed"):
            mgr.save(tree, step=1)
        return
    mgr.save(tree, step=1)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        if mode == "async_wait":
            mgr.wait()
        else:
            mgr.save(tree, step=2)
    monkeypatch.undo()
    mgr.save(tree, step=3)
    mgr.wait()
    assert mgr.steps() == [3]
    back, step, _ = mgr.restore_latest(tree)
    assert step == 3 and torch.equal(back["w"], tree["w"])


def test_checkpoint_dedup_shares_chunks_and_gc_sweeps(tmp_path):
    mgr = tmanager.CheckpointManager(str(tmp_path / "c"), keep=2,
                                     async_save=False, dedup=True)
    big = torch.arange(4096, dtype=torch.int64)
    small = torch.arange(8, dtype=torch.int32)
    mgr.save({"big": big, "small": small}, step=1)
    written = mgr._chunks.bytes_written
    mgr.save({"big": big, "small": small + 1}, step=2)
    assert mgr._chunks.bytes_written - written < written / 4
    mgr.save({"big": big * 2, "small": small}, step=3)  # rotates step 1 out
    assert mgr.steps() == [2, 3]
    referenced = set()
    for s in mgr.steps():
        man = json.loads((mgr._ckpt_path(s) / "manifest.json").read_text())
        referenced.update(int(m["chunk"], 16) for m in man["leaves"])
    assert set(mgr._chunks.keys()) == referenced


def test_durable_checkpoint_manager_retention(tmp_path):
    genesis = _t_init(32)
    mgr = tmanager.DurableCheckpointManager(
        str(tmp_path / "d"), genesis, keep=2, segment_records=4,
        device="cpu")
    _, log = random_logs(8, 30, id_space=9)
    s = genesis
    for start in (0, 10, 20):
        piece = log.slice(start, start + 10)
        s = tm.bulk_apply(s, piece)
        mgr.save(s, piece)
    assert len(mgr.store.snapshots()) == 2
    assert mgr.last_stats["t"] == 30
    state, h, t = mgr.recover()
    assert (t, h) == (30, th.hash_pytree(s))


# --------------------------------------------------------------------------- #
# the flat engine's durable mode
# --------------------------------------------------------------------------- #

DE = 16  # engine width


def _engine(path, **kw):
    sc = dict(capacity=64, retrieve_k=3, ef=8, durable_dir=str(path))
    sc.update(kw)
    return tengine.MemoryAugmentedEngine(DE, tengine.ServeConfig(**sc),
                                         device="cpu")


def _emb(rng, n):
    return rng.normal(size=(n, DE)).astype(np.float32)


def _answers(eng, q):
    out = []
    for route in ("exact", "hnsw", "coarse"):
        eng.sc.route = route
        out.append(eng.retrieval_hash(q))
    eng.sc.route = "auto"
    return out


def test_engine_crash_recovery(tmp_path):
    """WAL-first serving: a brand-new engine over the same directory
    recovers the state hash and the retrievals on every route, the audit
    holds, ids continue, and the reference's store recovers the same
    (t, hash) from the port's files."""
    rng = np.random.default_rng(3)
    eng = _engine(tmp_path / "d", checkpoint_every=16, ef_coarse=8)
    docs = _emb(rng, 24)
    eng.insert_documents(docs[:12])
    eng.insert_documents(docs[12:20])  # crosses checkpoint_every=16
    assert eng.delete_documents([3, 5, 99]) == 2
    eng.wait_durable()
    assert eng.durable.snapshots() == [0, 20] and eng.durable.t == 23
    q = _emb(rng, 2)
    h_before, answers = eng.state_hash(), _answers(eng, q)
    eng2 = _engine(tmp_path / "d", checkpoint_every=16, ef_coarse=8)
    assert eng2.recover() == (23, h_before)
    assert _answers(eng2, q) == answers
    assert eng2.replay_log_fresh() == eng2.state_hash() == h_before
    assert eng2.insert_documents(docs[20:22]) == [20, 21]
    _, jh_, jt = jdur.DurableStore(tmp_path / "d").recover()
    assert (jt, jh_) == (25, eng2.state_hash())
    eng.close()
    eng2.close()
    eng2.close()


def test_engine_group_commit_sync_on_read_and_code_table_checkpoint(
        tmp_path):
    """Group commit: ingest buffers (nothing durable, nothing acked) until
    the read path's flush; recovery reproduces what the reads saw. The
    checkpoint's code-table manifest equals the rebuilt table."""
    rng = np.random.default_rng(5)
    pol = twal.GroupCommitPolicy(max_batch=1 << 20, max_delay_s=3600)
    eng = _engine(tmp_path / "d", group_commit=pol, ef_coarse=8)
    eng.insert_documents(_emb(rng, 10))
    assert eng.durable.t == 0 and eng._group.pending == 10
    q = _emb(rng, 2)
    answers = _answers(eng, q)
    assert eng.durable.t == 10 and eng._group.pending == 0
    eng.insert_documents(_emb(rng, 3))
    stats = eng.checkpoint()
    assert stats["t"] == 13 and eng.durable.snapshots() == [0, 13]
    mft = sorted((tmp_path / "d" / "codes").glob("codes_*.mft"))
    assert [p.name for p in mft] == [f"codes_0000_t{13:020d}.mft"]
    table, cursor = tcodes.restore_table_v2(
        mft[0].read_bytes(), tsnap.ChunkStore(tmp_path / "d" / "codes" /
                                              "chunks"), device="cpu")
    assert cursor == 13 and tcodes.table_hash(table) == \
        tcodes.table_hash(tcodes.build(eng.memory))
    eng.insert_documents(_emb(rng, 2))  # pending, never flushed: lost
    eng2 = _engine(tmp_path / "d", group_commit=pol, ef_coarse=8)
    t, _ = eng2.recover()
    assert t == 13
    eng2.delete_documents([10, 11, 12])
    eng2.rollback_to(10)
    assert _answers(eng2, q) == answers


def test_engine_rollback_to_time_travels(tmp_path):
    rng = np.random.default_rng(13)
    eng = _engine(tmp_path / "d", retain_snapshots=2)
    q = _emb(rng, 2)
    eng.insert_documents(_emb(rng, 6))
    rh6, h6 = eng.retrieval_hash(q), eng.state_hash()
    eng.checkpoint()
    eng.insert_documents(_emb(rng, 6))
    assert eng.durable.t == 12
    assert eng.rollback_to(6) == (6, h6)
    assert eng.retrieval_hash(q) == rh6
    assert eng.replay_log_fresh() == eng.state_hash()
    assert eng.insert_documents(_emb(rng, 2)) == [6, 7]
    assert eng.snapshot_bytes() == tsnap.snapshot_bytes(eng.memory)
    assert tsnap.restore_bytes(eng.snapshot_bytes(), device="cpu")[1] == \
        eng.state_hash()


def test_engine_recover_with_a_relink_policy_canonicalizes_the_graph(
        tmp_path):
    """With a re-link policy, recovery re-links the restored graph once:
    relink_ts == [t], graph_gen == 1, and the audit replays it."""
    from repro_torch.core import hnsw as thnsw
    rng = np.random.default_rng(11)
    pol = thnsw.RelinkPolicy(dead_ratio=0.2, min_deletes=2, check_every=4)
    eng = _engine(tmp_path / "d", relink=pol)
    eng.insert_documents(_emb(rng, 12))
    eng.delete_documents([1, 2, 5, 7])
    eng.insert_documents(_emb(rng, 4))
    assert eng.relink_ts == [16]
    eng2 = _engine(tmp_path / "d", relink=pol)
    t, h = eng2.recover()
    assert (t, eng2.relink_ts, eng2.graph_gen) == (20, [20], 1)
    restored, _ = eng2.durable.restore_at(20)
    assert h == eng2.state_hash() == th.hash_pytree(thnsw.relink(restored))
    assert eng2.replay_log_fresh() == h


def test_engine_compaction_and_torn_crash_match_the_memory_engine(tmp_path):
    """A delete-heavy durable engine with scheduled compaction reaches the
    in-memory engine's hash; after a torn WAL tail it recovers the last
    whole record, which equals the in-memory engine fed that prefix."""
    rng = np.random.default_rng(7)
    batches = [("ins", _emb(rng, 8)) for _ in range(3)]
    batches += [("del", [0, 1, 2, 3, 17, 40]), ("ins", _emb(rng, 4)),
                ("del", [4, 5, 6, 7, 8, 9])]
    durable = _engine(tmp_path / "d", compaction=twal.CompactionPolicy(
        dead_ratio=0.01, min_commands=8, check_every=8))
    memory = tengine.MemoryAugmentedEngine(
        DE, tengine.ServeConfig(capacity=64, retrieve_k=3, ef=8),
        device="cpu")
    for kind, arg in batches:
        for e in (durable, memory):
            (e.insert_documents if kind == "ins" else e.delete_documents)(arg)
    assert durable.state_hash() == memory.state_hash()
    assert durable.durable.t == len(memory.log) == 40
    seg = sorted((tmp_path / "d" / "wal").glob("seg_*.wal"))[-1]
    _, bounds = record_boundaries(seg)
    with open(seg, "r+b") as f:
        f.truncate(bounds[-3][0] + 5)  # two whole records and a torn one
    crashed = _engine(tmp_path / "d")
    t, h = crashed.recover()
    assert t == 38
    prefix = tm.bulk_apply(t_init(64, DE, device="cpu"), memory.log.slice(0, t))
    assert h == th.hash_pytree(prefix) == crashed.replay_log_fresh()


def test_engine_refuses_policies_without_durable_dir():
    for kw in (dict(group_commit=twal.GroupCommitPolicy()),
               dict(compaction=twal.CompactionPolicy())):
        with pytest.raises(ValueError, match="durable_dir"):
            tengine.MemoryAugmentedEngine(
                8, tengine.ServeConfig(capacity=16, **kw), device="cpu")
    eng = tengine.MemoryAugmentedEngine(8, tengine.ServeConfig(capacity=16),
                                        device="cpu")
    for call in (eng.checkpoint, eng.recover, lambda: eng.rollback_to(0)):
        with pytest.raises(RuntimeError, match="durable_dir"):
            call()
    assert eng.flush() == 0
    eng.close()
