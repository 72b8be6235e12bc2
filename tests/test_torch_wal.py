"""The port's WAL against the reference's: the same log gives byte-identical
segment files, either package reads the other's, and the WAL, torn-tail,
compaction, group-commit and ``truncate_to`` contracts of
``tests/test_durability.py`` / ``tests/test_group_commit.py`` hold."""
import dataclasses
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402,F401
from repro.core import commands as jc  # noqa: E402
from repro.core import contracts as jcontracts  # noqa: E402
from repro.core import wal as jwal  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.core import commands as tc  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import machine as tm  # noqa: E402
from repro_torch.core import wal as twal  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402

from _torch_durable import (D, assert_same_files, hash_trace,  # noqa: E402
                            nop_logs, random_logs, record_boundaries)
from _torch_parity import np_, to_port_log  # noqa: E402


def _replay_hash(log, cap=32):
    return th.hash_pytree(tm.replay(t_init(cap, D, device="cpu"), log))


def _logs_equal(a, b):
    for f in tc.FIELDS:
        assert np.array_equal(np_(getattr(a, f)), np.asarray(getattr(b, f))), f


# --------------------------------------------------------------------------- #
# bytes on disk: the reference's, both ways
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed,seg,cuts", [
    (0, 6, (13,)), (1, 4, (5, 11, 30)), (2, 1024, ()), (3, 7, (1, 2, 3))])
def test_segment_bytes_identical_to_reference(tmp_path, seed, seg, cuts):
    jlog, tlog = random_logs(seed, 40, id_space=9, weights=(3, 3, 1, 1, 1, 1))
    jw = jwal.WriteAheadLog(tmp_path / "j", D, segment_records=seg)
    tw = twal.WriteAheadLog(tmp_path / "t", D, segment_records=seg)
    bounds = (0, *cuts, 40)
    for a, b in zip(bounds, bounds[1:]):
        assert tw.append(tlog.slice(a, b)) == jw.append(jlog.slice(a, b))
    assert tw.t == jw.t == 40 and tw.segments() == jw.segments()
    assert_same_files(tmp_path / "j", tmp_path / "t")
    # each package reads the other's files into the same commands
    _logs_equal(twal.WriteAheadLog(tmp_path / "j").read_range(
        0, 40, device="cpu"), jw.read_range(0, 40))
    _logs_equal(twal.WriteAheadLog(tmp_path / "t").read_range(
        3, 29, device="cpu"), jwal.WriteAheadLog(tmp_path / "t").read_range(
            3, 29))
    assert _replay_hash(tw.read_range(0, 40, device="cpu")) == \
        _replay_hash(tlog)


@pytest.mark.parametrize("name", ["Q8.8", "Q32.32", "Q2.13"])
def test_segment_bytes_other_storage_types(tmp_path, name):
    """int16 and int64 payloads frame and chain as the reference's, and a
    reopen adopts the header's contract."""
    jcon, tcon = jcontracts.CONTRACTS[name], tcontracts.CONTRACTS[name]
    rng = np.random.default_rng(4)
    info = np.iinfo(tcon.np_storage_dtype)
    vec = rng.integers(info.min, info.max, size=(6, D),
                       dtype=tcon.np_storage_dtype)
    jlog = jc.CommandLog(
        opcode=np.asarray([1, 1, 0, 0, 2, 1], np.int32),
        arg0=np.asarray([4, 9, 0, 0, 4, 9], np.int64),
        arg1=np.zeros(6, np.int64), arg2=np.zeros(6, np.int64), vec=vec)
    jw = jwal.WriteAheadLog(tmp_path / "j", D, jcon, segment_records=4)
    jw.append(jlog)
    tw = twal.WriteAheadLog(tmp_path / "t", D, tcon, segment_records=4)
    tw.append(to_port_log(jlog, tcon))
    assert_same_files(tmp_path / "j", tmp_path / "t")
    r = twal.WriteAheadLog(tmp_path / "j")
    assert r.contract.name == name
    back = r.read_range(0, 6, device="cpu")
    assert back.vec.dtype == tcon.storage_dtype
    assert np.array_equal(np_(back.vec)[[0, 1, 5]], vec[[0, 1, 5]])
    with pytest.raises(ValueError, match="contract"):
        twal.WriteAheadLog(tmp_path / "j", contract=tcontracts.CONTRACTS[
            "Q16.16" if name != "Q16.16" else "Q8.8"])


def test_appends_continue_a_reference_chain(tmp_path):
    """The port reopens a WAL the reference wrote and extends its chain;
    the files equal the reference extending its own."""
    jlog, tlog = random_logs(5, 30, id_space=10)
    for d in ("j", "t"):
        jwal.WriteAheadLog(tmp_path / d, D, segment_records=4).append(
            jlog.slice(0, 11))
    jwal.WriteAheadLog(tmp_path / "j", segment_records=4).append(
        jlog.slice(11, 30))
    tw = twal.WriteAheadLog(tmp_path / "t", segment_records=4)
    assert tw.t == 11 and tw.dim == D
    tw.append(tlog.slice(11, 30))
    assert_same_files(tmp_path / "j", tmp_path / "t")


def test_nop_runs_are_rle(tmp_path):
    _, nops = nop_logs(64)
    w = twal.WriteAheadLog(tmp_path, D, segment_records=1024)
    w.append(nops)
    seg = next(tmp_path.glob("seg_*.wal"))
    assert w.t == 64 and seg.stat().st_size < 200  # one 36-byte run record
    back = w.read_range(0, 64, device="cpu")
    assert len(back) == 64 and bool((back.opcode == tc.NOP).all())
    assert len(w.read_range(5, 5, device="cpu")) == 0


def test_read_range_lands_on_the_named_device(tmp_path):
    _, tlog = random_logs(6, 8, id_space=4)
    w = twal.WriteAheadLog(tmp_path, D)
    w.append(tlog)
    assert w.read_range(0, 8, device="cpu").device.type == "cpu"
    log, t_end = w.tail(2, 3, device="cpu")
    assert t_end == 5 and len(log) == 3
    _logs_equal(log, tlog.slice(2, 5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            w.read_range(0, 8)


# --------------------------------------------------------------------------- #
# crash recovery: torn tails, stillborn segments, interrupted compaction
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_torn_tail_recovers_longest_valid_prefix(tmp_path, seed):
    """A random byte cut: the port keeps exactly the longest valid record
    prefix (the reference's), truncates the torn bytes, replays to the
    reference's prefix hash, and appends on a clean chain."""
    rng = np.random.default_rng(seed)
    jlog, tlog = random_logs(seed, 24, id_space=8)
    ref = hash_trace(j_init(32, D), jlog)
    w = twal.WriteAheadLog(tmp_path / "t", D, segment_records=1024)
    w.append(tlog)
    seg = next((tmp_path / "t").glob("seg_*.wal"))
    header, bounds = record_boundaries(seg)
    cut = int(rng.integers(header, seg.stat().st_size))
    with open(seg, "r+b") as f:
        f.truncate(cut)
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    expect_t = max([c for o, c in bounds if o <= cut], default=0)
    recovered = twal.WriteAheadLog(tmp_path / "t")
    assert recovered.t == expect_t == jwal.WriteAheadLog(tmp_path / "j").t
    assert_same_files(tmp_path / "j", tmp_path / "t")
    assert _replay_hash(recovered.read_range(0, expect_t, device="cpu")) \
        == ref[expect_t]
    recovered.append(tlog.slice(expect_t, 24))
    assert _replay_hash(recovered.read_range(0, 24, device="cpu")) == ref[24]


def test_stillborn_tail_segment_dropped_on_open(tmp_path):
    _, tlog = random_logs(18, 12, id_space=6)
    w = twal.WriteAheadLog(tmp_path, D, segment_records=8)
    w.append(tlog)
    (tmp_path / f"seg_{w.t:020d}.wal").write_bytes(b"VWSG\x01\x00")  # torn
    reopened = twal.WriteAheadLog(tmp_path)
    assert reopened.t == 12 and reopened.torn_tail_dropped == 6
    assert _replay_hash(reopened.read_range(0, 12, device="cpu")) == \
        _replay_hash(tlog)
    reopened.append(tlog.slice(0, 4))
    assert reopened.t == 16


def test_interrupted_compaction_swap_rolls_forward(tmp_path):
    """A crash right after compact()'s commit point, with the old-segment
    unlink half done: reopening finishes the swap."""
    jlog, tlog = random_logs(19, 30, id_space=5, weights=(1, 4, 2, 1, 1, 4))
    genesis = t_init(6, D, device="cpu")
    h_raw = th.hash_pytree(tm.replay(genesis, tlog))
    w = twal.WriteAheadLog(tmp_path, D, segment_records=8)
    w.append(tlog)
    compacted, _ = twal.compact_log(genesis, tlog)
    tmp = tmp_path / "compact.tmp"
    tmp.mkdir()
    twal.WriteAheadLog(tmp, D, segment_records=8).append(compacted)
    names = sorted(p.name for p in tmp.glob("seg_*.wal"))
    (tmp_path / "compact.commit").write_text("\n".join(names))
    sorted(tmp_path.glob("seg_*.wal"))[0].unlink()
    shutil.copy(tmp / names[-1], tmp_path / names[-1])
    recovered = twal.WriteAheadLog(tmp_path)
    assert recovered.t == 30
    assert not (tmp_path / "compact.commit").exists() and not tmp.exists()
    assert th.hash_pytree(tm.bulk_apply(
        genesis, recovered.read_range(0, 30, device="cpu"))) == h_raw


def test_wal_rejects_mismatched_vec_dtype(tmp_path):
    w = twal.WriteAheadLog(tmp_path, D, segment_records=16)
    _, log = random_logs(0, 4, id_space=4)
    with pytest.raises(ValueError, match="dtype"):
        w.append(dataclasses.replace(log, vec=log.vec.to(torch.int8)))
    with pytest.raises(ValueError, match="dim"):
        w.append(dataclasses.replace(log, vec=log.vec[:, :4]))
    assert w.append(log) == 4


# --------------------------------------------------------------------------- #
# compaction
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_compact_log_equals_reference(seed):
    """The port folds exactly the commands the reference folds, and the
    compacted log replays to the raw log's hash."""
    jlog, tlog = random_logs(seed, 60, id_space=6, weights=(1, 4, 2, 2, 2, 3))
    jout, jstats = jwal.compact_log(j_init(5, D), jlog)
    genesis = t_init(5, D, device="cpu")
    tout, tstats = twal.compact_log(genesis, tlog)
    assert tstats == jstats and len(tout) == 60
    _logs_equal(tout, jout)
    assert th.hash_pytree(tm.bulk_apply(genesis, tout)) == \
        th.hash_pytree(tm.replay(genesis, tlog))


def test_compact_on_disk_equals_reference(tmp_path):
    jlog, tlog = random_logs(9, 50, id_space=5, weights=(1, 4, 2, 1, 1, 4))
    jw = jwal.WriteAheadLog(tmp_path / "j", D, segment_records=8)
    jw.append(jlog)
    tw = twal.WriteAheadLog(tmp_path / "t", D, segment_records=8)
    tw.append(tlog)
    gated = tw.compact(t_init(6, D, device="cpu"), min_dead_ratio=0.999)
    assert gated["skipped"] == 1 and gated["bytes_after"] == \
        gated["bytes_before"]
    assert_same_files(tmp_path / "j", tmp_path / "t")
    jstats = jw.compact(j_init(6, D))
    tstats = tw.compact(t_init(6, D, device="cpu"))
    assert tstats == jstats and tw.t == 50
    assert tstats["bytes_after"] < tstats["bytes_before"]
    assert_same_files(tmp_path / "j", tmp_path / "t")


# --------------------------------------------------------------------------- #
# group commit
# --------------------------------------------------------------------------- #


def test_append_many_is_byte_identical_to_appends(tmp_path):
    jlog, tlog = random_logs(3, 48, id_space=12)
    a = twal.WriteAheadLog(tmp_path / "a", D, segment_records=16)
    for i in range(48):
        a.append(tlog.slice(i, i + 1))
    b = twal.WriteAheadLog(tmp_path / "b", D, segment_records=16)
    b.append_many([tlog.slice(i, i + 12) for i in range(0, 48, 12)])
    j = jwal.WriteAheadLog(tmp_path / "j", D, segment_records=16)
    j.append_many([jlog.slice(i, i + 12) for i in range(0, 48, 12)])
    assert a.t == b.t == 48
    assert_same_files(tmp_path / "a", tmp_path / "b")
    assert_same_files(tmp_path / "j", tmp_path / "b")
    # NOP runs never merge across log boundaries
    (_, n2), (_, n3) = nop_logs(2), nop_logs(3)
    c = twal.WriteAheadLog(tmp_path / "c", D)
    c.append(n2)
    c.append(n3)
    e = twal.WriteAheadLog(tmp_path / "e", D)
    e.append_many([n2, tc.empty_log(D, device="cpu"), n3])
    assert c.t == e.t == 5
    assert_same_files(tmp_path / "c", tmp_path / "e")
    assert e.append_many([]) == 5


def _writer(tmp_path, policy, seg=1024):
    w = twal.WriteAheadLog(tmp_path, D, segment_records=seg)
    return w, twal.GroupCommitWriter(w, policy)


def test_writer_batches_deadlines_and_acks(tmp_path):
    w, gw = _writer(tmp_path / "a", twal.GroupCommitPolicy(
        max_batch=16, max_delay_s=3600))
    _, log = random_logs(1, 40, id_space=10)
    for i in range(40):
        gw.submit(log.slice(i, i + 1))
    assert gw.groups == 2 and w.t == 32
    assert gw.pending == 8 and gw.target_t == 40
    assert twal.WriteAheadLog(tmp_path / "a", D).t == 32  # never acked
    assert gw.flush() == 40 and gw.pending == 0 and gw.groups == 3

    w2, gw2 = _writer(tmp_path / "b", twal.GroupCommitPolicy(
        max_batch=1 << 20, max_delay_s=0.01))
    gw2.submit(log.slice(0, 2))
    assert w2.t == 0
    time.sleep(0.02)
    gw2.submit(log.slice(2, 4))  # deadline observed at the next submit
    assert w2.t == 4 and gw2.pending == 0


def test_writer_failure_keeps_the_rest_and_never_duplicates(tmp_path):
    """A failing sink keeps the never-acked group retryable; a flush that
    failed after its first segment landed retries only the rest."""
    w, gw = _writer(tmp_path / "a", twal.GroupCommitPolicy(
        max_batch=1 << 20, max_delay_s=3600))
    _, log = random_logs(20, 12, id_space=6)
    gw.submit(log)
    real = w.append_many
    w.append_many = lambda logs: (_ for _ in ()).throw(OSError("disk full"))
    with pytest.raises(OSError):
        gw.flush()
    assert gw.pending == 12
    w.append_many = real
    assert gw.flush() == 12

    w, gw = _writer(tmp_path / "b", twal.GroupCommitPolicy(
        max_batch=1 << 20, max_delay_s=3600), seg=8)
    _, log = random_logs(22, 20, id_space=8)
    gw.submit(log)
    orig, calls = w._open_segment, {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        orig()

    w._open_segment = flaky
    with pytest.raises(OSError):
        gw.flush()
    assert w.t == 8 and gw.pending == 12
    w._open_segment = orig
    assert gw.flush() == 20
    assert _replay_hash(w.read_range(0, 20, device="cpu")) == \
        _replay_hash(log)


def test_timer_flush_holds_deadline_and_order(tmp_path):
    w, gw = _writer(tmp_path, twal.GroupCommitPolicy(
        max_batch=1 << 20, max_delay_s=0.02, timer_flush=True))
    _, log = random_logs(30, 12, id_space=4)
    try:
        for i in range(0, 12, 3):
            gw.submit(log.slice(i, i + 3))
        deadline = time.monotonic() + 5.0
        while gw.pending and time.monotonic() < deadline:
            time.sleep(0.005)
        assert gw.pending == 0 and w.t == 12 and gw.timer_flushes >= 1
        _logs_equal(w.read_range(0, 12, device="cpu"),
                    jc.CommandLog(**{f: np_(getattr(log, f))
                                     for f in tc.FIELDS}))
    finally:
        gw.close()
        gw.close()
    assert gw._timer is None


@pytest.mark.parametrize("seed", range(4))
def test_kill_mid_group_recovers_last_whole_record(tmp_path, seed):
    rng = np.random.default_rng(seed)
    jlog, tlog = random_logs(seed, 30, id_space=8)
    ref = hash_trace(j_init(32, D), jlog)
    w = twal.WriteAheadLog(tmp_path, D, segment_records=1024)
    w.append(tlog.slice(0, 6))
    seg = next(tmp_path.glob("seg_*.wal"))
    group_start = seg.stat().st_size
    w.append_many([tlog.slice(i, i + 8) for i in range(6, 30, 8)])
    _, bounds = record_boundaries(seg)
    cut = int(rng.integers(group_start, seg.stat().st_size))
    with open(seg, "r+b") as f:
        f.truncate(cut)
    expect_t = max([c for o, c in bounds if o <= cut], default=0)
    assert expect_t >= 6
    recovered = twal.WriteAheadLog(tmp_path)
    assert recovered.t == expect_t
    assert _replay_hash(recovered.read_range(0, expect_t, device="cpu")) \
        == ref[expect_t]
    recovered.append(tlog.slice(expect_t, 30))
    assert _replay_hash(recovered.read_range(0, 30, device="cpu")) == ref[30]


# --------------------------------------------------------------------------- #
# truncate_to / reset_to / drop_below
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("t,seg", [(13, 8), (9, 1024), (8, 8), (0, 8)])
def test_truncate_to_matches_reference(tmp_path, t, seg):
    """Cut at a record boundary, inside a NOP run, at a segment edge and to
    the empty log: the files equal the reference's and the chain extends."""
    jlog, tlog = random_logs(5, 20, id_space=10)
    (jn, tn) = nop_logs(12)
    jw = jwal.WriteAheadLog(tmp_path / "j", D, segment_records=seg)
    tw = twal.WriteAheadLog(tmp_path / "t", D, segment_records=seg)
    for w, a, n in ((jw, jlog, jn), (tw, tlog, tn)):
        w.append(a.slice(0, 5))
        w.append(n)
        w.append(a.slice(5, 20))
        w.truncate_to(t)
        assert w.t == t
    assert_same_files(tmp_path / "j", tmp_path / "t")
    jw.append(jlog.slice(0, 7))
    tw.append(tlog.slice(0, 7))
    assert_same_files(tmp_path / "j", tmp_path / "t")


def test_truncate_to_refuses_gaps_and_stays_intact(tmp_path):
    w = twal.WriteAheadLog(tmp_path, D, segment_records=1024)
    w.append(random_logs(7, 6, id_space=4)[1])
    w.reset_to(20)
    with pytest.raises(ValueError, match="backwards"):
        w.reset_to(10)
    w.append(random_logs(8, 4, id_space=4)[1])
    with pytest.raises(ValueError, match="gap|retained"):
        w.truncate_to(10)
    assert w.t == 24
    with pytest.raises(ValueError, match="gap"):
        w.read_range(0, 24, device="cpu")
    w.truncate_to(20)
    assert w.t == 20
    assert w.drop_below(6) == 1 and w.segments() == []
    assert w.append(random_logs(9, 3, id_space=4)[1]) == 23
