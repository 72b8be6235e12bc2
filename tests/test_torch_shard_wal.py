"""The port's ShardedDurableStore and GroupCommitWriter's routed hooks
against the JAX package: the same history gives byte-identical store
directories, each package recovers the other's store with the same
(t, hash), and the reconcile / refusal / tamper contracts hold."""
import dataclasses
import json
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import distributed as jd  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import shard_wal as jsw  # noqa: E402
from repro.core import wal as jwal  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import shard_wal as tsw  # noqa: E402
from repro_torch.core import wal as twal  # noqa: E402

from _torch_durable import D, assert_same_files, random_logs  # noqa: E402
from _torch_parity import assert_states_equal, to_port_state  # noqa: E402

NS = 3
CAP = 16
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_sharded"


def _genesis():
    jg = jd.init_sharded_host(NS, CAP, D)
    return jg, to_port_state(jg)


def _batches(seed, n, step, id_space=20):
    jlog, tlog = random_logs(seed, n, id_space)
    return ([jlog.slice(i, min(i + step, n)) for i in range(0, n, step)],
            [tlog.slice(i, min(i + step, n)) for i in range(0, n, step)])


def _stores(root, jg, tg, **kw):
    j = jsw.ShardedDurableStore(root / "j", jg, n_shards=NS, **kw)
    t = tsw.ShardedDurableStore(root / "t", tg, n_shards=NS, device="cpu",
                                **kw)
    return j, t


def _policy(mod):
    return mod.GroupCommitPolicy(max_batch=1 << 20, max_delay_s=3600)


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    """Both packages' stores fed the same history — routed appends, a group
    commit pre-routed and one not, two checkpoints, a retain, a tail —
    plus the reference's in-memory states at each checkpoint."""
    root = tmp_path_factory.mktemp("sharded_history")
    jg, tg = _genesis()
    jb, tb = _batches(0, 60, 10)
    j, t = _stores(root, jg, tg, segment_records=16, chunk_size=256)
    js, ts = jg, tg
    marks = {}

    def apply(i):
        nonlocal js, ts
        js = jsw.bulk_apply_sharded(js, jb[i], NS)
        ts = tsw.bulk_apply_sharded(ts, tb[i], NS)

    for i in (0, 1):
        assert j.append(jb[i]) == t.append(tb[i])
        apply(i)
    # a group commit of two batches, not routed by the caller
    jw, tw = jwal.GroupCommitWriter(j, _policy(jwal)), \
        twal.GroupCommitWriter(t, _policy(twal))
    for i in (2, 3):
        assert jw.submit(jb[i]) == tw.submit(tb[i])
        apply(i)
    assert jw.target_t == tw.target_t and t.t == j.t
    assert jw.flush() == tw.flush() == tw.target_t
    j.checkpoint(js)
    t.checkpoint(ts)
    marks["ckpt1"] = (t.t, jh.hash_pytree(js))
    # a group commit pre-routed by the caller, as the engine does it
    for i in (4,):
        routed = td.route_commands(tb[i], NS)
        assert jw.submit(jb[i], routed=jd.route_commands(jb[i], NS)) == \
            tw.submit(tb[i], routed=routed)
        apply(i)
    assert jw.flush() == tw.flush()
    j.checkpoint(js)
    t.checkpoint(ts)
    marks["ckpt2"] = (t.t, jh.hash_pytree(js))
    assert j.retain(1) == t.retain(1)
    assert j.append(jb[5], routed=jd.route_commands(jb[5], NS)) == \
        t.append(tb[5], routed=td.route_commands(tb[5], NS))
    apply(5)
    assert_states_equal(js, ts)
    marks["end"] = (t.t, jh.hash_pytree(js))
    return root, marks, (js, ts)


def test_store_directories_are_byte_identical(history):
    root, marks, _ = history
    assert_same_files(root / "j", root / "t")
    assert json.loads((root / "t" / "store.json").read_text()) == \
        {"n_shards": NS}
    assert not (root / "t" / "shard_0000" / "chunks").exists()
    records = tsw.ShardedDurableStore(root / "t", device="cpu")
    assert records.merged_records() == [marks["ckpt2"][0]]  # retain(1)


def test_each_package_recovers_the_others_store(history, tmp_path):
    root, marks, (js, _) = history
    shutil.copytree(root, tmp_path / "c")
    t_of_j = tsw.ShardedDurableStore(tmp_path / "c" / "j", device="cpu")
    j_of_t = jsw.ShardedDurableStore(tmp_path / "c" / "t")
    state, h, t = t_of_j.recover()
    assert (t, h) == marks["end"]
    assert (t, h) == j_of_t.recover()[1:][::-1]
    assert_states_equal(state, js)
    # restore_at the retained checkpoint, verified against its record
    assert t_of_j.restore_at(marks["ckpt2"][0])[1] == marks["ckpt2"][1]
    assert t_of_j.shard_logs(marks["ckpt2"][0], t)[0].opcode.shape == \
        (t - marks["ckpt2"][0],)
    with pytest.raises(ValueError):  # retention dropped the first record
        t_of_j.restore_at(marks["ckpt1"][0] - 1)


def test_rollback_drops_history_and_records_alike(history, tmp_path):
    root, marks, _ = history
    shutil.copytree(root, tmp_path / "c")
    j = jsw.ShardedDurableStore(tmp_path / "c" / "j")
    t = tsw.ShardedDurableStore(tmp_path / "c" / "t", device="cpu")
    t_ckpt = marks["ckpt2"][0]
    with pytest.raises(ValueError, match="ahead"):
        t.rollback_to(t.t + 1)
    j.rollback_to(t_ckpt)
    t.rollback_to(t_ckpt)
    assert t.t == t_ckpt and t.merged_records() == [t_ckpt]
    assert_same_files(tmp_path / "c" / "j", tmp_path / "c" / "t")
    assert t.recover()[1:] == (marks["ckpt2"][1], t_ckpt)


def test_crash_between_shard_flushes_reconciles_to_min(tmp_path):
    """A crash between per-shard flushes leaves a shard-order prefix holding
    the group; both packages' recover() land on the last globally whole
    cursor, and the store takes the group again afterwards."""
    jg, tg = _genesis()
    jb, tb = _batches(4, 40, 10)
    j, t = _stores(tmp_path, jg, tg, segment_records=256)
    jref = jg
    for a, b in zip(jb[:3], tb[:3]):
        j.append(a)
        t.append(b)
        jref = jsw.bulk_apply_sharded(jref, a, NS)
    t_acked = t.t
    for store, routed in ((j, jd.route_commands(jb[3], NS)),
                          (t, td.route_commands(tb[3], NS))):
        for s in (0, 1):  # shards 0-1 got the next group, shard 2 did not
            sh = store.shards[s]
            sh.append(jax.tree.map(lambda a, s=s: a[s], routed)
                      if store is j else td.share(routed, s))
    assert t.shard_ts()[0] > t_acked == t.shard_ts()[2]
    assert_same_files(tmp_path / "j", tmp_path / "t")
    with pytest.raises(RuntimeError, match="recover"):
        t.append(tb[3])  # refused before anything is written
    assert_same_files(tmp_path / "j", tmp_path / "t")
    jr = jsw.ShardedDurableStore(tmp_path / "j")
    tr = tsw.ShardedDurableStore(tmp_path / "t", device="cpu")
    state, h, t_got = tr.recover()
    assert (t_got, h) == (t_acked, jh.hash_pytree(jref))
    assert jr.recover()[1:] == (h, t_got)
    assert len(set(tr.shard_ts())) == 1
    assert_same_files(tmp_path / "j", tmp_path / "t")
    assert tr.append(tb[3]) == jr.append(jb[3])
    assert tr.restore_at(tr.t)[1] == jh.hash_pytree(
        jsw.bulk_apply_sharded(jref, jb[3], NS))


def test_tamper_divergence_and_shard_count_are_refused(tmp_path):
    jg, tg = _genesis()
    _, tb = _batches(6, 20, 10)
    store = tsw.ShardedDurableStore(tmp_path, tg, n_shards=NS,
                                    segment_records=256, device="cpu")
    ref = tg
    for b in tb:
        store.append(b)
        ref = tsw.bulk_apply_sharded(ref, b, NS)
    store.checkpoint(ref)
    bad = dataclasses.replace(ref, version=torch.tensor([1, 2, 1]))
    with pytest.raises(ValueError, match="disagree"):
        store.checkpoint(bad)
    path = store._merged_path(store.t)
    rec = json.loads(path.read_text())
    rec["hash"] = f"{int(rec['hash'], 16) ^ 1:#018x}"
    path.write_text(json.dumps(rec))
    with pytest.raises(ValueError, match="hash mismatch"):
        store.restore_at(store.t)
    with pytest.raises(ValueError, match="shards"):
        tsw.ShardedDurableStore(tmp_path, n_shards=NS + 1, device="cpu")
    with pytest.raises(ValueError, match="not a ShardedDurableStore"):
        tsw.ShardedDurableStore(tmp_path / "absent", device="cpu")
    with pytest.raises(ValueError, match="shares"):
        store.append_many_routed([td.route_commands(tb[0], NS + 1)])


def test_backends_form_drives_local_stores(tmp_path):
    """``backends=``: the coordinator drives any objects with the
    DurableStore surface (here local stores in their own directories);
    it keeps only store.json and the merged records, and lands on the
    same (t, hash) as the local form."""
    from repro_torch.core.durability import DurableStore
    jg, tg = _genesis()
    _, tb = _batches(8, 30, 10)
    local = tsw.ShardedDurableStore(tmp_path / "local", tg, n_shards=NS,
                                    device="cpu")
    backends = [DurableStore(tmp_path / f"b{s}", td.shard_slice(tg, s, NS),
                             device="cpu") for s in range(NS)]
    with pytest.raises(ValueError, match="backends"):
        tsw.ShardedDurableStore(tmp_path / "coord", backends=backends,
                                n_shards=NS + 1, device="cpu")
    coord = tsw.ShardedDurableStore(tmp_path / "coord", backends=backends,
                                    device="cpu")
    ref = tg
    for b in tb:
        assert coord.append(b) == local.append(b)
        ref = tsw.bulk_apply_sharded(ref, b, NS)
    coord.checkpoint(ref)
    local.checkpoint(ref)
    assert coord.retain(1)["chunks_dropped"] > 0
    assert sorted(p.name for p in (tmp_path / "coord").iterdir()) == \
        ["merged", "store.json"]
    again = tsw.ShardedDurableStore(tmp_path / "coord", backends=backends,
                                    device="cpu")
    assert again.recover()[1:] == local.recover()[1:] == \
        (th.hash_pytree(ref), local.t)


class _FailingSink:
    """A sharded sink whose append fails after landing some shares: the
    first ``land`` batches of the group become durable."""

    def __init__(self, store, land):
        self.store, self.land = store, land
        self.planned_advance = store.planned_advance

    @property
    def t(self):
        return self.store.t

    def append_many(self, logs):
        self.store.append_many(logs[:self.land])
        raise OSError("disk full")


@pytest.mark.parametrize("land", [0, 1, 2])
def test_writer_target_t_and_partial_failure_match(tmp_path, land):
    """target_t predicts the padded global cursor (heaviest share per
    batch); a flush that fails after landing ``land`` batches drops
    exactly those from the buffer in both packages, and a retry lands the
    rest."""
    jg, tg = _genesis()
    jb, tb = _batches(11, 24, 8)
    j, t = _stores(tmp_path, jg, tg, segment_records=256)
    jw = jwal.GroupCommitWriter(_FailingSink(j, land), _policy(jwal))
    tw = twal.GroupCommitWriter(_FailingSink(t, land), _policy(twal))
    predicted = [tw.submit(b) for b in tb]
    assert predicted == [jw.submit(b) for b in jb]
    assert predicted[-1] == tw.target_t
    for w in (jw, tw):
        with pytest.raises(OSError):
            w.flush()
    assert t.t == j.t == ([0] + predicted)[land]
    assert (tw.pending, tw.target_t, tw._advance) == \
        (jw.pending, jw.target_t, jw._advance)
    assert tw.target_t == predicted[-1]
    tw.sink = t
    jw.sink = j
    assert tw.flush() == jw.flush() == predicted[-1]
    assert_same_files(tmp_path / "j", tmp_path / "t")


def test_fixture_written_by_the_reference_recovers(tmp_path):
    """The JAX-written sharded fixture (scripts/gen_golden_torch_sharded.py):
    its store recovers with the recorded (t, merged hash, shard_ts) and
    every restore_at hash, and its VLRS manifest restores with its hash."""
    expect = json.loads((FIXTURE / "expected.json").read_text())
    shutil.copytree(FIXTURE / "store", tmp_path / "store")
    store = tsw.ShardedDurableStore(tmp_path / "store", device="cpu")
    state, h, t = store.recover()
    assert (t, f"{h:#018x}", store.shard_ts()) == (
        expect["recover"]["t"], expect["recover"]["hash"],
        expect["recover"]["shard_ts"])
    for off, want in expect["restore_at"].items():
        assert f"{store.restore_at(int(off))[1]:#018x}" == want, off
    from repro_torch.core import snapshot as tsnap
    shutil.copytree(FIXTURE / "vlrs_chunks", tmp_path / "vlrs_chunks")
    st, hv = td.restore_sharded((FIXTURE / "vlrs_manifest.bin").read_bytes(),
                                tsnap.ChunkStore(tmp_path / "vlrs_chunks"),
                                device="cpu")
    assert f"{hv:#018x}" == expect["vlrs_hash"]
    assert st.capacity == expect["n_shards"] * expect["capacity_per_shard"]
