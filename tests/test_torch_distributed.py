"""The port's sharded layout, routing, merged manifest, sharded apply and
search twins and device-list mesh paths against the JAX package: the same
numpy-seeded inputs through both, compared bit for bit (no tolerance)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import boundary as jb  # noqa: E402
from repro.core import commands as jc  # noqa: E402
from repro.core import distributed as jd  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core import shard_wal as jsw  # noqa: E402
from repro.core import snapshot as jsnap  # noqa: E402
from repro.core.state import init_state as j_init_state  # noqa: E402
from repro_torch.core import boundary as tb  # noqa: E402
from repro_torch.core import codes as tcodes  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import query as tq  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import shard_wal as tsw  # noqa: E402
from repro_torch.core import snapshot as tsnap  # noqa: E402

from _torch_durable import D, random_logs  # noqa: E402
from _torch_parity import (assert_states_equal, np_, to_port_log,  # noqa: E402
                           to_port_state)

CAP = 16  # rows per shard


def _assert_logs_equal(jlog, tlog):
    for f in ("opcode", "arg0", "arg1", "arg2", "vec"):
        a, b = np.asarray(getattr(jlog, f)), np_(getattr(tlog, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _ids_on_shard(s, n_shards, count):
    """The first ``count`` ids that route to shard ``s``."""
    ids = np.arange(200 * count, dtype=np.int64)
    return ids[td.shard_of_id(ids, n_shards) == s][:count]


def _insert_logs(ids, seed=0):
    rng = np.random.default_rng(seed)
    raw = tb.normalize_embedding(torch.from_numpy(
        rng.normal(size=(len(ids), D)).astype(np.float32))).numpy()
    jlog = jc.insert_batch(jnp.asarray(ids), jnp.asarray(raw))
    return jlog, to_port_log(jlog)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_of_id_and_route_commands_match(n_shards):
    jlog, tlog = random_logs(1, 37, 25)
    ids = np.arange(-5, 300, dtype=np.int64)
    assert np.array_equal(td.shard_of_id(ids, n_shards),
                          np.asarray(jd.shard_of_id(jnp.asarray(ids),
                                                    n_shards)))
    _assert_logs_equal(jd.route_commands(jlog, n_shards),
                       td.route_commands(tlog, n_shards))


def test_route_commands_empty_shares_all_one_shard_and_empty_log():
    # three commands over four shards: at least one share is empty
    jlog, tlog = random_logs(2, 3, 10, weights=(0, 1, 0, 0, 0, 0))
    routed = td.route_commands(tlog, 4)
    _assert_logs_equal(jd.route_commands(jlog, 4), routed)
    assert (routed.opcode == jc.NOP).all(dim=1).any()
    # every command on shard 2: the others are NOP rows of the same length
    jlog, tlog = _insert_logs(_ids_on_shard(2, 4, 5))
    routed = td.route_commands(tlog, 4)
    _assert_logs_equal(jd.route_commands(jlog, 4), routed)
    assert routed.opcode.shape == (4, 5)
    assert (routed.opcode[2] == jc.INSERT).all()
    assert int(routed.opcode.abs().sum()) == 5 * jc.INSERT
    # an empty log routes to one NOP per shard, in both packages
    jlog, tlog = _insert_logs(np.zeros(0, np.int64))
    _assert_logs_equal(jd.route_commands(jlog, 3), td.route_commands(tlog, 3))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_init_sharded_host_hashes_match(n_shards):
    jg = jd.init_sharded_host(n_shards, CAP, D)
    tg = td.init_sharded_host(n_shards, CAP, D, device="cpu")
    assert_states_equal(jg, tg)
    assert th.hash_pytree(tg) == th.hash_state_device(tg) == \
        jh.hash_pytree(jg)
    assert tg.hnsw_entry.shape == tg.version.shape == (n_shards,)
    assert td.init_sharded_state(["cpu"] * n_shards, CAP, D).capacity == \
        n_shards * CAP


@pytest.fixture(scope="module")
def applied():
    """Both packages' sharded states after the same three batches (all six
    opcodes), through the reference's default driver."""
    jg = jd.init_sharded_host(3, CAP, D)
    js, ts = jg, to_port_state(jg)
    for seed in (3, 4, 5):
        jlog, tlog = random_logs(seed, 24, 30)
        js = jsw.bulk_apply_sharded(js, jlog, 3)
        ts = tsw.bulk_apply_sharded(ts, tlog, 3)
    assert_states_equal(js, ts)
    return js, ts


def test_slice_merge_and_stack_round_trips(applied):
    """The port's per-shard slices are views that ``merge_shards`` puts
    back together, and each equals the matching lane of the reference's
    stacked layout (``shard_stack``) and its ``shard_slice``."""
    js, ts = applied
    jstacked = jsw.shard_stack(js, 3)
    for s in range(3):
        local = td.shard_slice(ts, s, 3)
        assert_states_equal(jd.shard_slice(js, s, 3), local)
        for f in td.ROW_FIELDS + td.SCALAR_FIELDS + ("hnsw_neighbors",):
            assert np.array_equal(np_(getattr(local, f)),
                                  np.asarray(getattr(jstacked, f)[s])), f
        assert local.vectors.data_ptr() == \
            ts.vectors[s * CAP].data_ptr()
    parts = [td.shard_slice(ts, s, 3) for s in range(3)]
    assert_states_equal(td.merge_shards(parts), ts)
    assert_states_equal(jsw.shard_unstack(jstacked, 3), ts)
    assert tsw.live_count(ts) == jsw.live_count(js)
    assert np.array_equal(td.shard_live_counts(ts, 3),
                          jd.shard_live_counts(js, 3))
    assert np.array_equal(td.shard_live_counts(ts, 3), np_(ts.count))


@pytest.mark.parametrize("driver", [True, False, None])
def test_bulk_apply_sharded_drivers_match(applied, driver):
    """The port's one apply driver (per-shard ``machine.bulk_apply``) lands
    on the bits of each of the reference's drivers (``device=True``: the
    vmapped scan, ``False``: per-shard ``bulk_apply``, ``None``: auto) and
    of both device-list mesh paths."""
    js, ts = applied
    jlog, tlog = random_logs(6, 20, 30)
    want = jsw.bulk_apply_sharded(js, jlog, 3, device=driver)
    routed = td.route_commands(tlog, 3)
    got = tsw.bulk_apply_sharded(ts, tlog, 3, routed=routed)
    assert_states_equal(got, want)
    assert_states_equal(tsw.bulk_apply_sharded(ts, tlog, 3), want)
    assert_states_equal(got, td.distributed_replay(["cpu"] * 3, ts, routed))
    assert_states_equal(got,
                        td.distributed_bulk_apply(["cpu"] * 3, ts, routed))


def test_bulk_apply_sharded_auto_threshold():
    """On either side of the reference's auto threshold (shares up to
    ``_DEVICE_APPLY_MAX`` = 128 commands take its scan driver, longer ones
    per-shard ``bulk_apply``) the port's one driver equals both of the
    reference's drivers."""
    assert jsw._DEVICE_APPLY_MAX == 128
    jg = jd.init_sharded_host(2, 160, D)
    tg = to_port_state(jg)
    for count in (128, 129):
        jlog, tlog = _insert_logs(_ids_on_shard(1, 2, count), seed=count)
        got = tsw.bulk_apply_sharded(tg, tlog, 2)
        for driver in (None, True, False):
            assert_states_equal(
                got, jsw.bulk_apply_sharded(jg, jlog, 2, device=driver))


def test_relink_sharded_matches(applied):
    js, ts = applied
    jlog, tlog = random_logs(7, 12, 30, weights=(0, 0, 1, 0, 0, 0))
    js = jsw.bulk_apply_sharded(js, jlog, 3)
    ts = tsw.bulk_apply_sharded(ts, tlog, 3)
    got = tsw.relink_sharded(ts, 3)
    assert_states_equal(got, jsw.relink_sharded(js, 3))
    assert th.hash_pytree(got) == jh.hash_pytree(jsw.relink_sharded(js, 3))


def _queries(seed, n=5):
    q = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    return jb.admit_query(jnp.asarray(q)), tb.admit_query(torch.from_numpy(q))


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_sharded_searches_and_mesh_paths_match(applied, metric):
    """Exact, coarse (partial and full coverage) and HNSW over the sharded
    layout, the device-list mesh paths on ``["cpu"] * 3`` and the planner
    fan-outs: each equals the reference's twin; the exact route equals a
    single kernel holding the same live rows."""
    js, ts = applied
    jqr, tqr = _queries(8)
    k = 4
    pairs = [
        (jsw.exact_search_sharded(js, 3, jqr, k, metric=metric),
         tsw.exact_search_sharded(ts, 3, tqr, k, metric=metric)),
        (jsw.exact_search_sharded(js, 3, jqr, k, metric=metric),
         td.distributed_search(["cpu"] * 3, ts, tqr, k, metric=metric)),
        (jsw.exact_search_sharded(js, 3, jqr, k, metric=metric,
                                  use_kernel=True),
         tsw.exact_search_sharded(ts, 3, tqr, k, metric=metric,
                                  use_kernel=True)),
    ]
    for ef in (6, CAP):
        pairs.append((
            jsw.coarse_search_sharded(js, 3, jqr, k, ef_coarse=ef,
                                      metric=metric),
            tsw.coarse_search_sharded(ts, 3, tqr, k, ef_coarse=ef,
                                      metric=metric)))
        pairs.append((
            jsw.coarse_search_sharded(js, 3, jqr, k, ef_coarse=ef,
                                      metric=metric),
            td.distributed_coarse_search(["cpu"] * 3, ts, tqr, k,
                                         ef_coarse=ef, metric=metric)))
    if metric == "l2":
        for ef in (4, 8):
            pairs.append((jsw.hnsw_search_sharded(js, 3, jqr, k, ef=ef),
                          tsw.hnsw_search_sharded(ts, 3, tqr, k, ef=ef)))
            pairs.append((jsw.hnsw_search_sharded(js, 3, jqr, k, ef=ef),
                          td.distributed_hnsw_search(["cpu"] * 3, ts, tqr, k,
                                                     ef=ef)))
    for i, (want, got) in enumerate(pairs):
        assert np.array_equal(np_(got[0]), np.asarray(want[0])), i
        assert np.array_equal(np_(got[1]), np.asarray(want[1])), i
    # full coverage: the coarse route equals the exact one
    assert tq.retrieval_hash(*pairs[5][1]) == tq.retrieval_hash(*pairs[0][1])
    # a flat kernel holding the same rows answers the same
    flat = dataclasses.replace(
        to_port_state(j_init_state(3 * CAP, D)), vectors=ts.vectors,
        ids=ts.ids, valid=ts.valid)
    want = tsearch.exact_search(flat, tqr, k, metric=metric)
    assert all(np.array_equal(np_(a), np_(b))
               for a, b in zip(want, pairs[0][1]))


@pytest.mark.parametrize("route", ["exact", "hnsw", "coarse"])
def test_planned_fan_outs_match(applied, route):
    js, ts = applied
    jqr, tqr = _queries(9)
    jplan = jq.plan_query(jsw.live_count(js), 3, 8, route=route,
                          ef_coarse=8)
    tplan = tq.plan_query(tsw.live_count(ts), 3, 8, route=route,
                          ef_coarse=8)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    want = jq.sharded_host_query(js, 3, jqr, 3, jplan)
    got = tq.sharded_host_query(ts, 3, tqr, 3, tplan)
    assert np.array_equal(np_(got[0]), np.asarray(want[0]))
    assert np.array_equal(np_(got[1]), np.asarray(want[1]))
    mesh = tq.sharded_query(["cpu"] * 3, ts, tqr, 3, tplan)
    assert all(np.array_equal(np_(a), np_(b)) for a, b in zip(mesh, got))
    if route == "coarse":
        tables = [tcodes.build(td.shard_slice(ts, s, 3)) for s in range(3)]
        with_tables = tq.sharded_query(["cpu"] * 3, ts, tqr, 3, tplan,
                                       tables=tables)
        assert all(np.array_equal(np_(a), np_(b))
                   for a, b in zip(with_tables, got))


def test_merged_manifest_bytes_and_restore_match(applied, tmp_path):
    js, ts = applied
    jm = jd.snapshot_sharded(js, 3, jsnap.ChunkStore(tmp_path / "j"),
                             chunk_size=256)
    tm = td.snapshot_sharded(ts, 3, tsnap.ChunkStore(tmp_path / "t"),
                             chunk_size=256)
    assert tm == jm
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    state, h = td.restore_sharded(jm, tsnap.ChunkStore(tmp_path / "j"),
                                  device="cpu")
    assert_states_equal(state, js)
    assert h == jh.hash_pytree(js)
    jstate, jhash = jd.restore_sharded(tm, jsnap.ChunkStore(tmp_path / "t"))
    assert jhash == h
    bad = bytearray(tm)
    bad[12] ^= 1  # the combined hash
    with pytest.raises(ValueError, match="combined-hash"):
        td.restore_sharded(bytes(bad), tsnap.ChunkStore(tmp_path / "t"),
                           device="cpu")
    with pytest.raises(ValueError, match="not a sharded"):
        td.restore_sharded(b"VLRX" + tm[4:], tsnap.ChunkStore(tmp_path / "t"),
                           device="cpu")


def test_merge_candidates_is_the_flat_merge():
    """The one merge every fan-in ends in equals the reference's."""
    rng = np.random.default_rng(10)
    s = rng.integers(-50, 50, (4, 12)).astype(np.int64)
    s[:, ::4] = jsearch.INF
    i = rng.permutation(48).reshape(4, 12).astype(np.int64)
    want = jsearch.merge_candidates(jnp.asarray(s), jnp.asarray(i), 5)
    got = tsearch.merge_candidates(torch.from_numpy(s), torch.from_numpy(i),
                                   5)
    assert all(np.array_equal(np_(a), np.asarray(b))
               for a, b in zip(got, want))
