"""HNSW, exact search and the planner: port == reference, bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import boundary as jb  # noqa: E402
from repro.core import commands as jc  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import hnsw as jhnsw  # noqa: E402
from repro.core import machine as jm  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import search as js  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import hnsw as thnsw  # noqa: E402
from repro_torch.core import query as tq  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402

from _torch_parity import assert_states_equal, np_, to_port_state  # noqa: E402

D = 64
CAP = 256


@pytest.fixture(scope="module")
def churned():
    """A reference state: 200 inserts, then 40 deletes (entry included),
    then 20 more inserts reusing tombstoned slots."""
    rng = np.random.default_rng(5)
    vecs = jb.normalize_embedding(rng.normal(size=(220, D)).astype(np.float32))
    s = jm.bulk_apply(j_init(CAP, D),
                      jc.insert_batch(jnp.arange(200, dtype=jnp.int64), vecs[:200]))
    dead = np.sort(rng.choice(200, size=40, replace=False))
    entry_id = int(s.ids[int(s.hnsw_entry)])
    dead = np.unique(np.append(dead, entry_id))
    s = jm.bulk_apply(s, jc.delete_batch(jnp.asarray(dead), D))
    s = jm.replay(s, jc.insert_batch(jnp.arange(500, 520, dtype=jnp.int64),
                                      vecs[200:]))
    return s, np.array(jb.normalize_embedding(
        rng.normal(size=(6, D)).astype(np.float32)))


def test_levels_and_entry_repair(churned):
    s, _ = churned
    t = to_port_state(s)
    assert np.array_equal(np_(thnsw.raw_levels(t)),
                          np.asarray(jhnsw.raw_levels(s)))
    assert int(thnsw.repair_entry(t)) == int(jhnsw.repair_entry(s))
    assert np.array_equal(np_(thnsw.relink_order(t)),
                          np.asarray(jhnsw.relink_order(s)))
    ids = np.asarray([0, 1, -1, 2**40, -2**62, 77, 2**63 - 1], np.int64)
    assert np.array_equal(thnsw.level_of_id(ids, 8), np.asarray(
        jax.vmap(lambda i: jhnsw.level_of_id(i, 8))(jnp.asarray(ids))))
    assert np.array_equal(thnsw.splitmix64(ids),
                          np.asarray(jhnsw.splitmix64(jnp.asarray(ids))))
    dead = dataclasses.replace(s, valid=s.valid.at[int(s.hnsw_entry)].set(False))
    assert_states_equal(jhnsw.ensure_live_entry(dead),
                        thnsw.ensure_live_entry(to_port_state(dead)))


def test_relink_and_fresh_build_match_reference(churned):
    s, _ = churned
    t = to_port_state(s)
    want = jhnsw.relink(s)
    got = thnsw.relink(t)
    assert_states_equal(want, got)
    assert th.hash_pytree(thnsw.fresh_build(t)) == jh.hash_pytree(want)


def test_hnsw_search_matches_reference(churned):
    s, q = churned
    t = to_port_state(s)
    for b in range(q.shape[0]):
        want = jhnsw.hnsw_search(s, jnp.asarray(q[b]), 10, ef=32)
        got = thnsw.hnsw_search(t, torch.tensor(q[b]), 10, ef=32)
        for g, w in zip(got, want):
            assert np.array_equal(np_(g), np.asarray(w))
    for lvl in range(s.hnsw_max_levels):
        want = jhnsw.greedy_step_level(s, jnp.asarray(q[1]), jnp.int32(lvl),
                                       s.hnsw_entry)
        got = thnsw.greedy_step_level(t, torch.tensor(q[1]), lvl,
                                      int(t.hnsw_entry))
        assert got == int(want)
    for fast, dead_ok in [(False, False), (False, True), (True, False)]:
        want = jhnsw.search_layer(s, jnp.asarray(q[0]), s.hnsw_entry,
                                  jnp.int32(0), 24, fast=fast, dead_ok=dead_ok)
        got = thnsw.search_layer(t, torch.tensor(q[0]),
                                 int(t.hnsw_entry), 0, 24, fast=fast,
                                 dead_ok=dead_ok)
        for g, w in zip(got, want):
            assert np.array_equal(np_(g), np.asarray(w))


def test_batched_hnsw_search_and_route_hashes(churned):
    s, q = churned
    t = to_port_state(s)
    want = jq.batched_hnsw_search(s, jnp.asarray(q), 5, ef=16)
    got = tq.batched_hnsw_search(t, torch.from_numpy(q), 5, ef=16)
    for g, w in zip(got, want):
        assert np.array_equal(np_(g), np.asarray(w))
    for route in ("exact", "hnsw"):
        jp = jq.plan_query(int(s.count), 5, 16, route=route)
        tp = tq.plan_query(int(t.count), 5, 16, route=route)
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        jids, jsc = jq.execute_plan(s, jnp.asarray(q), 5, jp)
        tids, tsc = tq.execute_plan(t, torch.from_numpy(q), 5, tp)
        assert tq.retrieval_hash(tids, tsc) == jq.retrieval_hash(jids, jsc)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_exact_search_matches_reference(churned, metric, k):
    s, q = churned
    t = to_port_state(s)
    want = js.exact_search(s, jnp.asarray(q), k, metric=metric)
    # the reference's kernel route unrolls k selection passes in interpret
    # mode; it is held against its plain route by the reference's own tests
    want_kern = want if k > 10 else js.exact_search(
        s, jnp.asarray(q), k, metric=metric, use_kernel=True)
    for use_kernel in (False, True):
        got = tsearch.exact_search(t, torch.from_numpy(q), k, metric=metric,
                                   use_kernel=use_kernel)
        for g, w, wk in zip(got, want, want_kern):
            assert np.array_equal(np_(g), np.asarray(w))
            assert np.array_equal(np_(g), np.asarray(wk))


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(2)
    sa = np.sort(rng.integers(0, 50, size=(3, 6)), axis=1).astype(np.int64)
    sb = np.sort(rng.integers(0, 50, size=(3, 6)), axis=1).astype(np.int64)
    sb[:, -2:] = 1 << 62
    ia = rng.integers(0, 99, size=(3, 6)).astype(np.int64)
    ib = np.where(sb < (1 << 62), rng.integers(0, 99, size=(3, 6)), -1)
    want = js.merge_topk(*(jnp.asarray(x) for x in (sa, ia, sb, ib)), 8)
    got = tsearch.merge_topk(*(torch.from_numpy(x) for x in (sa, ia, sb, ib)), 8)
    for g, w in zip(got, want):
        assert np.array_equal(np_(g), np.asarray(w))


def test_plan_query_grid_matches_reference():
    for live in (0, 10, 1024, 1025, 5000):
        for k in (1, 16, 65):
            for ef in (8, 64, 2000):
                for ef_coarse in (0, 32):
                    for dim in (64, 9000):
                        kw = dict(use_kernel=True, ef_coarse=ef_coarse,
                                  dim=dim, graph_gen=2)
                        assert dataclasses.asdict(
                            jq.plan_query(live, k, ef, **kw)) == \
                            dataclasses.asdict(tq.plan_query(live, k, ef, **kw))
    for route in ("hnsw", "coarse", "bogus"):
        with pytest.raises(ValueError):
            jq.plan_query(10, 70, 64, route=route)
        with pytest.raises(ValueError):
            tq.plan_query(10, 70, 64, route=route)
    # execute_plan runs the coarse route (the compressed tier), with the
    # same answers as the reference's
    s = jm.bulk_apply(j_init(16, 8), jc.insert_batch(
        jnp.arange(10, dtype=jnp.int64),
        jb.normalize_embedding(np.random.default_rng(3).normal(
            size=(10, 8)).astype(np.float32))))
    q = np.array(jb.admit_query(np.random.default_rng(4).normal(
        size=(2, 8)).astype(np.float32)))
    plan_kw = dict(route="coarse", ef_coarse=8, dim=8)
    want = jq.execute_plan(s, jnp.asarray(q), 3,
                           jq.plan_query(10, 3, 8, **plan_kw))
    got = tq.execute_plan(to_port_state(s), torch.from_numpy(q), 3,
                          tq.plan_query(10, 3, 8, **plan_kw))
    for g, w in zip(got, want):
        assert np.array_equal(np_(g), np.asarray(w))
