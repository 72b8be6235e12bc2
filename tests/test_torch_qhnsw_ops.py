"""qhnsw: the plain versions of the HNSW kernels (``kernels/qhnsw/ref.py``)
against the reference, bit for bit, and the wrapper's packing.

``search_ref`` against the reference's ``query.batched_hnsw_search``;
``insert_ref`` against the graph the reference's ``_apply_insert_segment``
(the fast insert) and ``replay`` (the default insert) link, and against
``relink`` / ``fresh_build``; on every storage type (Q8.8 int16, Q16.16
int32, Q32.32 int64), on rows whose sums of squares wrap, on tombstoned
states (the entry deleted, slots reused) and on an empty graph. On a card
(``cuda``) the kernels are held against these plain versions; the JAX
package is imported inside the tests that compare with it, so that test
runs on a machine without JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_qhnsw_ops.py``)."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import commands as tc  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import hnsw as thnsw  # noqa: E402
from repro_torch.core import machine as tm  # noqa: E402
from repro_torch.core import shard_wal as tsw  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402
from repro_torch.kernels.qhnsw import ops, ref  # noqa: E402

from _torch_parity import cuda_or_skip, np_, state_np  # noqa: E402

D, CAP, DEGREE, LEVELS = 24, 128, 8, 3

# (contract name, low, high) of the raw rows; the last two wrap the int64
# sums of squares (Q32.32 differences up to 2^34, Q16.16 up to 2^32)
CASES = [("Q8.8", -2**14, 2**14), ("Q16.16", -2**16, 2**16),
         ("Q32.32", -2**33, 2**33), ("Q16.16", -2**31, 2**31 - 1)]
CASE_IDS = ["q8_8", "q16_16", "q32_32_wrap", "q16_16_wrap"]


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import commands as jc
    from repro.core import contracts as jcontracts
    from repro.core import hnsw as jhnsw
    from repro.core import machine as jm
    from repro.core import query as jq
    from repro.core.state import init_state as j_init
    return types.SimpleNamespace(jnp=jnp, jc=jc, jcontracts=jcontracts,
                                 jhnsw=jhnsw, jm=jm, jq=jq, j_init=j_init)


def _port(jstate):
    from repro_torch.core.state import state_from_numpy
    return state_from_numpy(state_np(jstate), jstate.contract_name,
                            device="cpu")


def _rows(rng, n, lo, hi, contract):
    return rng.integers(lo, hi, (n, D)).astype(
        np.dtype(str(tcontracts.get_contract(contract).storage_dtype)
                 .removeprefix("torch.")))


def _churned(j, contract, lo, hi, seed):
    """A reference state: 90 rows, 12 deletes (the entry among them), then
    10 inserts replayed into tombstoned slots."""
    rng = np.random.default_rng(seed)
    c = j.jcontracts.get_contract(contract)
    vecs = _rows(rng, 100, lo, hi, contract)
    s = j.j_init(CAP, D, contract=c, hnsw_degree=DEGREE, hnsw_levels=LEVELS)
    s = j.jm.bulk_apply(s, j.jc.insert_batch(
        j.jnp.arange(90, dtype=j.jnp.int64), j.jnp.asarray(vecs[:90]), c))
    dead = rng.choice(90, 12, replace=False)
    dead = np.unique(np.append(dead, int(s.ids[int(s.hnsw_entry)])))
    s = j.jm.bulk_apply(s, j.jc.delete_batch(j.jnp.asarray(dead), D, c))
    s = j.jm.replay(s, j.jc.insert_batch(
        j.jnp.arange(500, 510, dtype=j.jnp.int64), j.jnp.asarray(vecs[90:]),
        c))
    return s, rng


def _graph(st):
    return [np_(st.hnsw_neighbors), np_(st.hnsw_levels), np_(st.hnsw_entry)]


def _assert_graph(got, want_state):
    for g, w in zip(_graph(got), _graph(want_state)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_search_ref_matches_batched_hnsw_search(case):
    j = _jax()
    contract, lo, hi = case
    s, rng = _churned(j, contract, lo, hi, 1)
    t = _port(s)
    q = _rows(rng, 6, lo, hi, contract)
    for k, ef in ((5, 16), (20, 8)):
        want = j.jq.batched_hnsw_search(s, j.jnp.asarray(q), k, ef=ef)
        for got in (ref.search_ref(t, torch.from_numpy(q), k, ef),
                    ops.qhnsw_search(t, torch.from_numpy(q), k, ef)):
            assert got[0].shape == (6, min(k, ef))
            for g, w in zip(got, want):
                assert np.array_equal(np_(g), np.asarray(w))


def _stored(j, s, log, ef, fast):
    """The reference's state after linking ``log``'s fresh inserts (the
    fast segment or the default replay), and the port state holding the
    same stored rows under ``s``'s graph, with the slots they took."""
    n = len(log)
    if fast:
        want = j.jm._apply_insert_segment(s, j.jm._pad_log(log, 32),
                                          j.jnp.int32(n), ef_construction=ef)
    else:
        want = j.jm.replay(s, log, ef_construction=ef)
    stored = dataclasses.replace(
        _port(want), hnsw_neighbors=torch.from_numpy(np.array(
            s.hnsw_neighbors)), hnsw_levels=torch.from_numpy(np.array(
                s.hnsw_levels)), hnsw_entry=torch.tensor(int(s.hnsw_entry),
                                                         dtype=torch.int32))
    slots = np.flatnonzero(~np.asarray(s.valid))[:n]
    return want, stored, slots


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "default"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_insert_ref_matches_reference_insert(case, fast):
    j = _jax()
    contract, lo, hi = case
    s, rng = _churned(j, contract, lo, hi, 2)
    c = j.jcontracts.get_contract(contract)
    log = j.jc.insert_batch(j.jnp.arange(700, 720, dtype=j.jnp.int64),
                            j.jnp.asarray(_rows(rng, 20, lo, hi, contract)), c)
    want, stored, slots = _stored(j, s, log, 32, fast)
    got = ref.insert_ref(stored, torch.from_numpy(slots[None]), len(slots),
                         32, fast)
    _assert_graph(got, want)
    # the wrapper on CPU tensors, with a sentinel column past n_real
    packed, n_real = ref.pack_slots([slots.tolist() + [CAP]], CAP)
    _assert_graph(ops.qhnsw_insert(stored, torch.from_numpy(packed), n_real,
                                   ef_construction=32, fast=fast), want)


def test_insert_ref_m_above_ef_takes_the_default_path():
    """m = degree // 2 = 4 > ef_construction = 3: the reference's fast
    insert falls back to its default path, and so does ``insert_ref``."""
    j = _jax()
    s, rng = _churned(j, "Q16.16", -2**16, 2**16, 3)
    log = j.jc.insert_batch(j.jnp.arange(800, 812, dtype=j.jnp.int64),
                            j.jnp.asarray(_rows(rng, 12, -2**16, 2**16,
                                                "Q16.16")))
    want, stored, slots = _stored(j, s, log, 3, True)
    for fast in (True, False):
        _assert_graph(ref.insert_ref(stored, torch.from_numpy(slots[None]),
                                     len(slots), 3, fast), want)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_rebuild_matches_relink_and_fresh_build(case):
    j = _jax()
    contract, lo, hi = case
    s, _ = _churned(j, contract, lo, hi, 4)
    t = _port(s)
    want = j.jhnsw.relink(s)
    _assert_graph(thnsw.rebuild(t, 32, True), want)
    _assert_graph(thnsw.rebuild(t, 32, False), want)
    _assert_graph(thnsw.fresh_build(t), want)


def test_empty_graph_search_and_first_insert():
    j = _jax()
    s = j.j_init(CAP, D, hnsw_degree=DEGREE, hnsw_levels=LEVELS)
    t = _port(s)
    q = np.random.default_rng(5).integers(-2**16, 2**16, (3, D)).astype(
        np.int32)
    want = j.jq.batched_hnsw_search(s, j.jnp.asarray(q), 4, ef=8)
    got = ref.search_ref(t, torch.from_numpy(q), 4, 8)
    for g, w in zip(got, want):
        assert np.array_equal(np_(g), np.asarray(w))
    assert (np_(got[2]) == -1).all()
    log = j.jc.insert_batch(j.jnp.arange(3, dtype=j.jnp.int64),
                            j.jnp.asarray(q))
    want, stored, slots = _stored(j, s, log, 32, True)
    got = ref.insert_ref(stored, torch.from_numpy(slots[None]), 3, 32, True)
    _assert_graph(got, want)
    assert int(got.hnsw_entry) == int(slots[0])  # the first node


def test_pack_slots_sentinels_and_empty_shares():
    slots, n_real = ref.pack_slots([[3, 1], [], [5]], 10)
    assert n_real == 2 and slots.dtype == np.int32
    assert slots.tolist() == [[3, 1], [10, 10], [5, 10]]
    slots, n_real = ref.pack_slots([[], []], 10)
    assert n_real == 0 and slots.tolist() == [[10], [10]]
    assert ref.out_width(10, 64) == 10 and ref.out_width(70, 32) == 32


@pytest.fixture(scope="module")
def sharded():
    """A port-only sharded state: 3 shards of 48 rows, 100 inserts and 8
    deletes through the per-shard bulk apply."""
    rng = np.random.default_rng(6)
    sh = td.init_sharded_host(3, 48, D, device="cpu", hnsw_degree=DEGREE,
                              hnsw_levels=LEVELS)
    vecs = torch.from_numpy(rng.integers(-2**16, 2**16, (100, D)))
    sh = tsw.bulk_apply_sharded(sh, tc.insert_batch(torch.arange(100), vecs),
                                3, device=False)
    dead = tc.delete_batch(torch.from_numpy(rng.choice(100, 8, replace=False)),
                           D, device="cpu")
    return tsw.bulk_apply_sharded(sh, dead, 3, device=False), rng


def test_stacked_lanes_equal_per_shard_calls(sharded):
    """A stacked state's lanes are independent graphs: the wrapper on the
    stack equals the plain version on each ``shard_slice``; an empty share
    leaves its lane's graph as it was."""
    sh, rng = sharded
    stacked = tsw.shard_stack(sh, 3)
    q = torch.from_numpy(rng.integers(-2**16, 2**16, (4, D)).astype(np.int32))
    got = ops.qhnsw_search(stacked, q, 5, 16)
    assert got[0].shape == (3, 4, 5)
    for s in range(3):
        want = ref.search_ref(td.shard_slice(sh, s, 3), q, 5, 16)
        for g, w in zip(got, want):
            assert torch.equal(g[s], w)
    out = thnsw.rebuild(stacked, 32, True)
    for s in range(3):
        _graph_s = [out.hnsw_neighbors[s], out.hnsw_levels[s],
                    out.hnsw_entry[s]]
        want = thnsw.relink(td.shard_slice(sh, s, 3))
        for g, w in zip(_graph_s, _graph(want)):
            assert np.array_equal(np_(g), w)
    packed, n_real = ref.pack_slots([[], [], []], 48)
    same = ops.qhnsw_insert(stacked, torch.from_numpy(packed), n_real)
    for a, b in zip(_graph(same), _graph(stacked)):
        assert np.array_equal(a, b)


def test_device_graph_runs_equal_host_inserts(sharded, monkeypatch):
    """F's device-graph bookkeeping (runs of queued inserts, each linked by
    one ``link_``, cut at deletes, upserts and reused slots) run on CPU
    tensors equals the host-graph path hash for hash, flat and stacked."""
    from repro_torch.core import hashing, state as tstate
    sh, rng = sharded
    ops_ = rng.choice([tc.INSERT] * 5 + [tc.DELETE] * 2 + [tc.LINK,
                                                           tc.SET_META],
                      size=120)
    log = tc.CommandLog(
        opcode=torch.from_numpy(ops_.astype(np.int32)),
        arg0=torch.from_numpy(rng.integers(0, 70, 120)),
        arg1=torch.from_numpy(rng.integers(0, 70, 120)),
        arg2=torch.from_numpy(rng.integers(-5, 5, 120)),
        vec=torch.from_numpy(rng.integers(-2**16, 2**16, (120, D)).astype(
            np.int32)))
    g = t_init(96, D, device="cpu", hnsw_degree=DEGREE, hnsw_levels=LEVELS)
    routed = td.route_commands(log, 3)
    host = [hashing.hash_pytree(tm.replay(g, log)),
            hashing.hash_pytree(tm.bulk_apply(g, log)),
            hashing.hash_pytree(tsw.apply_routed_device(sh, routed, 3))]
    monkeypatch.setattr(tstate, "graph_on_host", lambda device: False)
    monkeypatch.setattr(tm, "graph_on_host", lambda device: False)
    dev = [hashing.hash_pytree(tm.replay(g, log)),
           hashing.hash_pytree(tm.bulk_apply(g, log)),
           hashing.hash_pytree(tsw.apply_routed_device(sh, routed, 3))]
    assert dev == host
    assert host[0] == host[1]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    dev = cuda_or_skip()
    rng = np.random.default_rng(7)
    for dtype, lo, hi in ((torch.int16, -2**14, 2**14),
                          (torch.int32, -2**31, 2**31 - 1),
                          (torch.int64, -2**33, 2**33)):
        contract = {torch.int16: tcontracts.Q8_8, torch.int32:
                    tcontracts.Q16_16, torch.int64: tcontracts.Q32_32}[dtype]
        g = t_init(CAP, D, contract=contract, device="cpu",
                   hnsw_degree=DEGREE, hnsw_levels=LEVELS)
        vecs = torch.from_numpy(rng.integers(lo, hi, (100, D)))
        st = tm.bulk_apply(g, tc.insert_batch(torch.arange(100), vecs,
                                              contract))
        st = tm.bulk_apply(st, tc.delete_batch(torch.arange(0, 100, 9), D,
                                               contract, device="cpu"))
        q = torch.from_numpy(rng.integers(lo, hi, (5, D))).to(dtype)
        got = ops.qhnsw_search(st.to(dev), q.to(dev), 10, 32)
        for a, b in zip(got, ref.search_ref(st, q, 10, 32)):
            assert torch.equal(a.cpu(), b)
        for fast in (True, False):
            got = thnsw.rebuild(st.to(dev), 32, fast)
            for a, b in zip(_graph(got), _graph(thnsw.rebuild(st, 32, fast))):
                assert np.array_equal(a, b)
