"""qhnsw's cluster design: the card's kernels against their plain versions
(``kernels/qhnsw/ref.py``) bit for bit, and on the CPU the premise the
insert's reverse prune rests on.

The insert takes the new row's distance to each owner from its beam
instead of computing the owner's distance to the new row: that is exact
only if ``ref``'s wide distance (the wrapped int64 sum of squared
differences) is symmetric bit for bit, which the hypothesis test holds on
int16, int32 and int64 rows, values that overflow int64 included.

The ``cuda`` tests need the card (``python -m pytest --noconftest -m cuda
tests/test_torch_qhnsw_cluster.py``; no JAX). They cover dimensions that
no cluster size divides and small ones (37, 300, 2304), every storage
type, neighbour rows with repeated slots (the default beam's scatter), an
empty graph and its first inserts, four stacked shards in one launch
with one lane of sentinel slots, and a degree past one warp's lanes (the
beam's merge then rank sorts); each in both insert variants."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core import commands as tc  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import machine as tm  # noqa: E402
from repro_torch.core import shard_wal as tsw  # noqa: E402
from repro_torch.core.state import WorkingState  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402
from repro_torch.kernels.qhnsw import kernel, ops, ref  # noqa: E402

from _torch_parity import cuda_or_skip  # noqa: E402

CONTRACTS = {torch.int16: (tcontracts.Q8_8, -2**14, 2**14),
             torch.int32: (tcontracts.Q16_16, -2**16, 2**16),
             torch.int64: (tcontracts.Q32_32, -2**33, 2**33)}
NP = {torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64}


def _wrapped(a: np.ndarray, b: np.ndarray) -> int:
    """sum((a - b)^2) in exact integers, wrapped to int64."""
    s = sum((int(x) - int(y)) ** 2 for x, y in zip(a, b)) % 2**64
    return s - 2**64 if s >= 2**63 else s


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       dtype=st.sampled_from([torch.int16, torch.int32, torch.int64]),
       extreme=st.booleans())
def test_wide_distance_is_symmetric(seed, dtype, extreme):
    rng = np.random.default_rng(seed)
    info = np.iinfo(NP[dtype])
    d = int(rng.integers(1, 80))
    if extreme:  # the type's ends: differences and squares past int64
        pool = np.array([info.min, info.max, 0, -1, info.min + 1,
                         info.max - 1], NP[dtype])
        a, b = rng.choice(pool, d), rng.choice(pool, d)
    else:
        a = rng.integers(info.min, info.max, d, dtype=NP[dtype],
                         endpoint=True)
        b = rng.integers(info.min, info.max, d, dtype=NP[dtype],
                         endpoint=True)
    st_ = t_init(4, d, contract=CONTRACTS[dtype][0], device="cpu")
    vectors = st_.vectors.clone()
    vectors[0], vectors[1] = torch.from_numpy(a), torch.from_numpy(b)
    ws = WorkingState(dataclasses.replace(st_, vectors=vectors),
                      host_graph=True)
    q64 = vectors[:2].to(torch.int64)
    ab, ba = ref._device_dists(ws, q64, [(0, np.array([1])),
                                         (1, np.array([0]))])
    want = _wrapped(a, b)
    assert int(ab[0]) == int(ba[0]) == want
    # the reverse prune's form (_connect: rows minus the owner's row)
    va, vb = q64[0], q64[1]
    assert int(((va - vb) ** 2).sum()) == int(((vb - va) ** 2).sum()) == want


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _graph(st_):
    return st_.hnsw_neighbors, st_.hnsw_levels, st_.hnsw_entry


def _equal(got, want) -> None:
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _stored(rng, dtype, cap, d, n_linked, n_stored, n_dead, degree=16,
            levels=4):
    """On the CPU: n_linked rows inserted and linked, n_dead of them
    deleted, then n_stored rows stored but not linked (what a run of
    queued inserts leaves). Returns (state, the stored slots [1, n])."""
    contract, lo, hi = CONTRACTS[dtype]
    st_ = t_init(cap, d, contract=contract, device="cpu", hnsw_degree=degree,
                 hnsw_levels=levels)
    vecs = torch.from_numpy(rng.integers(lo, hi, (n_linked + n_stored, d)))
    if n_linked:
        st_ = tm.bulk_apply(st_, tc.insert_batch(
            torch.arange(n_linked), vecs[:n_linked], contract))
    if n_dead:
        st_ = tm.bulk_apply(st_, tc.delete_batch(torch.from_numpy(
            rng.choice(n_linked, n_dead, replace=False)), d, contract,
            device="cpu"))
    free = torch.nonzero(~st_.valid).reshape(-1)[:n_stored]
    vectors, ids, valid = st_.vectors.clone(), st_.ids.clone(), \
        st_.valid.clone()
    vectors[free] = vecs[n_linked:].to(vectors.dtype)
    ids[free] = torch.arange(10**6, 10**6 + n_stored)
    valid[free] = True
    st_ = dataclasses.replace(st_, vectors=vectors, ids=ids, valid=valid)
    return st_, free.to(torch.int32)[None]


def _hold(st_, slots, dev, q, k=10, ef=32):
    """Both insert variants and the search, card against plain."""
    n = slots.shape[1]
    for fast in (True, False):
        got = ops.qhnsw_insert(st_.to(dev), slots.to(dev), n, fast=fast)
        want = ref.insert_ref(st_, slots, n, 32, fast)
        _equal(_graph(got), _graph(want))
    _equal(ops.qhnsw_search(want.to(dev), q.to(dev), k, ef),
           ref.search_ref(want, q, k, ef))
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.int64],
                         ids=["int16", "int32", "int64"])
@pytest.mark.parametrize("d", [37, 300, 2304])
def test_cluster_kernels_match_plain_versions(d, dtype):
    """d = 37 and 300 are divided by no cluster size the launch takes
    (300 int32 rows split into 75 16-byte units over 8 CTAs; 37 takes the
    plain-load path), 2304 is the main path's width."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(d)
    st_, slots = _stored(rng, dtype, 256, d, 120, 40, 6)
    lo, hi = CONTRACTS[dtype][1:]
    q = torch.from_numpy(rng.integers(lo, hi, (6, d))).to(dtype)
    _hold(st_, slots, dev, q)
    if d * st_.vectors.element_size() >= 256:  # the insert ran as a cluster
        assert kernel.CLUSTER["insert"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "default"])
def test_repeated_slots_in_neighbour_rows(fast):
    """Rows that name a slot twice, and -1 beside slot 0 (both clip to
    row 0): the default beam's scatter lets the last lane that writes a
    slot win; the fast beam takes both copies. Held on the insert run and
    the search over the same graph."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(11)
    st_, slots = _stored(rng, torch.int32, 256, 300, 120, 30, 0)
    nbr = st_.hnsw_neighbors.clone()
    live = torch.nonzero(st_.valid & (st_.ids < 10**6)).reshape(-1)
    for r in live[::3].tolist():
        row = nbr[0, r]
        a, b = int(row[0]), int(row[1])
        if a < 0 or b < 0:
            continue
        nbr[0, r, :6] = torch.tensor([a, 0, -1, a, b, 0], dtype=torch.int32)
    st_ = dataclasses.replace(st_, hnsw_neighbors=nbr)
    n = slots.shape[1]
    got = ops.qhnsw_insert(st_.to(dev), slots.to(dev), n, fast=fast)
    want = ref.insert_ref(st_, slots, n, 32, fast)
    _equal(_graph(got), _graph(want))
    q = torch.from_numpy(rng.integers(-2**16, 2**16, (8, 300))).to(
        torch.int32)
    for k, ef in ((10, 32), (5, 64)):
        _equal(ops.qhnsw_search(st_.to(dev), q.to(dev), k, ef),
               ref.search_ref(st_, q, k, ef))


@pytest.mark.cuda
def test_degree_past_one_warp():
    """degree = 40: more new entries per expansion than a warp has lanes,
    so the beam's merge takes its rank sort and every per-lane loop runs
    in two chunks."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(14)
    st_, slots = _stored(rng, torch.int32, 256, 300, 150, 30, 5, degree=40,
                         levels=3)
    q = torch.from_numpy(rng.integers(-2**16, 2**16, (6, 300))).to(
        torch.int32)
    _hold(st_, slots, dev, q, k=10, ef=48)


@pytest.mark.cuda
def test_empty_graph_and_its_first_inserts():
    dev = cuda_or_skip()
    rng = np.random.default_rng(12)
    st_, slots = _stored(rng, torch.int32, 128, 2304, 0, 9, 0)
    q = torch.from_numpy(rng.integers(-2**16, 2**16, (3, 2304))).to(
        torch.int32)
    _equal(ops.qhnsw_search(st_.to(dev), q.to(dev), 4, 8),
           ref.search_ref(st_, q, 4, 8))
    want = _hold(st_, slots, dev, q)
    assert int(want.hnsw_entry) == int(slots[0, 0])  # the first node


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 2304])
def test_four_stacked_shards_with_a_sentinel_lane(d):
    """Four lanes in one launch; lane 3 gets no rows (a run of sentinel
    slots, ``pack_slots``'s padding), and its graph stays as it was."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(13)
    ns, cap = 4, 96
    sh = td.init_sharded_host(ns, cap, d, device="cpu")
    vecs = torch.from_numpy(rng.integers(-2**16, 2**16, (240, d)))
    sh = tsw.bulk_apply_sharded(sh, tc.insert_batch(torch.arange(240), vecs),
                                ns, device=False)
    sh = tsw.bulk_apply_sharded(sh, tc.delete_batch(torch.from_numpy(
        rng.choice(240, 12, replace=False)), d, device="cpu"), ns,
        device=False)
    stacked = tsw.shard_stack(sh, ns)
    vectors, ids, valid = (stacked.vectors.clone(), stacked.ids.clone(),
                           stacked.valid.clone())
    shares = []
    for lane in range(ns - 1):
        free = torch.nonzero(~valid[lane]).reshape(-1)[:10 + 5 * lane]
        vectors[lane, free] = torch.from_numpy(rng.integers(
            -2**16, 2**16, (len(free), d))).to(vectors.dtype)
        ids[lane, free] = torch.arange(10**6 + 100 * lane,
                                       10**6 + 100 * lane + len(free))
        valid[lane, free] = True
        shares.append(free.tolist())
    shares.append([])
    stacked = dataclasses.replace(stacked, vectors=vectors, ids=ids,
                                  valid=valid)
    packed, n_real = ref.pack_slots(shares, cap)
    packed = torch.from_numpy(packed)
    q = torch.from_numpy(rng.integers(-2**16, 2**16, (5, d))).to(torch.int32)
    for fast in (True, False):
        got = ops.qhnsw_insert(stacked.to(dev), packed.to(dev), n_real,
                               fast=fast)
        want = ref.insert_ref(stacked, packed, n_real, 32, fast)
        _equal(_graph(got), _graph(want))
        assert torch.equal(want.hnsw_neighbors[3], stacked.hnsw_neighbors[3])
        assert torch.equal(want.hnsw_levels[3], stacked.hnsw_levels[3])
        _equal(ops.qhnsw_search(want.to(dev), q.to(dev), 10, 32),
               ref.search_ref(want, q, 10, 32))
