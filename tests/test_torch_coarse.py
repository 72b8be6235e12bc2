"""The coarse route in the port: qcoarse (plain version on the CPU, CUDA
kernel on the card), ``search.coarse_search`` and ``query.execute_plan``
against the reference package, bit for bit."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import codes as jcodes  # noqa: E402
from repro.core import commands as jc  # noqa: E402
from repro.core import machine as jm  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import search as js  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro.kernels.qcoarse import ops as jqcoarse  # noqa: E402
from repro.kernels.qcoarse import ref as jqcoarse_ref  # noqa: E402
from repro_torch.core import codes as tcodes  # noqa: E402
from repro_torch.core import query as tq  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.kernels.qcoarse import ops as tqcoarse  # noqa: E402
from repro_torch.kernels.qcoarse import ref as tqcoarse_ref  # noqa: E402

from _torch_parity import cuda_or_skip, np_, to_port_state  # noqa: E402

W = tqcoarse.W_BOUND
QCOARSE_SHAPES = [(1, 1, 8), (4, 16, 32), (8, 128, 64), (128, 256, 512),
                  (7, 100, 384), (130, 257, 640), (3, 33, 8192)]


def _qcoarse_inputs(nq, nn, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-W, W + 1, size=(nq, d)).astype(np.int32),
            rng.integers(-127, 128, size=(nn, d)).astype(np.int8))


@pytest.mark.parametrize("nq,nn,d", QCOARSE_SHAPES)
def test_qcoarse_plain_matches_reference(nq, nn, d):
    w, c = _qcoarse_inputs(nq, nn, d, seed=nq + nn + d)
    want = np.asarray(jqcoarse.qcoarse(jnp.asarray(w), jnp.asarray(c)))
    got = np_(tqcoarse.qcoarse(torch.from_numpy(w), torch.from_numpy(c)))
    assert got.dtype == np.int64 and np.array_equal(got, want)


def test_qcoarse_planes_match_reference():
    w, c = _qcoarse_inputs(7, 100, 384, seed=1)
    want = np.asarray(jqcoarse.qcoarse_planes(jnp.asarray(w), jnp.asarray(c)))
    got = np_(tqcoarse.qcoarse_planes(torch.from_numpy(w),
                                      torch.from_numpy(c)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(
        np_(tqcoarse_ref.combine_planes_ref(torch.from_numpy(got))),
        np.asarray(jqcoarse_ref.combine_planes_ref(jnp.asarray(want))))


def test_qcoarse_extreme_values():
    d = 8192
    w = np.full((2, d), W, np.int32)
    w[1] = -W
    c = np.concatenate([np.full((1, d), 127, np.int8),
                        np.full((1, d), -127, np.int8)])
    got = np_(tqcoarse.qcoarse(torch.from_numpy(w), torch.from_numpy(c)))
    want = np.asarray(jqcoarse.qcoarse(jnp.asarray(w), jnp.asarray(c)))
    assert np.array_equal(got, want)
    assert int(got[0, 0]) == d * W * 127
    planes = tqcoarse.qcoarse_planes(torch.from_numpy(w), torch.from_numpy(c))
    assert np.array_equal(np_(tqcoarse_ref.combine_planes_ref(planes)), want)


def test_qcoarse_rejects_oversized_dim():
    w = torch.zeros((2, 16384), dtype=torch.int32)
    c = torch.zeros((2, 16384), dtype=torch.int8)
    for fn in (tqcoarse.qcoarse, tqcoarse.qcoarse_planes):
        with pytest.raises(ValueError, match="dim"):
            fn(w, c)
    with pytest.raises(ValueError, match="dim"):
        jqcoarse.qcoarse(jnp.asarray(np_(w)), jnp.asarray(np_(c)))


# --------------------------------------------------------------------------- #
# coarse_search and the planner's coarse route
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)  # states are immutable; build each once
def _coarse_state(n_live, d, n_dead=0, duplicate_rows=0, seed=7, cap=None):
    """A reference state with n_live fresh rows, optionally tombstones and
    duplicated vectors under distinct ids (ties must break on id)."""
    rng = np.random.default_rng(seed)
    cap = cap or max(64, n_live + n_dead + duplicate_rows)
    vecs = rng.integers(-65536, 65537, (n_live, d)).astype(np.int32)
    if duplicate_rows:
        vecs = np.concatenate([vecs, vecs[:duplicate_rows]], axis=0)
    n = len(vecs)
    s = jm.bulk_apply(j_init(cap, d), jc.insert_batch(
        jnp.arange(n, dtype=jnp.int64), jnp.asarray(vecs)))
    if n_dead:
        dead = np.arange(0, n, max(1, n // n_dead))[:n_dead]
        s = jm.bulk_apply(s, jc.delete_batch(jnp.asarray(dead), d))
    return s


def _queries(nq, d, seed=11):
    return np.random.default_rng(seed).integers(
        -65536, 65537, (nq, d)).astype(np.int32)


def _both(s, q, k, ef, metric, use_kernel):
    want = js.coarse_search(s, jcodes.build(s), jnp.asarray(q), k,
                            ef_coarse=ef, metric=metric, use_kernel=use_kernel)
    t = to_port_state(s)
    got = tsearch.coarse_search(t, tcodes.build(t), torch.from_numpy(q), k,
                                ef_coarse=ef, metric=metric,
                                use_kernel=use_kernel)
    for g, w in zip(got, want):
        assert np_(g).dtype == np.int64
        assert np.array_equal(np_(g), np.asarray(w))
    return got


CASES = {  # name: (state kwargs, k, ef_coarse)
    "partial": (dict(n_live=28, d=8, seed=5), 5, 8),
    "cover": (dict(n_live=28, d=8, seed=5), 5, 64),
    "kernel-sizes": (dict(n_live=37, d=24), 5, 16),
    "tombstones": (dict(n_live=30, d=16, n_dead=9), 6, 64),
    "tombstones-partial": (dict(n_live=30, d=16, n_dead=9), 6, 8),
    "duplicates": (dict(n_live=20, d=12, duplicate_rows=10), 8, 64),
    "fewer-live-than-k": (dict(n_live=3, d=8, n_dead=1, cap=16), 5, 16),
    "d96": (dict(n_live=150, d=96, cap=256, n_dead=20), 10, 32),
}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_coarse_search_matches_reference(case, metric, use_kernel):
    kw, k, ef = CASES[case]
    s = _coarse_state(**kw)
    ids, scores = _both(s, _queries(4, kw["d"]), k, ef, metric, use_kernel)
    if ef >= kw["n_live"] + kw.get("duplicate_rows", 0):  # full coverage
        want = tsearch.exact_search(to_port_state(s),
                                    torch.from_numpy(_queries(4, kw["d"])),
                                    k, metric=metric)
        assert torch.equal(ids, want[0]) and torch.equal(scores, want[1])
    if case == "fewer-live-than-k":
        assert (np_(ids)[:, 2:] == -1).all()
        assert (np_(scores)[:, 2:] == tsearch.INF).all()


def test_coarse_search_rejects_ef_below_k():
    s = _coarse_state(10, 8)
    t = to_port_state(s)
    with pytest.raises(ValueError, match="ef_coarse"):
        tsearch.coarse_search(t, tcodes.build(t),
                              torch.from_numpy(_queries(2, 8)), 6,
                              ef_coarse=4)
    with pytest.raises(ValueError):
        js.coarse_search(s, jcodes.build(s), jnp.asarray(_queries(2, 8)), 6,
                         ef_coarse=4)


@pytest.mark.parametrize("with_table", [False, True])
def test_execute_plan_coarse_matches_reference(with_table):
    s = _coarse_state(24, 8, seed=8, cap=32)
    t = to_port_state(s)
    q = _queries(3, 8)
    for ef_coarse in (6, 32):
        plan_kw = dict(route="coarse", ef_coarse=ef_coarse, dim=8)
        jplan = jq.plan_query(24, 4, 64, **plan_kw)
        tplan = tq.plan_query(24, 4, 64, **plan_kw)
        want = jq.execute_plan(s, jnp.asarray(q), 4, jplan,
                               codes=jcodes.build(s) if with_table else None)
        got = tq.execute_plan(t, torch.from_numpy(q), 4, tplan,
                              codes=tcodes.build(t) if with_table else None)
        for g, w in zip(got, want):
            assert np.array_equal(np_(g), np.asarray(w))


@pytest.mark.cuda
def test_qcoarse_kernel_matches_plain_version_on_card():
    dev = cuda_or_skip()
    for nq, nn, d in QCOARSE_SHAPES + [(5, 77, 7), (3, 9, 101),
                                       (64, 4099, 2304)]:
        w, c = _qcoarse_inputs(nq, nn, d, seed=d)
        wt, ct = torch.from_numpy(w).to(dev), torch.from_numpy(c).to(dev)
        assert torch.equal(tqcoarse.qcoarse(wt, ct).cpu(),
                           tqcoarse_ref.qcoarse_ref(wt.cpu(), ct.cpu()))
