"""The compressed tier's code table in the port: ``code_params``, ``build``,
``refresh``, ``diff_slots``, ``apply_with_codes``, ``query_weights`` and
``table_hash`` against the reference package, bit for bit (DESIGN.md §10)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import codes as jcodes  # noqa: E402
from repro.core import commands as jc  # noqa: E402
from repro.core import contracts as jcontracts  # noqa: E402
from repro.core import machine as jm  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.core import codes as tcodes  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402

from _torch_parity import np_, to_port_log, to_port_state  # noqa: E402
from test_torch_machine import D, random_log  # noqa: E402

TABLE_FIELDS = ("codes", "offset", "scale", "norms")


def assert_tables_equal(t_table, j_table):
    for f in TABLE_FIELDS:
        got, want = np_(getattr(t_table, f)), np.asarray(getattr(j_table, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert np.array_equal(got, want), f"{f} differs"
    assert tcodes.table_hash(t_table) == jcodes.table_hash(j_table)


def _contract_state(name, seed, cap=24, d=8, n=16, n_dead=3):
    """A reference state under contract ``name``: random rows plus rows at
    the contract's extremes (min_raw / max_raw columns), some deleted."""
    c = jcontracts.get_contract(name)
    rng = np.random.default_rng(seed)
    dt = c.np_storage_dtype
    vecs = rng.integers(c.min_raw, c.max_raw, size=(n, d), endpoint=True,
                        dtype=np.int64).astype(dt)
    vecs[0, :] = c.max_raw
    vecs[1, :] = c.min_raw
    vecs[2, ::2], vecs[2, 1::2] = c.min_raw, c.max_raw
    s = jm.bulk_apply(j_init(cap, d, contract=c), jc.insert_batch(
        jnp.arange(n, dtype=jnp.int64), jnp.asarray(vecs), c))
    dead = rng.choice(np.arange(3, n), size=n_dead, replace=False)
    return jm.bulk_apply(s, jc.delete_batch(jnp.asarray(np.sort(dead)), d, c))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("contract", sorted(tcontracts.CONTRACTS))
def test_build_matches_reference_for_every_contract(contract, seed):
    s = _contract_state(contract, seed)
    t = to_port_state(s)
    table = tcodes.build(t)
    assert_tables_equal(table, jcodes.build(s))
    assert table.codes.device == t.device


def test_build_of_empty_and_fresh_states_matches_reference():
    s = j_init(16, D)
    assert_tables_equal(tcodes.build(t_init(16, D, device="cpu")),
                        jcodes.build(s))
    s = jm.bulk_apply(s, jc.insert_batch(jnp.arange(5, dtype=jnp.int64),
                                         jnp.ones((5, D), jnp.int32)))
    assert_tables_equal(tcodes.build(to_port_state(s)), jcodes.build(s))


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.int64])
def test_code_params_wraparound_matches_reference(dtype):
    """Whole-range rows: ``hi - mid`` and ``dev + 126`` wrap in int32 in
    the reference; the port keeps every dtype step for step."""
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, size=(40, 12), endpoint=True,
                     dtype=dtype)
    v[0], v[1] = info.max, info.min
    v[2, :6] = info.max
    v[3, :6] = info.min + 1
    valid = rng.random(40) < 0.7
    valid[:4] = True
    for mask in (valid, np.zeros(40, bool), np.eye(40, dtype=bool)[5]):
        want = jcodes.code_params(jnp.asarray(v), jnp.asarray(mask))
        got = tcodes.code_params(torch.from_numpy(v), torch.from_numpy(mask))
        for g, w in zip(got, want):
            assert np.array_equal(np_(g), np.asarray(w))
        want_c = jcodes.encode_rows(jnp.asarray(v), jnp.asarray(mask), *want)
        got_c = tcodes.encode_rows(torch.from_numpy(v), torch.from_numpy(mask),
                                   *got)
        for g, w in zip(got_c, want_c):
            assert np.array_equal(np_(g), np.asarray(w))


def test_encode_rows_in_steps_equals_one_step(monkeypatch):
    s = _contract_state("Q16.16", 4, cap=40, n=30)
    t = to_port_state(s)
    whole = tcodes.build(t)
    monkeypatch.setattr(tcodes, "_ENCODE_ROWS", 7)
    assert_tables_equal(tcodes.build(t), jcodes.build(s))
    assert tcodes.table_hash(whole) == tcodes.table_hash(tcodes.build(t))


@pytest.mark.parametrize("seed", range(6))
def test_refresh_equals_build_on_random_logs(seed):
    """apply_with_codes over a randomized six-opcode log, in four slices,
    in both packages: every step's table equals both builds."""
    jlog = random_log(seed)
    tlog = to_port_log(jlog)
    js_, ts_ = j_init(32, D), t_init(32, D, device="cpu")
    jt, tt = jcodes.build(js_), tcodes.build(ts_)
    n = len(jlog)
    for a in range(0, n, n // 4):
        b = min(a + n // 4, n)
        js_, jt = jcodes.apply_with_codes(js_, jt, jlog.slice(a, b))
        ts_, tt = tcodes.apply_with_codes(ts_, tt, tlog.slice(a, b))
        assert_tables_equal(tt, jt)
        assert_tables_equal(tt, jcodes.build(js_))
        assert tcodes.table_hash(tt) == tcodes.table_hash(tcodes.build(ts_))


def test_diff_slots_matches_reference():
    jlog = random_log(11)
    s0 = jm.bulk_apply(j_init(32, D), jlog.slice(0, 24))
    s1 = jm.bulk_apply(s0, jlog.slice(24, len(jlog)))
    got = tcodes.diff_slots(to_port_state(s0), to_port_state(s1))
    assert got.dtype == torch.int32
    assert np.array_equal(np_(got), jcodes.diff_slots(s0, s1))


def test_refresh_incremental_path_when_params_stable():
    """An insert inside the per-dim envelope keeps the params and takes the
    row-touch path; the table still equals both builds."""
    s = _contract_state("Q16.16", 5, cap=32, n=16, n_dead=0)
    t = to_port_state(s)
    table = tcodes.build(t)
    mid = np.asarray(s.vectors)[:16].mean(axis=0).astype(np.int32)
    jlog = jc.insert_batch(jnp.asarray([100], jnp.int64),
                           jnp.asarray(mid[None, :]))
    s2, j2 = jcodes.apply_with_codes(s, jcodes.build(s), jlog)
    t2, table2 = tcodes.apply_with_codes(t, table, to_port_log(jlog))
    assert torch.equal(table2.offset, table.offset)
    assert torch.equal(table2.scale, table.scale)
    assert_tables_equal(table2, j2)
    assert tcodes.refresh(table2, t2, np.zeros(0, np.int32)) is table2


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("contract", ["Q16.16", "Q32.32"])
def test_query_weights_match_reference(contract, metric):
    """Including weights past W_BOUND, which both packages clip."""
    s = _contract_state(contract, 6)
    jt = jcodes.build(s)
    tt = tcodes.build(to_port_state(s))
    c = jcontracts.get_contract(contract)
    rng = np.random.default_rng(7)
    q = rng.integers(c.min_raw, c.max_raw, size=(5, 8), endpoint=True,
                     dtype=np.int64).astype(c.np_storage_dtype)
    q[0], q[1] = c.max_raw, c.min_raw
    want = np.asarray(jcodes.query_weights(jnp.asarray(q), jt, metric))
    got = np_(tcodes.query_weights(torch.from_numpy(q), tt, metric))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    if contract == "Q32.32":
        assert (np.abs(got.astype(np.int64)) == tcodes.W_BOUND).any()
    with pytest.raises(ValueError, match="metric"):
        tcodes.query_weights(torch.from_numpy(q), tt, "cosine")
