"""The stacked routed apply: ``shard_stack`` / ``shard_unstack``,
``apply_routed_device`` and ``bulk_apply_sharded(device=)``, port ==
reference, array for array and hash for hash (on the CPU the stacked
apply runs the plain version of the qhnsw insert)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402,F401
from repro.core import distributed as jd  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import shard_wal as jsw  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import shard_wal as tsw  # noqa: E402

from _torch_durable import random_logs  # noqa: E402
from _torch_parity import (assert_states_equal, np_,  # noqa: E402
                           to_port_state)

CAP = 64  # rows per shard
D = 32


def _applied(n_shards, seeds, n=120, id_space=150):
    """Both packages' sharded states after the same random batches (all
    six opcodes, duplicate ids, deletes that reuse slots)."""
    js = jd.init_sharded_host(n_shards, CAP, D)
    ts = to_port_state(js)
    for seed in seeds:
        jlog, tlog = random_logs(seed, n, id_space, dim=D)
        js = jsw.bulk_apply_sharded(js, jlog, n_shards, device=False)
        ts = tsw.bulk_apply_sharded(ts, tlog, n_shards, device=False)
    assert_states_equal(js, ts)
    return js, ts


@pytest.fixture(scope="module")
def applied3():
    return _applied(3, (11, 12))


@pytest.mark.parametrize("n_shards,seed", [(2, 21), (3, 22), (4, 23)])
def test_shard_stack_matches_reference_and_round_trips(n_shards, seed):
    js, ts = _applied(n_shards, (seed,))
    jst, tst = jsw.shard_stack(js, n_shards), tsw.shard_stack(ts, n_shards)
    for f, arr in tst.leaves():
        want = np.asarray(getattr(jst, f))
        assert arr.shape == want.shape, f
        assert np.array_equal(np_(arr), want), f
    # views of the sharded layout's storage, no copies of row data
    assert tst.vectors.data_ptr() == ts.vectors.data_ptr()
    assert tst.hnsw_neighbors.data_ptr() == ts.hnsw_neighbors.data_ptr()
    for s in range(n_shards):  # each lane is distributed.shard_slice
        local = td.shard_slice(ts, s, n_shards)
        for f, arr in local.leaves():
            assert np.array_equal(np_(arr), np_(getattr(tst, f)[s])), f
    back = tsw.shard_unstack(tst, n_shards)
    assert_states_equal(back, ts)
    assert_states_equal(back, jsw.shard_unstack(jst, n_shards))
    assert back.hnsw_neighbors.data_ptr() == ts.hnsw_neighbors.data_ptr()


@pytest.mark.parametrize("seed,n", [(31, 17), (32, 24), (33, 40)])
def test_apply_routed_device_matches_reference(applied3, seed, n):
    """Inserts, upserts, deletes, links and meta, with routing NOPs inside
    the shares and pow2 NOP padding past them (17 / 24 / 40 commands over 3
    shards give shares that are not powers of two)."""
    js, ts = applied3
    jlog, tlog = random_logs(seed, n, 150, dim=D)
    jr, tr = jd.route_commands(jlog, 3), td.route_commands(tlog, 3)
    n_real = int(tr.opcode.shape[1])
    want = jsw.apply_routed_device(js, jr, 3)
    got = tsw.apply_routed_device(ts, tr, 3)
    assert_states_equal(got, want)
    assert th.hash_pytree(got) == jh.hash_pytree(want)
    assert np.array_equal(np_(got.version), np_(ts.version) + n_real)
    padded = tsw._pad_routed(tr, 64)
    assert padded.opcode.shape == (3, 64)
    assert (padded.opcode[:, n_real:] == 0).all()
    assert (padded.vec[:, n_real:] == 0).all()


@pytest.mark.parametrize("on_device", [True, False, None])
def test_bulk_apply_sharded_device_choices(applied3, on_device):
    js, ts = applied3
    jlog, tlog = random_logs(41, 30, 150, dim=D)
    want = jsw.bulk_apply_sharded(js, jlog, 3, device=on_device)
    got = tsw.bulk_apply_sharded(ts, tlog, 3, device=on_device)
    assert_states_equal(got, want)
    for other in (True, False, None):
        assert_states_equal(tsw.bulk_apply_sharded(ts, tlog, 3, device=other),
                            got)


def test_bulk_apply_sharded_long_shares():
    """Shares longer than ``_DEVICE_APPLY_MAX`` = 128: the automatic choice
    takes per-shard ``bulk_apply``, and all three choices agree with each other
    and with the reference."""
    assert tsw._DEVICE_APPLY_MAX == jsw._DEVICE_APPLY_MAX == 128
    js = jd.init_sharded_host(2, 96, D)
    ts = to_port_state(js)
    jlog, tlog = random_logs(51, 300, 150, dim=D)
    assert int(td.route_commands(tlog, 2).opcode.shape[1]) > 128
    want = jsw.bulk_apply_sharded(js, jlog, 2)
    outs = [tsw.bulk_apply_sharded(ts, tlog, 2, device=dv)
            for dv in (None, True, False)]
    for got in outs:
        assert_states_equal(got, want)


def test_routed_device_deletes_only_and_empty_batch(applied3):
    """A batch that only deletes (entry repair, no insert launch), and an
    empty batch (one routing NOP per shard)."""
    js, ts = applied3
    jlog, tlog = random_logs(61, 12, 150, weights=(0, 0, 1, 0, 0, 0),
                             dim=D)
    assert_states_equal(tsw.apply_routed_device(ts, td.route_commands(tlog, 3),
                                                3),
                        jsw.apply_routed_device(js, jd.route_commands(jlog, 3),
                                                3))
    jlog, tlog = random_logs(62, 0, 150, dim=D)
    got = tsw.bulk_apply_sharded(ts, tlog, 3, device=True)
    assert_states_equal(got, jsw.bulk_apply_sharded(js, jlog, 3, device=True))
    assert np.array_equal(np_(got.version), np_(ts.version) + 1)
