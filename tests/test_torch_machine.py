"""F in the port: replay == reference replay (state and hash), and inside
the port bulk_apply == replay == apply_chunked, on randomized six-opcode
logs with upserts, slot reuse, full-arena rejection and NOP padding."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import boundary as jb  # noqa: E402
from repro.core import commands as jc  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import machine as jm  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import machine as tm  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402

from _torch_parity import assert_states_equal, to_port_log  # noqa: E402

D = 8
N = 48


def random_log(seed, n=N, id_space=14, weights=(1, 3, 1, 1, 1, 1)):
    """A random mixed log (all six opcodes, duplicate ids, invalid targets)
    as a reference CommandLog built from numpy."""
    rng = np.random.default_rng(seed)
    ops = rng.choice(6, size=n, p=np.asarray(weights) / sum(weights))
    a0 = rng.integers(0, id_space, size=n)
    a1 = rng.integers(0, id_space, size=n)
    a2 = rng.integers(-50, 50, size=n)
    meta_slot = rng.integers(-1, 4, size=n)
    a1 = np.where(ops == jc.SET_META, meta_slot, a1)
    a1 = np.where(np.isin(ops, [jc.LINK, jc.UNLINK, jc.SET_META]), a1, 0)
    a2 = np.where(ops == jc.SET_META, a2, 0)
    vec = np.asarray(jb.normalize_embedding(
        rng.normal(size=(n, D)).astype(np.float32)))
    vec = np.where((ops == jc.INSERT)[:, None], vec, 0).astype(np.int32)
    return jc.CommandLog(
        opcode=jnp.asarray(ops.astype(np.int32)),
        arg0=jnp.asarray(np.where(ops == jc.NOP, 0, a0).astype(np.int64)),
        arg1=jnp.asarray(a1.astype(np.int64)),
        arg2=jnp.asarray(a2.astype(np.int64)), vec=jnp.asarray(vec))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [10, 32])
def test_replay_matches_reference_and_bulk(seed, cap):
    jlog = random_log(seed)
    j_final = jm.replay(j_init(cap, D), jlog)
    tlog = to_port_log(jlog)
    s0 = t_init(cap, D, device="cpu")
    t_final = tm.replay(s0, tlog)
    assert_states_equal(j_final, t_final)
    h = jh.hash_pytree(j_final)
    assert th.hash_pytree(t_final) == h
    assert th.hash_pytree(tm.bulk_apply(s0, tlog)) == h
    assert th.hash_pytree(tm.apply_chunked(s0, tlog, 7)) == h


def test_bulk_apply_on_insert_heavy_and_churn_logs():
    """Long clean INSERT runs, DELETE runs reusing slots, SET_META runs."""
    s0 = t_init(40, D, device="cpu")
    for seed, w in [(11, (0, 6, 2, 0, 0, 1)), (12, (1, 4, 3, 1, 0, 2))]:
        jlog = random_log(seed, n=64, id_space=30, weights=w)
        tlog = to_port_log(jlog)
        want = jh.hash_pytree(jm.bulk_apply(j_init(40, D), jlog))
        assert th.hash_pytree(tm.replay(s0, tlog)) == want
        assert th.hash_pytree(tm.bulk_apply(s0, tlog)) == want


def test_replay_matches_reference_under_q8_8():
    """An int16-storage contract through F (vectors stay int16 end to end)."""
    from repro.core.contracts import Q8_8 as JQ8_8
    from repro_torch.core.contracts import Q8_8 as TQ8_8
    jlog = random_log(21)
    jlog = jc.CommandLog(opcode=jlog.opcode, arg0=jlog.arg0, arg1=jlog.arg1,
                         arg2=jlog.arg2, vec=(jlog.vec >> 8).astype(jnp.int16))
    want = jm.replay(j_init(12, D, contract=JQ8_8), jlog)
    tlog = to_port_log(jlog, TQ8_8)
    s0 = t_init(12, D, contract=TQ8_8, device="cpu")
    assert_states_equal(want, tm.replay(s0, tlog))
    assert th.hash_pytree(tm.bulk_apply(s0, tlog)) == jh.hash_pytree(want)


def test_bulk_apply_leaves_input_untouched():
    s0 = t_init(16, D, device="cpu")
    h0 = th.hash_pytree(s0)
    tm.bulk_apply(s0, to_port_log(random_log(3)))
    tm.replay(s0, to_port_log(random_log(4)))
    assert th.hash_pytree(s0) == h0
