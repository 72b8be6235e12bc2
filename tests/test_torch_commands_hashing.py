"""Command-log bytes and state hashes: identical across the two packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import boundary as jb  # noqa: E402
from repro.core import commands as jc  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import machine as jm  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core.contracts import Q8_8 as JQ8_8  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.core import commands as tc  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import query as tq  # noqa: E402
from repro_torch.core.contracts import Q8_8 as TQ8_8  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402

from _torch_parity import assert_states_equal, np_, to_port_log, \
    to_port_state  # noqa: E402

D = 16


def _jax_log(n=20, seed=0, contract=None):
    rng = np.random.default_rng(seed)
    kw = {} if contract is None else {"contract": contract}
    vecs = jb.normalize_embedding(
        rng.normal(size=(n, D)).astype(np.float32), **kw)
    log = jc.insert_batch(jnp.asarray(rng.permutation(n) + 5), vecs, **kw)
    log = log.concat(jc.delete_cmd(7, D, **kw))
    log = log.concat(jc.link_cmd(5, 6, D, **kw))
    log = log.concat(jc.unlink_cmd(5, 6, D, **kw))
    log = log.concat(jc.set_meta_cmd(8, 1, -42, D, **kw))
    return log.concat(jc._mk(jc.NOP, D, kw.get("contract", jc.DEFAULT_CONTRACT)))


@pytest.mark.parametrize("q88", [False, True])
def test_log_bytes_identical_both_ways(q88):
    jcon = JQ8_8 if q88 else None
    tcon = TQ8_8 if q88 else tc.DEFAULT_CONTRACT
    jlog = _jax_log(contract=jcon)
    blob = jc.log_to_bytes(jlog)
    tlog = tc.log_from_bytes(blob, tcon, device="cpu")
    assert tc.log_to_bytes(tlog) == blob
    assert tc.log_to_bytes(to_port_log(jlog, tcon)) == blob
    back = jc.log_from_bytes(tc.log_to_bytes(tlog), jcon or jc.DEFAULT_CONTRACT)
    for f in tc.FIELDS:
        assert np.array_equal(np.asarray(getattr(back, f)),
                              np.asarray(getattr(jlog, f)))


def test_builders_match_reference():
    rng = np.random.default_rng(1)
    ids = rng.permutation(12).astype(np.int64)
    raw = rng.integers(-65536, 65537, size=(12, D)).astype(np.int32)
    pairs = [
        (jc.insert_batch(jnp.asarray(ids), jnp.asarray(raw)),
         tc.insert_batch(torch.from_numpy(ids), torch.from_numpy(raw))),
        (jc.delete_batch(jnp.asarray(ids), D),
         tc.delete_batch(torch.from_numpy(ids), D)),
        (jc.canonicalize_batch(jc.insert_batch(jnp.asarray(ids),
                                               jnp.asarray(raw))),
         tc.canonicalize_batch(tc.insert_batch(torch.from_numpy(ids),
                                               torch.from_numpy(raw)))),
        (jc.set_meta_cmd(3, 1, 9, D), tc.set_meta_cmd(3, 1, 9, D, device="cpu")),
        (jc.insert_cmd(4, jnp.asarray(raw[0])),
         tc.insert_cmd(4, torch.from_numpy(raw[0]))),
    ]
    for jl, tl in pairs:
        assert tc.log_to_bytes(tl) == jc.log_to_bytes(jl)
    joined = pairs[0][1].concat(pairs[1][1]).slice(3, 17)
    jjoined = pairs[0][0].concat(pairs[1][0]).slice(3, 17)
    assert tc.log_to_bytes(joined) == jc.log_to_bytes(jjoined)


def test_hashes_of_handed_over_state_match():
    jlog = _jax_log(n=30, seed=2)
    js = jm.replay(j_init(64, D), jlog)
    ts_ = to_port_state(js)
    assert_states_equal(js, ts_)
    h = jh.hash_pytree(js)
    assert th.hash_pytree(ts_) == h
    assert th.hash_state_device(ts_) == h
    assert th.content_hash(ts_) == jh.content_hash(js)
    assert th.hash_pytree(t_init(8, 4, device="cpu")) == \
        jh.hash_pytree(j_init(8, 4))
    ids = np.asarray([[3, -1], [7, 2]], np.int64)
    sc = np.asarray([[10, 1 << 62], [5, 6]], np.int64)
    assert tq.retrieval_hash(ids, sc) == jq.retrieval_hash(jnp.asarray(ids),
                                                           jnp.asarray(sc))


def test_hash_device_fold_matches_host_on_odd_sizes():
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 7, 1000, 4097):
        tree = (torch.from_numpy(rng.integers(-2**62, 2**62, size=n)),
                torch.from_numpy(rng.integers(-9, 9, size=(n, 3)).astype(np.int16)),
                torch.from_numpy(rng.random(n) < 0.5))
        assert th.hash_state_device(tree) == th.hash_pytree(tree)
        assert th.hash_pytree(tree) == jh.hash_pytree(
            tuple(np_(t) for t in tree))


def test_digest_bytes_matches():
    for data in (b"", b"a", b"valori" * 11, bytes(range(256))):
        assert th.digest_bytes(data) == jh.digest_bytes(data)
