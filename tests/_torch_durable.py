"""Shared pieces of the port's durability tests: one random six-opcode log
as both packages' CommandLog, the reference's hash trace of its prefixes,
the byte framing of a segment, and a byte-level comparison of two
directories."""
import pathlib
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import commands as jc  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import machine as jm  # noqa: E402

from repro_torch.core import boundary as tb  # noqa: E402

from _torch_parity import to_port_log  # noqa: E402

D = 8


def random_logs(seed, n, id_space, weights=(1, 3, 1, 1, 1, 1), dim=D):
    """(reference log, port log) of one random log: all six opcodes,
    duplicate ids, invalid targets, zero-argument NOPs (so NOP runs)."""
    rng = np.random.default_rng(seed)
    ops = rng.choice(6, size=n, p=np.asarray(weights) / sum(weights))
    a0 = rng.integers(0, id_space, size=n)
    a1 = rng.integers(0, id_space, size=n)
    a2 = rng.integers(-50, 50, size=n)
    a1 = np.where(ops == jc.SET_META, rng.integers(-1, 4, size=n), a1)
    a1 = np.where(np.isin(ops, [jc.LINK, jc.UNLINK, jc.SET_META]), a1, 0)
    a2 = np.where(ops == jc.SET_META, a2, 0)
    # the port's boundary: the reference's bits (test_torch_boundary.py)
    # without a compile per log length
    vec = tb.normalize_embedding(torch.from_numpy(
        rng.normal(size=(n, dim)).astype(np.float32))).numpy()
    vec = np.where((ops == jc.INSERT)[:, None], vec, 0).astype(np.int32)
    jlog = jc.CommandLog(
        opcode=jnp.asarray(ops.astype(np.int32)),
        arg0=jnp.asarray(np.where(ops == jc.NOP, 0, a0).astype(np.int64)),
        arg1=jnp.asarray(a1.astype(np.int64)),
        arg2=jnp.asarray(a2.astype(np.int64)), vec=jnp.asarray(vec))
    return jlog, to_port_log(jlog)


def nop_logs(n, dim=D):
    """(reference, port) logs of n zero-argument NOPs."""
    jlog = jm._pad_log(jc.empty_log(dim), n)
    return jlog, to_port_log(jlog)


def hash_trace(genesis, jlog):
    """hashes[t] == hash of the reference's replay(genesis, log[:t])."""
    step = jax.jit(jm.apply_command)
    hashes = [jh.hash_pytree(genesis)]
    s = genesis
    for i in range(len(jlog)):
        s = step(s, jlog.record(i))
        hashes.append(jh.hash_pytree(s))
    return hashes


def record_boundaries(seg_path):
    """(header size, [(byte offset after record, cumulative commands)]) of
    a clean segment, derived from the bytes alone."""
    data = pathlib.Path(seg_path).read_bytes()
    (n,) = struct.unpack_from("<I", data, 24)
    header = 24 + 4 + n + 8
    _, dim, itemsize = struct.unpack_from("<III", data, 4)
    off, total, out = header, 0, []
    while off < len(data):
        op, a0 = struct.unpack_from("<Iq", data, off)
        off += 28 + (dim * itemsize if op == jc.INSERT else 0) + 8
        total += a0 if op == 0xFFFFFFFE else 1
        out.append((off, total))
    return header, out


def tree_bytes(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_files(a, b):
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert sorted(ta) == sorted(tb), (sorted(ta), sorted(tb))
    for name in ta:
        assert ta[name] == tb[name], f"{name} differs"
