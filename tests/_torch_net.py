"""Shared pieces of the port's network and replication tests: seeded
command logs as wire bytes, fault-injecting and tampering transports that
raise either package's exceptions, and byte-level directory listings."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import boundary as jboundary  # noqa: E402
from repro.core import commands as jcommands  # noqa: E402
from repro.core.contracts import get_contract as jget_contract  # noqa: E402
from repro_torch.core import commands as tcommands  # noqa: E402
from repro_torch.core.contracts import get_contract  # noqa: E402
from test_bulk_apply import _random_log  # noqa: E402

D = 8
CAP = 32
ID_SPACE = 12
K = 5
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def log_bytes(seed: int, n: int) -> bytes:
    """A seeded mixed six-opcode log (the reference suite's) as wire bytes."""
    return jcommands.log_to_bytes(_random_log(seed, n, ID_SPACE))


def insert_bytes(seed: int, n: int, contract: str, first_id: int = 0):
    """n INSERTs of seeded embeddings through the reference boundary."""
    c = jget_contract(contract)
    rng = np.random.default_rng(seed)
    raw = jboundary.normalize_embedding(
        jnp.asarray(rng.normal(size=(n, D)).astype(np.float32)), c)
    ids = jnp.arange(first_id, first_id + n, dtype=jnp.int64)
    return jcommands.log_to_bytes(jcommands.insert_batch(ids, raw, c))


def query_bytes(seed: int, nq: int, contract: str = "Q16.16"):
    """(raw query array, its little-endian bytes) through the reference
    boundary."""
    rng = np.random.default_rng(seed)
    q = np.asarray(jboundary.admit_query(
        jnp.asarray(rng.normal(size=(nq, D)).astype(np.float32)),
        jget_contract(contract)))
    return q, q.astype(q.dtype.newbyteorder("<")).tobytes()


def port_log(blob: bytes, contract: str = "Q16.16"):
    return tcommands.log_from_bytes(blob, get_contract(contract),
                                    device="cpu")


def jax_log(blob: bytes, contract: str = "Q16.16"):
    return jcommands.log_from_bytes(blob, jget_contract(contract))


def tree_bytes(root) -> dict:
    """Every file under ``root`` as {relative path: bytes}."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


class Faulty:
    """The reference suite's at-least-once adversary (seeded drops,
    duplicates, delayed and reordered responses, bit flips) over a
    transport, raising the given package's ``TransportError``: the same
    seed injects the same faults into the same request sequence."""

    def __init__(self, inner, seed, pmod, *, drop_req=0.0, drop_resp=0.0,
                 duplicate=0.0, reorder=0.0, corrupt=0.0):
        self.inner, self.p = inner, pmod
        self.rng = np.random.default_rng(seed)
        self.rates = dict(drop_req=drop_req, drop_resp=drop_resp,
                          duplicate=duplicate, reorder=reorder,
                          corrupt=corrupt)
        self.stash = []
        self.faults = {k: 0 for k in self.rates}

    def _hit(self, kind):
        if self.rng.random() < self.rates[kind]:
            self.faults[kind] += 1
            return True
        return False

    def request(self, data: bytes) -> bytes:
        if self._hit("drop_req"):
            raise self.p.TransportError("injected: request dropped")
        if self._hit("duplicate"):
            self.inner.request(data)
        resp = self.inner.request(data)
        if self._hit("drop_resp"):
            raise self.p.TransportError("injected: response dropped")
        if self._hit("reorder"):
            self.stash.append(resp)
            if len(self.stash) > 1:
                return self.stash.pop(0)
            raise self.p.TransportError("injected: response delayed")
        if self._hit("corrupt"):
            out = bytearray(resp)
            bit = int(self.rng.integers(0, len(out) * 8))
            out[bit // 8] ^= 1 << (bit % 8)
            return bytes(out)
        return resp

    def close(self) -> None:
        self.inner.close()


class Tamper:
    """Rewrites one kind of response frame in flight (re-signed, so only
    the content checks can catch it)."""

    def __init__(self, inner, pmod, cls_name, rewrite):
        self.inner, self.p = inner, pmod
        self.cls_name, self.rewrite = cls_name, rewrite

    def request(self, data: bytes) -> bytes:
        resp = self.inner.request(data)
        msg, rid, _ = self.p.decode_frame(resp)
        if type(msg).__name__ == self.cls_name:
            new = self.rewrite(msg)
            if new is not None:
                return self.p.encode_frame(new, rid)
        return resp

    def close(self) -> None:
        self.inner.close()
