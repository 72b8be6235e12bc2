"""Snapshot / restore with hash verification (paper §5.2, §8.1).

The port of ``repro.core.snapshot``: the same two on-disk formats, byte
for byte, so that a state written by either package restores in the other
with the same hash (the paper's "Snapshot Transfer" experiment, H_A ≡ H_B).

v1 — one opaque blob (all little-endian):
  magic 'VLRI' | version u32 | contract name (len u32 + utf8)
  | leaf count u32 | per leaf: path (len+utf8), dtype str (len+utf8),
    ndim u32, dims u64..., payload bytes
  | trailer: fnv hash u64 (hash_pytree of the state)

v2 — chunked + content-addressed: each leaf's canonical bytes are split
into fixed-size chunks keyed by their digest and stored once in a
``ChunkStore``; the snapshot itself is a small manifest:
  magic 'VLR2' | version u32 | contract name | t u64 (applied-command
  cursor, == state.version) | chunk_size u32 | leaf count u32
  | per leaf: path, dtype, ndim u32, dims u64..., nbytes u64,
    n_chunks u32, chunk keys u64...
  | trailer: fnv tree hash u64

Leaf paths are the reference's ``keystr`` strings (``.vectors``, …) in
field order and dtype names are numpy's (``int64``, ``bool``). A restored
state lands on the device the caller names (``cuda`` when None); hashes
are computed on the state's own device (``hashing.hash_state_device``,
equal to ``hash_pytree``).
"""
from __future__ import annotations

import io
import os
import pathlib
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.contracts import get_contract
from repro_torch.core.state import FIELDS, MemoryState, resolve_device

MAGIC = b"VLRI"
MAGIC_V2 = b"VLR2"
FORMAT_VERSION = 1
FORMAT_VERSION_V2 = 2
DEFAULT_CHUNK_SIZE = 8192

_U64 = (1 << 64) - 1


def _write_str(buf: io.BytesIO, s: str) -> None:
    b = s.encode()
    buf.write(struct.pack("<I", len(b)))
    buf.write(b)


def _read_str(buf: io.BytesIO) -> str:
    (n,) = struct.unpack("<I", buf.read(4))
    return buf.read(n).decode()


def _canonical_leaves(state: MemoryState):
    """(path, numpy array, little-endian payload) per leaf, in field order."""
    for path, leaf in hashing._leaves(state):
        arr = leaf.detach().cpu().numpy()
        yield path, arr, arr.astype(arr.dtype.newbyteorder("<"),
                                    copy=False).tobytes()


def _write_leaf_header(buf: io.BytesIO, path: str, arr: np.ndarray) -> None:
    _write_str(buf, path)
    _write_str(buf, str(arr.dtype))
    buf.write(struct.pack("<I", arr.ndim))
    for d in arr.shape:
        buf.write(struct.pack("<Q", d))


def _read_leaf_header(buf: io.BytesIO) -> Tuple[str, np.dtype, tuple]:
    path = _read_str(buf)
    dtype = np.dtype(_read_str(buf))
    (ndim,) = struct.unpack("<I", buf.read(4))
    shape = tuple(struct.unpack("<Q", buf.read(8))[0] for _ in range(ndim))
    return path, dtype, shape


def _leaf_array(payload: bytes, dtype: np.dtype, shape: tuple) -> np.ndarray:
    arr = np.frombuffer(payload, dtype=dtype.newbyteorder("<")).astype(dtype)
    return arr.reshape(shape)


def _state_from_leaves(leaves: Dict[str, np.ndarray], contract_name: str,
                       device: torch.device) -> MemoryState:
    return MemoryState(
        **{f: torch.from_numpy(leaves[f".{f}"]).to(device) for f in FIELDS},
        contract_name=contract_name)


def _verified(state: MemoryState, stored_hash: int) -> int:
    actual = hashing.hash_state_device(state)
    if actual != stored_hash:
        raise ValueError(
            f"snapshot hash mismatch: stored {stored_hash:#x}, got {actual:#x}")
    return actual


# --------------------------------------------------------------------------- #
# v1: single opaque blob
# --------------------------------------------------------------------------- #


def snapshot_bytes(state: MemoryState) -> bytes:
    """Serialize a state. The embedded hash covers the state tree, so any
    bit flip in any leaf is detected at restore time."""
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(struct.pack("<I", FORMAT_VERSION))
    _write_str(buf, state.contract_name)
    buf.write(struct.pack("<I", len(FIELDS)))
    for path, arr, payload in _canonical_leaves(state):
        _write_leaf_header(buf, path, arr)
        buf.write(payload)
    buf.write(struct.pack("<Q", hashing.hash_state_device(state)))
    return buf.getvalue()


def restore_bytes(data: bytes, *, device=None) -> Tuple[MemoryState, int]:
    """Restore a v1 state onto ``device``; verifies the manifest hash.
    Returns (state, hash)."""
    dev = resolve_device(device)
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError("not a Valori snapshot")
    (ver,) = struct.unpack("<I", buf.read(4))
    if ver != FORMAT_VERSION:
        raise ValueError(f"unsupported snapshot version {ver}")
    contract_name = _read_str(buf)
    get_contract(contract_name)  # validates

    (n_leaves,) = struct.unpack("<I", buf.read(4))
    leaves = {}
    for _ in range(n_leaves):
        path, dtype, shape = _read_leaf_header(buf)
        count = int(np.prod(shape)) if shape else 1
        leaves[path] = _leaf_array(buf.read(count * dtype.itemsize), dtype,
                                   shape)

    (stored_hash,) = struct.unpack("<Q", buf.read(8))
    state = _state_from_leaves(leaves, contract_name, dev)
    return state, _verified(state, stored_hash)


def save(path: str, state: MemoryState) -> int:
    data = snapshot_bytes(state)
    with open(path, "wb") as f:
        f.write(data)
    return int(struct.unpack("<Q", data[-8:])[0])


def load(path: str, *, device=None) -> Tuple[MemoryState, int]:
    with open(path, "rb") as f:
        return restore_bytes(f.read(), device=device)


# --------------------------------------------------------------------------- #
# v2: content-addressed chunk store + manifest
# --------------------------------------------------------------------------- #


def chunk_key(data: bytes) -> int:
    """Content key of a chunk: the length-salted word digest."""
    return hashing.digest_bytes(data)


class ChunkStore:
    """Content-addressed blob store: one file per chunk, named by key.

    ``put`` is idempotent (bytes already present are not rewritten, which
    makes repeated snapshots incremental) and fsyncs a new chunk before
    publishing it; ``get`` re-hashes and refuses a corrupt chunk.
    """

    def __init__(self, directory: str | os.PathLike):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # write-side stats, reset per snapshot by the callers that care
        self.puts = 0
        self.writes = 0
        self.bytes_written = 0

    def _path(self, key: int) -> pathlib.Path:
        return self.dir / f"{key:016x}.chk"

    def put(self, data: bytes) -> Tuple[int, bool]:
        key = chunk_key(data)
        self.puts += 1
        path = self._path(key)
        if path.exists():
            return key, False
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:  # fsync before publish: a manifest must
            f.write(data)           # never reference a chunk that could be
            f.flush()               # torn by the crash the manifest survives
            os.fsync(f.fileno())
        tmp.rename(path)
        self.writes += 1
        self.bytes_written += len(data)
        return key, True

    def get(self, key: int) -> bytes:
        data = self._path(key).read_bytes()
        if chunk_key(data) != key:
            raise ValueError(f"chunk {key:016x} corrupt (content hash mismatch)")
        return data

    def __contains__(self, key: int) -> bool:
        return self._path(key).exists()

    def keys(self) -> List[int]:
        return sorted(int(p.stem, 16) for p in self.dir.glob("*.chk"))

    def delete(self, key: int) -> None:
        self._path(key).unlink(missing_ok=True)

    def reset_stats(self) -> None:
        self.puts = self.writes = self.bytes_written = 0


def put_chunks(store: ChunkStore, payload: bytes, chunk_size: int
               ) -> List[int]:
    """Store ``payload`` in chunks of ``chunk_size`` bytes (one empty chunk
    for an empty payload); returns their keys in order."""
    view = memoryview(payload)
    return [store.put(bytes(view[off:off + chunk_size]))[0]
            for off in range(0, max(len(payload), 1), chunk_size)]


def snapshot_v2(state: MemoryState, store: ChunkStore, *,
                chunk_size: int = DEFAULT_CHUNK_SIZE
                ) -> Tuple[bytes, Dict[str, int]]:
    """Write the state's chunks into ``store`` and return (manifest bytes,
    stats). Chunks already present are not rewritten."""
    store.reset_stats()
    buf = io.BytesIO()
    buf.write(MAGIC_V2)
    buf.write(struct.pack("<I", FORMAT_VERSION_V2))
    _write_str(buf, state.contract_name)
    buf.write(struct.pack("<Q", int(state.version) & _U64))
    buf.write(struct.pack("<I", chunk_size))
    buf.write(struct.pack("<I", len(FIELDS)))
    total = 0
    for path, arr, payload in _canonical_leaves(state):
        total += len(payload)
        _write_leaf_header(buf, path, arr)
        keys = put_chunks(store, payload, chunk_size)
        buf.write(struct.pack("<Q", len(payload)))
        buf.write(struct.pack("<I", len(keys)))
        for key in keys:
            buf.write(struct.pack("<Q", key))
    buf.write(struct.pack("<Q", hashing.hash_state_device(state)))
    stats = {"chunks": store.puts, "chunks_written": store.writes,
             "bytes_written": store.bytes_written, "bytes_total": total,
             "manifest_bytes": buf.tell()}
    return buf.getvalue(), stats


def restore_v2(data: bytes, store: ChunkStore, *, device=None
               ) -> Tuple[MemoryState, int]:
    """Restore a v2 manifest against its chunk store onto ``device``;
    verifies every chunk's content hash and the whole-tree hash. Returns
    (state, hash)."""
    dev = resolve_device(device)
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC_V2:
        raise ValueError("not a v2 Valori snapshot manifest")
    (ver,) = struct.unpack("<I", buf.read(4))
    if ver != FORMAT_VERSION_V2:
        raise ValueError(f"unsupported snapshot version {ver}")
    contract_name = _read_str(buf)
    get_contract(contract_name)
    (t,) = struct.unpack("<Q", buf.read(8))
    buf.read(4)  # chunk_size: recorded for tooling; lengths self-describe

    (n_leaves,) = struct.unpack("<I", buf.read(4))
    leaves = {}
    for _ in range(n_leaves):
        path, dtype, shape = _read_leaf_header(buf)
        (nbytes,) = struct.unpack("<Q", buf.read(8))
        (n_chunks,) = struct.unpack("<I", buf.read(4))
        parts = [store.get(struct.unpack("<Q", buf.read(8))[0])
                 for _ in range(n_chunks)]
        payload = b"".join(parts)
        if len(payload) != nbytes:
            raise ValueError(
                f"leaf {path}: reassembled {len(payload)} bytes, "
                f"manifest says {nbytes}")
        leaves[path] = _leaf_array(payload, dtype, shape)

    (stored_hash,) = struct.unpack("<Q", buf.read(8))
    state = _state_from_leaves(leaves, contract_name, dev)
    actual = _verified(state, stored_hash)
    if (int(state.version) & _U64) != t:
        raise ValueError(
            f"manifest cursor t={t} disagrees with state.version="
            f"{int(state.version)}")
    return state, actual


def manifest_cursor(data: bytes) -> int:
    """Applied-command cursor ``t`` of a v2 manifest, without touching the
    chunk store."""
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC_V2:
        raise ValueError("not a v2 Valori snapshot manifest")
    buf.read(4)
    _read_str(buf)
    (t,) = struct.unpack("<Q", buf.read(8))
    return t


def manifest_chunk_keys(data: bytes) -> List[int]:
    """All chunk keys a v2 manifest references (for retention sweeps)."""
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC_V2:
        raise ValueError("not a v2 Valori snapshot manifest")
    buf.read(4)
    _read_str(buf)
    buf.read(12)
    (n_leaves,) = struct.unpack("<I", buf.read(4))
    keys = []
    for _ in range(n_leaves):
        _read_str(buf)
        _read_str(buf)
        (ndim,) = struct.unpack("<I", buf.read(4))
        buf.read(8 * ndim + 8)
        (n_chunks,) = struct.unpack("<I", buf.read(4))
        for _ in range(n_chunks):
            (key,) = struct.unpack("<Q", buf.read(8))
            keys.append(key)
    return keys


def restore_any(data: bytes, store: Optional[ChunkStore] = None, *,
                device=None) -> Tuple[MemoryState, int]:
    """Restore either snapshot format; v2 needs its chunk store."""
    if data[:4] == MAGIC:
        return restore_bytes(data, device=device)
    if data[:4] == MAGIC_V2:
        if store is None:
            raise ValueError("v2 snapshot needs its ChunkStore")
        return restore_v2(data, store, device=device)
    raise ValueError("not a Valori snapshot")
