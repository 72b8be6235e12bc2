"""Durable store: snapshots + WAL + time travel (DESIGN.md §5).

The port of ``repro.core.durability``, with the same directory layout and
file formats, so a store written by either package recovers in the other
with the same ``(t, hash)``:

  * every applied command is appended to a segmented, hash-chained
    ``WriteAheadLog`` (wal.py);
  * checkpoints are v2 content-addressed snapshots (snapshot.py) whose
    manifest carries the applied-command cursor ``t`` (== state.version);
  * ``restore_at(store, t)`` materializes the state as of command t:
    nearest snapshot ≤ t, then ``machine.bulk_apply`` of the WAL tail —
    hash-identical to ``machine.replay(genesis, log[:t])`` at every offset;
  * ``recover()`` is crash recovery: the WAL open truncates any torn tail,
    and the state is rebuilt at ``max(newest snapshot t, durable WAL
    prefix)``, falling back over broken snapshots;
  * ``retain(keep)`` ages out (snapshot, WAL-segment) pairs together and
    sweeps chunks no surviving manifest references;
  * ``append_many`` is the group-commit sink, a configured
    ``wal.CompactionPolicy`` schedules compaction on append, and
    ``rollback_to(t)`` drops durable-but-unacked suffixes.

Restored states land on the store's ``device`` (``cuda`` unless the caller
names another).

Layout of a store directory:
  store.json                    dim / contract / chunk_size / segment_records
  chunks/<key:016x>.chk         content-addressed chunk store (or one
                                shared across shards, ``chunks=``)
  snapshots/t_<t:020d>.vsn2     v2 manifests, named by cursor
  wal/seg_<base_t:020d>.wal     hash-chained command segments
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.core import hashing, machine, snapshot, wal
from repro_torch.core.commands import CommandLog
from repro_torch.core.contracts import get_contract
from repro_torch.core.state import MemoryState, resolve_device

# a torn manifest can fail in the struct layer (struct.error), on a garbage
# contract name (KeyError), or on a short/unicode-broken string read before
# any semantic hash check runs; all of it means "this snapshot is unusable,
# fall back to an older one"
_RESTORE_ERRORS = (ValueError, OSError, KeyError, struct.error)


class DurableStore:
    """One directory holding a memory's full durable history.

    Invariant: at every retained offset ``t``, ``restore_at(t)`` is
    hash-identical to ``machine.replay(genesis, log[:t])``; after any
    crash, ``recover()`` rebuilds the latest durable point and refuses
    (never approximates) lost history."""

    def __init__(self, directory: str | os.PathLike,
                 genesis: Optional[MemoryState] = None, *,
                 chunk_size: int = snapshot.DEFAULT_CHUNK_SIZE,
                 segment_records: int = 1024,
                 compaction: Optional[wal.CompactionPolicy] = None,
                 chunks: Optional[snapshot.ChunkStore] = None,
                 device=None):
        self.device = resolve_device(device)
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        meta_path = self.dir / "store.json"

        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            dim = meta["dim"]
            contract = get_contract(meta["contract"])
            chunk_size = meta["chunk_size"]
            segment_records = meta["segment_records"]
        else:
            if genesis is None:
                raise ValueError(
                    f"{self.dir} is not a DurableStore and no genesis state "
                    "was given to create one")
            dim = genesis.dim
            contract = genesis.contract
            meta = {"dim": dim, "contract": contract.name,
                    "chunk_size": chunk_size,
                    "segment_records": segment_records}
            tmp = meta_path.with_suffix(".tmp")
            with open(tmp, "w") as f:  # tmp+fsync+rename: a crash leaves a
                f.write(json.dumps(meta))  # stale .tmp, never a torn
                f.flush()                  # store.json that bricks reopen
                os.fsync(f.fileno())
            tmp.rename(meta_path)

        self.chunk_size = chunk_size
        # serializes WAL mutations (append / retain / compact) so a
        # background checkpoint+retention thread can never unlink or rewrite
        # a segment a foreground append is extending
        self._lock = threading.RLock()
        # a shared ChunkStore (sharded stores dedup chunks across shards)
        # is swept by its owner, never by this store's retain()
        self._owns_chunks = chunks is None
        self.chunks = chunks if chunks is not None \
            else snapshot.ChunkStore(self.dir / "chunks")
        self.compaction = compaction
        self._genesis_cache: Optional[MemoryState] = None
        self.wal = wal.WriteAheadLog(self.dir / "wal", dim, contract,
                                     segment_records=segment_records)
        self._snap_dir = self.dir / "snapshots"
        self._snap_dir.mkdir(exist_ok=True)

        if genesis is not None and not self.snapshots():
            if int(genesis.version) != 0:
                raise ValueError("genesis state must be at t=0 "
                                 f"(got version {int(genesis.version)})")
            self._write_snapshot(genesis)  # makes restore_at total over t

    # ------------------------------------------------------------------ #
    # snapshots
    # ------------------------------------------------------------------ #

    def _snap_path(self, t: int) -> pathlib.Path:
        return self._snap_dir / f"t_{t:020d}.vsn2"

    def snapshots(self) -> List[int]:
        """Cursors of all retained snapshots, ascending."""
        return sorted(int(p.stem.split("_")[1])
                      for p in self._snap_dir.glob("t_*.vsn2"))

    def _write_snapshot(self, state: MemoryState) -> Dict[str, int]:
        manifest, stats = snapshot.snapshot_v2(state, self.chunks,
                                               chunk_size=self.chunk_size)
        t = int(state.version)
        tmp = self._snap_path(t).with_suffix(".tmp")
        with open(tmp, "wb") as f:  # chunks are fsynced by put(); sync the
            f.write(manifest)       # manifest too before publishing it
            f.flush()
            os.fsync(f.fileno())
        tmp.rename(self._snap_path(t))
        return stats

    def checkpoint(self, state: MemoryState) -> Dict[str, int]:
        """Snapshot ``state`` (on any device) at its cursor. The cursor must
        not run ahead of the durable log — a snapshot of commands the WAL
        never saw could not be audited back to genesis."""
        t = int(state.version)
        with self._lock:
            wal_t = self.wal.t
        if t > wal_t:
            raise ValueError(
                f"state cursor t={t} ahead of durable WAL t={wal_t}; "
                "append the commands before checkpointing")
        # the write itself runs outside the lock so appends keep flowing;
        # checkpoint and retain are serialized by their callers (one
        # background worker at a time)
        stats = self._write_snapshot(state)
        stats["t"] = t
        return stats

    # ------------------------------------------------------------------ #
    # the command stream
    # ------------------------------------------------------------------ #

    def append(self, log: CommandLog) -> int:
        """Durably append commands (one fsync per touched segment); returns
        the new WAL cursor. Runs scheduled compaction when a
        ``CompactionPolicy`` was configured and is due."""
        with self._lock:
            t = self.wal.append(log)
            self._maybe_compact()
            return t

    def append_many(self, logs) -> int:
        """Group commit: durably append several logs under one fsync per
        touched segment; returns the new WAL cursor. This is the sink
        ``wal.GroupCommitWriter`` drives."""
        with self._lock:
            t = self.wal.append_many(logs)
            self._maybe_compact()
            return t

    def _maybe_compact(self) -> None:
        if self.compaction is None:
            return

        def genesis():
            # lazily restored (costs only when a check runs); an unavailable
            # t=0 snapshot legitimately skips the check, but ONLY that — a
            # failure inside compaction itself must propagate
            try:
                return self._genesis()
            except _RESTORE_ERRORS:
                return None

        self.wal.maybe_compact(genesis, self.compaction)

    def _genesis(self) -> MemoryState:
        """The t=0 state (cached; immutable once restored)."""
        if self._genesis_cache is None:
            state, _ = self.restore_at(0)
            self._genesis_cache = state
        return self._genesis_cache

    @property
    def t(self) -> int:
        """Durable logical time: commands safely on disk."""
        return self.wal.t

    # ------------------------------------------------------------------ #
    # time travel + recovery
    # ------------------------------------------------------------------ #

    def restore_at(self, t: int, *, ef_construction: int = 32
                   ) -> Tuple[MemoryState, int]:
        """The state as of command ``t`` on the store's device — hash-
        identical to replaying ``log[:t]`` from genesis. Returns (state,
        hash). Snapshots that fail verification are skipped: the next-older
        snapshot plus a longer WAL tail rebuilds the same bits."""
        with self._lock:
            snaps = [s for s in self.snapshots() if s <= t]
            if not snaps:
                raise ValueError(
                    f"no snapshot at or below t={t} (oldest retained: "
                    f"{self.snapshots()[:1]}); retention dropped that history")
            last_err: Optional[Exception] = None
            for base_t in reversed(snaps):
                try:
                    state, _ = snapshot.restore_v2(
                        self._snap_path(base_t).read_bytes(), self.chunks,
                        device=self.device)
                except _RESTORE_ERRORS as e:
                    last_err = e  # broken snapshot: fall back one older
                    continue
                if t > base_t:
                    tail = self.wal.read_range(base_t, t, device=self.device)
                    state = machine.bulk_apply(
                        state, tail, ef_construction=ef_construction)
                return state, hashing.hash_state_device(state)
            raise ValueError(
                f"every snapshot at or below t={t} failed to restore"
            ) from last_err

    def recover(self, *, ef_construction: int = 32
                ) -> Tuple[MemoryState, int, int]:
        """Crash recovery: the state at the last durable prefix — the newer
        of the newest restorable snapshot and the durable WAL prefix. When
        the recovered cursor is ahead of the WAL, the WAL cursor is advanced
        past the lost region (an explicit, refusable gap), so new appends
        and checkpoints stay consistent. Returns (state, hash, t)."""
        with self._lock:
            candidates = sorted({self.wal.t, *self.snapshots()}, reverse=True)
            last_err: Optional[Exception] = None
            for t in candidates:
                try:
                    state, h = self.restore_at(
                        t, ef_construction=ef_construction)
                except _RESTORE_ERRORS as e:
                    last_err = e
                    continue
                if t > self.wal.t:
                    self.wal.reset_to(t)
                return state, h, t
            raise ValueError("no recoverable state in the store") from last_err

    def rollback_to(self, t: int) -> None:
        """Drop every durable artifact above logical time ``t``: newer
        snapshots are deleted and the WAL is truncated to ``t``. Refuses a
        ``t`` inside a lost gap — that history cannot be re-entered."""
        with self._lock:
            self.wal.truncate_to(t)  # raises before any snapshot is lost
            for s in self.snapshots():
                if s > t:
                    self._snap_path(s).unlink()

    # ------------------------------------------------------------------ #
    # retention + compaction
    # ------------------------------------------------------------------ #

    def referenced_chunk_keys(self) -> set:
        """Chunk keys referenced by any retained snapshot manifest — the
        live set a chunk-store sweep must preserve."""
        with self._lock:
            referenced = set()
            for t in self.snapshots():
                referenced.update(snapshot.manifest_chunk_keys(
                    self._snap_path(t).read_bytes()))
            return referenced

    def retain(self, keep: int) -> Dict[str, int]:
        """Keep the newest ``keep`` snapshots; drop older manifests, WAL
        segments wholly below the oldest retained snapshot, and chunks no
        surviving manifest references. When the chunk store is shared
        (sharded stores), the chunk sweep is the owner's job — other
        shards' manifests may reference keys this store no longer does."""
        if keep < 1:
            raise ValueError("must retain at least one snapshot")
        with self._lock:
            snaps = self.snapshots()
            dropped = snaps[:-keep] if len(snaps) > keep else []
            for t in dropped:
                self._snap_path(t).unlink()
            kept = self.snapshots()
            segs_dropped = self.wal.drop_below(kept[0]) if kept else 0

            chunks_dropped = 0
            if self._owns_chunks:
                referenced = self.referenced_chunk_keys()
                for key in self.chunks.keys():
                    if key not in referenced:
                        self.chunks.delete(key)
                        chunks_dropped += 1
            return {"snapshots_dropped": len(dropped),
                    "wal_segments_dropped": segs_dropped,
                    "chunks_dropped": chunks_dropped,
                    # lets a coordinator prune merged records without
                    # listing the shards' snapshot directories
                    "oldest_snapshot": kept[0] if kept else 0}

    def compact_wal(self, genesis: MemoryState) -> Dict[str, int]:
        """Fold dead commands in the WAL (wal.compact_log contract)."""
        with self._lock:
            return self.wal.compact(genesis)


def restore_at(store: DurableStore, t: int, *, ef_construction: int = 32
               ) -> Tuple[MemoryState, int]:
    """Module-level alias: the state as of command ``t`` (see
    ``DurableStore.restore_at``)."""
    return store.restore_at(t, ef_construction=ef_construction)


# --------------------------------------------------------------------------- #
# durable side tables: serving caches that survive a crash (DESIGN.md §7)
# --------------------------------------------------------------------------- #

_SIDE_MAGIC = b"VSDT"
_SIDE_FORMAT = 1


class SideTable:
    """Append-only durable ``key -> bytes`` table for serving-layer caches.
    Deliberately NOT part of the replayable state: nothing here is hashed
    into the memory and recovery never depends on it.

    Format (the reference's): a small fsynced header, then self-validating
    records ``u64 key | u32 len | payload | u64 digest(key|len|payload)``
    (``hashing.digest_bytes``). Later records for a key win. On open the
    file is truncated to its longest valid record prefix. ``put`` buffers
    through the OS; ``sync()`` makes the table durable.

    The table is also shippable (DESIGN.md §9): records are kept in append
    order with a chained prefix digest (``digest_at``), so a replica mirrors
    the table record by record (``records_from`` on the primary,
    ``append_record`` on the replica) and verifies the whole prefix against
    one advertised digest."""

    def __init__(self, path: str | os.PathLike):
        self.path = pathlib.Path(path)
        self.entries: Dict[int, bytes] = {}
        self._records: list = []   # raw record bytes, append order
        self._chain: list = [0]    # _chain[i] = chained digest of records[:i]
        self._closed = False
        self._dirty = False
        # put/sync race when a timer-flush thread drives sync while the
        # foreground thread is still putting: an unsynchronized dirty flag
        # could be cleared for a record that was never fsynced
        self._mu = threading.RLock()
        if self.path.exists():
            self._load_and_truncate()
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(self.path.suffix + ".tmp")
            with open(tmp, "wb") as f:  # tmp+fsync+rename: never a torn header
                f.write(_SIDE_MAGIC + struct.pack("<I", _SIDE_FORMAT))
                f.flush()
                os.fsync(f.fileno())
            tmp.rename(self.path)
        self._f = open(self.path, "ab")

    def _load_and_truncate(self) -> None:
        data = self.path.read_bytes()
        if data[:4] != _SIDE_MAGIC:
            raise ValueError(f"{self.path.name}: not a side table")
        (fmt,) = struct.unpack_from("<I", data, 4)
        if fmt != _SIDE_FORMAT:
            raise ValueError(f"{self.path.name}: unsupported format {fmt}")
        off = 8
        valid = off
        while off + 12 <= len(data):
            key, n = struct.unpack_from("<QI", data, off)
            end = off + 12 + n + 8
            if end > len(data):
                break  # torn tail: short record
            (stored,) = struct.unpack_from("<Q", data, off + 12 + n)
            if stored != hashing.digest_bytes(data[off:off + 12 + n]):
                break  # torn/corrupt record: keep the valid prefix
            self.entries[key] = data[off + 12:off + 12 + n]
            self._records.append(data[off:end])
            self._chain.append(hashing.digest_bytes(
                struct.pack("<Q", self._chain[-1]) + data[off:end]))
            off = valid = end
        if valid < len(data):
            with open(self.path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())

    def put(self, key: int, payload: bytes) -> None:
        """Record (buffered — durable after the next ``sync()``)."""
        body = struct.pack("<QI", key, len(payload)) + payload
        raw = body + struct.pack("<Q", hashing.digest_bytes(body))
        with self._mu:
            self._f.write(raw)
            self.entries[key] = payload
            self._records.append(raw)
            self._chain.append(hashing.digest_bytes(
                struct.pack("<Q", self._chain[-1]) + raw))
            self._dirty = True

    @property
    def record_count(self) -> int:
        with self._mu:
            return len(self._records)

    def digest_at(self, count: int) -> int:
        """Chained digest over the first ``count`` records — the verify
        target a mirroring replica must reproduce (0 records -> 0)."""
        with self._mu:
            if not 0 <= count < len(self._chain):
                raise ValueError(
                    f"digest_at({count}): table has {len(self._records)} "
                    "records")
            return self._chain[count]

    def records_from(self, index: int):
        """Raw self-validating record bytes [index, record_count) — what
        SIDE_TAIL ships."""
        with self._mu:
            if not 0 <= index <= len(self._records):
                raise ValueError(
                    f"records_from({index}): table has {len(self._records)} "
                    "records")
            return list(self._records[index:])

    def append_record(self, raw: bytes) -> None:
        """Mirror one shipped record: re-verify its embedded digest, then
        append it byte-identically (buffered; durable after ``sync()``).
        A mirrored table is therefore a byte prefix of its source."""
        if len(raw) < 20:
            raise ValueError("side-table record truncated")
        key, n = struct.unpack_from("<QI", raw, 0)
        if len(raw) != 12 + n + 8:
            raise ValueError("side-table record length mismatch")
        (stored,) = struct.unpack_from("<Q", raw, 12 + n)
        if stored != hashing.digest_bytes(raw[:12 + n]):
            raise ValueError("side-table record digest mismatch")
        with self._mu:
            self._f.write(raw)
            self.entries[key] = raw[12:12 + n]
            self._records.append(raw)
            self._chain.append(hashing.digest_bytes(
                struct.pack("<Q", self._chain[-1]) + raw))
            self._dirty = True

    def sync(self) -> None:
        """Make every ``put`` so far durable (no-op when clean)."""
        with self._mu:
            if not self._dirty:
                return
            self._f.flush()
            os.fsync(self._f.fileno())
            self._dirty = False

    def close(self) -> None:
        """Idempotent: flush once, then become a no-op."""
        with self._mu:
            if self._closed:
                return
            self.sync()
            self._f.close()
            self._closed = True
