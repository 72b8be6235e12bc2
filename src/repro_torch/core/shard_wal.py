"""Per-shard WALs under one global clock (DESIGN.md §6), and the host-side
sharded apply and search twins.

The port of ``repro.core.shard_wal``, with the same directory layout and
file bytes, so a sharded store written by either package recovers in the
other with the same ``(t, hash)``. Each shard owns a full
``durability.DurableStore``; a ``ShardedDurableStore`` keeps the fleet in
lockstep on one global applied-command cursor ``t``:

  * every appended batch is routed with ``distributed.route_commands`` and
    NOP-padded to one common length, so every shard's WAL advances by the
    same amount per batch;
  * a group commit (``append_many``, the sink ``wal.GroupCommitWriter``
    drives) flushes each shard's share of the group under one fsync per
    shard, in shard order;
  * recovery reconciles: each shard recovers its own durable prefix, the
    global cursor is the minimum, and shards that got ahead (a crash
    between per-shard flushes) roll their never-acked suffix back;
  * the merged restore verifies one number: the hash of the merged
    sharded-layout state, recorded at every checkpoint.

Shards share one content-addressed ``ChunkStore``; the sharded store owns
the cross-shard sweep.

Layout of a store directory:
  store.json                 n_shards
  chunks/<key:016x>.chk      chunk store shared by all shards
  merged/t_<t:020d>.json     global-cursor records: {"t", "hash"}
  shard_<s:04d>/             a full DurableStore per shard (own WAL,
                             snapshots, store.json; chunks redirected up)

Restored states land on the store's ``device`` (``cuda`` unless the
caller names another).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import distributed, hashing, hnsw, machine, search
from repro_torch.core import snapshot, wal
from repro_torch.core.commands import CommandLog
from repro_torch.core.durability import _RESTORE_ERRORS, DurableStore
from repro_torch.core.state import MemoryState, resolve_device


def _write_json(path: pathlib.Path, record: dict) -> None:
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:  # tmp+fsync+rename: a crash leaves a stale
        f.write(json.dumps(record))  # .tmp, never a torn record
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(path)


class ShardedDurableStore:
    """n_shards lockstep ``DurableStore``s under one global cursor.

    Invariant (healthy store): every shard's durable cursor equals the
    global ``t``, and ``restore_at(t)`` merged across shards is hash-
    identical to applying the same routed batches to a fresh sharded
    genesis."""

    def __init__(self, directory: str | os.PathLike,
                 genesis: Optional[MemoryState] = None, *,
                 n_shards: Optional[int] = None,
                 chunk_size: int = snapshot.DEFAULT_CHUNK_SIZE,
                 segment_records: int = 1024,
                 compaction: Optional[wal.CompactionPolicy] = None,
                 backends: Optional[Sequence] = None,
                 device=None):
        """``backends`` makes the store transport-pluggable: instead of
        creating local per-shard ``DurableStore``s, it drives the given
        shard handles — anything with the ``DurableStore`` surface
        (``append_many`` / ``checkpoint`` / ``restore_at`` / ``recover`` /
        ``rollback_to`` / ``retain`` / ``t`` / ``wal.read_range``). The
        directory then holds only the coordinator's own records
        (store.json, merged hashes); each backend owns and sweeps its
        chunks."""
        self.device = resolve_device(device)
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        meta_path = self.dir / "store.json"

        if backends is not None:
            if n_shards is not None and n_shards != len(backends):
                raise ValueError(
                    f"{len(backends)} backends given, n_shards={n_shards}")
            n_shards = len(backends)
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            if n_shards is not None and n_shards != meta["n_shards"]:
                raise ValueError(
                    f"store has {meta['n_shards']} shards, {n_shards} given")
            n_shards = meta["n_shards"]
        else:
            if n_shards is None or (genesis is None and backends is None):
                raise ValueError(
                    f"{self.dir} is not a ShardedDurableStore and no "
                    "(genesis, n_shards) was given to create one")
            _write_json(meta_path, {"n_shards": n_shards})

        self.n_shards = n_shards
        self._merged_dir = self.dir / "merged"
        self._merged_dir.mkdir(exist_ok=True)
        if backends is not None:
            self.chunks = None  # each backend owns (and sweeps) its chunks
            self.shards = list(backends)
        else:
            self.chunks = snapshot.ChunkStore(self.dir / "chunks")
            self.shards: List[DurableStore] = [
                DurableStore(
                    self.dir / f"shard_{s:04d}",
                    distributed.shard_slice(genesis, s, n_shards)
                    if genesis is not None else None,
                    chunk_size=chunk_size, segment_records=segment_records,
                    compaction=compaction, chunks=self.chunks,
                    device=self.device)
                for s in range(n_shards)
            ]

    # ------------------------------------------------------------------ #
    # the global command stream
    # ------------------------------------------------------------------ #

    @property
    def t(self) -> int:
        """Globally durable logical time: the minimum shard cursor (a
        command counts only once every shard's share of its batch is on
        disk)."""
        return min(s.t for s in self.shards)

    def shard_ts(self) -> List[int]:
        """Per-shard durable cursors (all equal when healthy)."""
        return [s.t for s in self.shards]

    def planned_advance(self, log: CommandLog) -> int:
        """Global-cursor advance appending ``log`` will cause: its heaviest
        shard's share (min 1), what ``GroupCommitWriter.target_t`` adds per
        batch instead of the raw command count."""
        if len(log) == 0:
            return 0
        owners = distributed.shard_of_id(log.arg0, self.n_shards)
        counts = np.bincount(owners, minlength=self.n_shards)
        return max(int(counts.max()), 1)

    def append(self, log: CommandLog, *,
               routed: Optional[CommandLog] = None) -> int:
        """Route one global batch to the shards and durably append each
        share (one fsync per shard); returns the new global cursor. A
        caller that already routed the batch passes ``routed``."""
        if routed is not None and len(log):
            return self.append_many_routed([routed])
        return self.append_many([log])

    def append_many(self, logs: Sequence[CommandLog]) -> int:
        """Group commit across shards: each batch is routed exactly as
        ``append`` routes it (per-batch NOP padding, so cursors are the
        same grouped or not), then each shard commits its share of the
        group under one fsync, in shard order."""
        logs = [log for log in logs if len(log)]
        if not logs:
            return self.t
        return self.append_many_routed(
            [distributed.route_commands(log, self.n_shards) for log in logs])

    def append_many_routed(self, routed_logs: Sequence[CommandLog]) -> int:
        """``append_many`` minus the re-route: batches arrive as the
        ``[n_shards, L]`` shares ``distributed.route_commands`` emits. The
        caller routes with this store's shard count and filters empty
        batches (routing pads an empty batch to one NOP)."""
        routed_logs = list(routed_logs)
        if not routed_logs:
            return self.t
        for r in routed_logs:
            if r.opcode.shape[0] != self.n_shards:
                raise ValueError(
                    f"routed batch has {r.opcode.shape[0]} shares, store "
                    f"has {self.n_shards} shards")
        # refuse BEFORE anything is fsynced: appending to an unreconciled
        # post-crash store would durably put different batches at the same
        # logical offset on different shards — run recover() first
        if len(set(self.shard_ts())) != 1:
            raise RuntimeError(
                f"shard cursors diverged ({self.shard_ts()}): the store "
                "needs recover() before it can accept new appends")
        ts = [self.shards[s].append_many(
                  [distributed.share(r, s) for r in routed_logs])
              for s in range(self.n_shards)]
        assert len(set(ts)) == 1, f"lockstep violated: {ts}"
        return ts[0]

    # ------------------------------------------------------------------ #
    # checkpoints + the merged-hash contract
    # ------------------------------------------------------------------ #

    def _merged_path(self, t: int) -> pathlib.Path:
        return self._merged_dir / f"t_{t:020d}.json"

    def merged_records(self) -> List[int]:
        """Cursors with a recorded merged whole-state hash, ascending."""
        return sorted(int(p.stem.split("_")[1])
                      for p in self._merged_dir.glob("t_*.json"))

    def checkpoint(self, state: MemoryState) -> Dict[str, int]:
        """Snapshot a sharded-layout state (on any device): one v2 snapshot
        per shard into the shared chunk store, plus a merged record
        carrying the whole-state hash. The per-shard cursors must agree."""
        versions = {int(v) for v in state.version.cpu().reshape(-1)}
        if len(versions) != 1:
            raise ValueError(
                f"per-shard cursors disagree ({sorted(versions)}): "
                "checkpoint only at global batch boundaries")
        t = versions.pop()
        stats: Dict[str, int] = {"t": t, "bytes_written": 0}
        for s in range(self.n_shards):
            sh = self.shards[s].checkpoint(
                distributed.shard_slice(state, s, self.n_shards))
            stats["bytes_written"] += sh.get("bytes_written", 0)
        _write_json(self._merged_path(t), {
            "t": t, "hash": f"{hashing.hash_state_device(state):#018x}"})
        return stats

    def _verify_merged(self, t: int, h: int) -> None:
        path = self._merged_path(t)
        if not path.exists():
            return
        stored = int(json.loads(path.read_text())["hash"], 16)
        if stored != h:
            raise ValueError(
                f"merged-state hash mismatch at t={t}: manifest "
                f"{stored:#x}, restored {h:#x}")

    # ------------------------------------------------------------------ #
    # restore + recovery
    # ------------------------------------------------------------------ #

    def restore_at(self, t: int, *, ef_construction: int = 32
                   ) -> Tuple[MemoryState, int]:
        """The merged sharded-layout state as of global command ``t``, on
        the store's device: each shard restores its cursor-``t`` state, the
        merge is verified against the merged record at ``t`` when there is
        one. Returns (state, hash)."""
        parts = [s.restore_at(t, ef_construction=ef_construction)[0]
                 for s in self.shards]
        state = distributed.merge_shards([p.to(self.device) for p in parts])
        h = hashing.hash_state_device(state)
        self._verify_merged(t, h)
        return state, h

    def recover(self, *, ef_construction: int = 32
                ) -> Tuple[MemoryState, int, int]:
        """Crash recovery with cross-shard reconciliation: each shard
        recovers its own durable prefix, the global cursor is the minimum,
        and shards that got ahead roll back their unacked suffix. Drives
        only the backend surface (``recover`` / ``t`` / ``rollback_to``).
        Returns (merged state, hash, t)."""
        ts = []
        for s, shard in enumerate(self.shards):
            try:
                ts.append(shard.recover(ef_construction=ef_construction)[2])
            except _RESTORE_ERRORS as e:
                raise ValueError(
                    f"shard {s} has no recoverable state") from e
        t = min(ts)
        for s, shard in enumerate(self.shards):
            if shard.t > t:
                try:
                    shard.rollback_to(t)
                except ValueError as e:
                    raise ValueError(
                        f"shard {s} cannot rejoin the global cursor t={t} "
                        f"(its durable history has a hole there); the "
                        f"store is irreconcilable without that history"
                    ) from e
        state, h = self.restore_at(t, ef_construction=ef_construction)
        return state, h, t

    def rollback_to(self, t: int) -> None:
        """Drop every durable artifact above global time ``t`` on every
        shard, then prune merged records above ``t``. A failure partway
        leaves cursors diverged as a crash between flushes would, and
        ``recover()`` reconciles it the same way."""
        if t > self.t:
            raise ValueError(f"rollback_to({t}) is ahead of the globally "
                             f"durable cursor {self.t}")
        for shard in self.shards:
            if shard.t > t:
                shard.rollback_to(t)
        for rec_t in self.merged_records():
            if rec_t > t:
                self._merged_path(rec_t).unlink()

    def shard_logs(self, t0: int, t1: int) -> List[CommandLog]:
        """Each shard's durable commands [t0, t1) on the store's device —
        the per-shard audit logs (routed, NOP-padded to lockstep). Raises
        ValueError when retention dropped that history on any shard."""
        return [s.wal.read_range(t0, t1, device=self.device)
                for s in self.shards]

    # ------------------------------------------------------------------ #
    # retention
    # ------------------------------------------------------------------ #

    def retain(self, keep: int) -> Dict[str, int]:
        """Keep the newest ``keep`` snapshots per shard, then sweep shared
        chunks no surviving manifest of any shard references. Merged
        records below the new window go with the snapshots they
        described."""
        stats = {"snapshots_dropped": 0, "wal_segments_dropped": 0,
                 "chunks_dropped": 0}
        oldest_parts = []
        for shard in self.shards:
            sh = shard.retain(keep)
            stats["snapshots_dropped"] += sh["snapshots_dropped"]
            stats["wal_segments_dropped"] += sh["wal_segments_dropped"]
            oldest_parts.append(sh["oldest_snapshot"])
            if self.chunks is None:
                # backends own their chunks and already swept them
                stats["chunks_dropped"] += sh.get("chunks_dropped", 0)
        if self.chunks is not None:
            referenced = set()
            for shard in self.shards:
                referenced |= shard.referenced_chunk_keys()
            for key in self.chunks.keys():
                if key not in referenced:
                    self.chunks.delete(key)
                    stats["chunks_dropped"] += 1
        oldest = min(oldest_parts, default=0)
        for t in self.merged_records():
            if t < oldest:
                self._merged_path(t).unlink()
        return stats


# --------------------------------------------------------------------------- #
# host-side sharded apply + search: distributed.py's device-list paths with
# every shard on the state's own device
# --------------------------------------------------------------------------- #


def live_count(state: MemoryState) -> int:
    """Total live rows of a MemoryState in either layout (flat scalar
    ``count`` or sharded ``[n_shards]`` counts)."""
    return int(obs.host_item(state.count.sum()))


def bulk_apply_sharded(state: MemoryState, log: CommandLog, n_shards: int,
                       *, ef_construction: int = 32,
                       routed: Optional[CommandLog] = None,
                       device: Optional[bool] = None) -> MemoryState:
    """Route a global batch and apply each shard's share to its slice of a
    sharded-layout state — the in-memory reference for what a
    ``ShardedDurableStore`` ingest makes durable. ``routed`` skips the
    re-route.

    ``device`` picks how the shares are applied, as in the reference:
    ``True`` runs every shard's share as one stacked replay
    (``apply_routed_device``:
    on the card one insert launch per run for all shards), ``False`` the
    per-shard ``machine.bulk_apply`` (whose segmentation planner wins on
    long shares), ``None`` (default) the first for shares of at most
    ``_DEVICE_APPLY_MAX`` commands, the second beyond. All three are
    bit-identical."""
    if routed is None:
        routed = distributed.route_commands(log, n_shards)
    if device is None:
        device = int(routed.opcode.shape[1]) <= _DEVICE_APPLY_MAX
    if device:
        return apply_routed_device(state, routed, n_shards,
                                   ef_construction=ef_construction)
    return distributed.distributed_bulk_apply(
        [state.device] * n_shards, state, routed,
        ef_construction=ef_construction)


# --------------------------------------------------------------------------- #
# the stacked routed apply (DESIGN.md §11): no per-shard host loop
# --------------------------------------------------------------------------- #

# auto-route threshold: shares at or under this many commands take the
# stacked replay; longer shares amortize bulk_apply's segmentation planner
_DEVICE_APPLY_MAX = 128


def shard_stack(state: MemoryState, n_shards: int) -> MemoryState:
    """Sharded layout → stacked layout: every array gains a leading
    [n_shards] axis whose lanes are exactly ``distributed.shard_slice``'s
    per-shard states (reshapes and a ``movedim``, no copies of row data).
    The result is what the qhnsw kernels take, not a valid flat
    MemoryState; ``shard_unstack`` is the inverse."""
    cap = state.capacity // n_shards

    def rows(a):  # [n_shards*cap, ...] → [n_shards, cap, ...]
        return a.reshape((n_shards, cap) + tuple(a.shape[1:]))

    nb = state.hnsw_neighbors  # [levels, n_shards*cap, degree]
    nb = nb.reshape(nb.shape[0], n_shards, cap, nb.shape[2]).movedim(1, 0)
    return dataclasses.replace(
        state,
        vectors=rows(state.vectors), ids=rows(state.ids),
        valid=rows(state.valid), links=rows(state.links),
        meta=rows(state.meta), hnsw_neighbors=nb,
        hnsw_levels=rows(state.hnsw_levels),
        # hnsw_entry / cursor / count / version are already [n_shards]
    )


def shard_unstack(stacked: MemoryState, n_shards: int) -> MemoryState:
    """Inverse of ``shard_stack``: back to the shard-major sharded layout."""
    def rows(a):  # [n_shards, cap, ...] → [n_shards*cap, ...]
        return a.reshape((-1,) + tuple(a.shape[2:]))

    nb = stacked.hnsw_neighbors.movedim(0, 1)  # [levels, ns, cap, degree]
    nb = nb.reshape(nb.shape[0], -1, nb.shape[3])
    return dataclasses.replace(
        stacked,
        vectors=rows(stacked.vectors), ids=rows(stacked.ids),
        valid=rows(stacked.valid), links=rows(stacked.links),
        meta=rows(stacked.meta), hnsw_neighbors=nb,
        hnsw_levels=rows(stacked.hnsw_levels),
    )


def _pad_routed(routed: CommandLog, target: int) -> CommandLog:
    """NOP-pad every shard's share from its routed length to ``target``
    (pow2 buckets, like ``machine._pad_log``). All-zero records are
    NOPs."""
    n = int(routed.opcode.shape[1])
    if n == target:
        return routed

    def z(a):
        pad = torch.zeros((a.shape[0], target - n) + tuple(a.shape[2:]),
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], dim=1)

    return CommandLog(opcode=z(routed.opcode), arg0=z(routed.arg0),
                      arg1=z(routed.arg1), arg2=z(routed.arg2),
                      vec=z(routed.vec))


def _apply_routed_stacked(stacked: MemoryState, routed: CommandLog,
                          n_real: int, *, ef_construction: int
                          ) -> MemoryState:
    """Every shard replays its (padded) share of ``routed`` with F, the
    shards in lockstep: on the card their working states are lanes of one
    ``DeviceGraph`` and each round of queued inserts is one launch of the
    insert kernel for all of them (``machine._run``). ``n_real`` is the
    routed share length — the pow2 NOP padding must not advance logical
    time, so ``version`` is pinned to base + n_real afterwards (the routing
    NOPs *inside* the share do advance it, as on every other path)."""
    wss = machine.working_lanes(stacked)
    base = stacked.version.cpu().tolist()
    machine._run(wss, [machine._scan(ws, distributed.share(routed, s),
                                     ef_construction, bump=True)
                       for s, ws in enumerate(wss)])
    for ws, v in zip(wss, base):
        ws.version = v + n_real
    return machine.stacked_state(wss, stacked)


def apply_routed_device(state: MemoryState, routed: CommandLog,
                        n_shards: int, *, ef_construction: int = 32
                        ) -> MemoryState:
    """Apply an already-routed batch to a sharded-layout state as one
    stacked replay: one reshape in, every shard's share replayed in
    lockstep with one insert launch per run for all shards, one reshape
    out — no per-shard loop of applies. Bit-identical to the per-shard
    ``bulk_apply`` path (both equal per-shard ``replay``); on the CPU it
    runs the plain version."""
    n_real = int(routed.opcode.shape[1])
    padded = _pad_routed(routed, machine._pow2(n_real))
    out = _apply_routed_stacked(shard_stack(state, n_shards), padded, n_real,
                                ef_construction=ef_construction)
    return shard_unstack(out, n_shards)


def relink_sharded(state: MemoryState, n_shards: int, *,
                   ef_construction: int = 32) -> MemoryState:
    """Re-link every shard's graph from its own live rows: each shard lands
    on exactly the graph ``hnsw.fresh_build`` of its slice lands on (on the
    card, one insert launch for all shards). The arena is untouched; only
    the graph arrays and entries move."""
    return shard_unstack(hnsw.rebuild(shard_stack(state, n_shards),
                                      ef_construction, True), n_shards)


def exact_search_sharded(state: MemoryState, n_shards: int,
                         queries_raw: torch.Tensor, k: int, *,
                         metric: str = search.METRIC_L2,
                         use_kernel: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over a sharded-layout state: per-shard top-k (qgemm +
    qtopk on the card, once per shard), then the one (score, id) merge —
    equal to a single kernel holding the same rows. Returns
    (ids [nq, k], scores [nq, k])."""
    return distributed.distributed_search(
        [state.device] * n_shards, state, queries_raw, k, metric=metric,
        use_kernel=use_kernel)


def coarse_search_sharded(state: MemoryState, n_shards: int,
                          queries_raw: torch.Tensor, k: int, *,
                          ef_coarse: int, metric: str = search.METRIC_L2,
                          use_kernel: bool = False,
                          tables: Optional[Sequence] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compressed tier over a sharded-layout state
    (``distributed.distributed_coarse_search`` on the state's device):
    equal to ``exact_search_sharded`` whenever every shard's candidates
    cover its slice."""
    return distributed.distributed_coarse_search(
        [state.device] * n_shards, state, queries_raw, k,
        ef_coarse=ef_coarse, metric=metric, use_kernel=use_kernel,
        tables=tables)


def hnsw_search_sharded(state: MemoryState, n_shards: int,
                        queries_raw: torch.Tensor, k: int, *, ef: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN over a sharded-layout state: each shard's deterministic beam
    search over its own graph, combined with the one merge; equal to a flat
    graph's answer whenever every beam is exhaustive over its slice.
    Returns (ids [nq, k], dists [nq, k])."""
    return distributed.distributed_hnsw_search(
        [state.device] * n_shards, state, queries_raw, k, ef=ef)
