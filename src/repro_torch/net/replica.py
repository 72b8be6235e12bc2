"""Log-shipping read replica with verify-then-ack (DESIGN.md §8).

The port of ``repro.net.replica``: the same verify, commit and ack
discipline, the same ``catch_up`` return (0 only after a fault-free round
that shipped nothing new, else the residual lag), with the replica's state
on its ``device`` — the genesis state's, or ``cuda`` unless the caller
names another when a durable replica reopens without one.

A ``ReplicaStore`` follows one primary shard host by tailing its durable
command log through the wire protocol and replaying it locally — the
paper's core move (the log IS the memory) applied to read scaling. The
safety discipline is *verify, commit, ack*, in that order:

  1. TAIL ships the commands [cursor, t_end) together with the primary's
     ``hash_pytree`` at ``t_end``;
  2. the replica applies them to a **candidate** state and compares its
     own hash — a mismatch raises ``ReplicaDivergence`` and commits
     nothing (the replica's served state never silently diverges);
  3. only a verified candidate is committed (and, for a durable replica,
     appended to the replica's own WAL first), and only a committed
     cursor is acked back — so the primary's view of a replica's cursor
     is always a *proven* bit-identical state, and the primary re-checks
     the hash on ack anyway (both ends verify; neither trusts).

Deliveries may be dropped, duplicated, delayed or reordered by the
transport: TAIL is a pure read (re-asking is harmless), the local append
happens once per verified advance, and the ack is idempotent — so the
replica converges to the primary's exact state under any at-least-once
schedule, which is precisely what tests/test_replication.py's
fault-injection suite drives.

Two additions make replicas a first-class availability layer (§9):

  * **SideTable shipping** — a durable replica mirrors the primary's
    side table (doc token prefixes) record-by-record via SIDE_TAIL,
    verified against one chained prefix digest, so a *promoted* replica
    serves prefixes without refilling;
  * **promotion** — ``promote()`` turns a durable replica into a
    ``ShardHost`` without replaying its WAL: every record in that WAL was
    hash-verified against the old primary before it touched disk, so the
    takeover needs one lockstep + hash check, not a replay.

``LocalPrimary`` exposes the same replication surface over a
``DurableStore`` the caller already owns — how the serve engine attaches
in-process read replicas to its own durable stores without a server.

Replicas can also be **live followers** (DESIGN.md §12): under a
``FollowerPolicy``, ``start_following()`` runs ``catch_up`` on a daemon
thread — waking at least every ``max_delay_s`` and immediately when the
primary nudges it past ``max_lag_commands`` — so the read pool advances
between explicit barriers. The safety discipline is UNCHANGED: the
follower thread runs the same verify-then-ack path, rides transport
faults, and **stops** on ``ReplicaDivergence`` (recorded on
``follow_error``), never relaxing the hash check to go faster."""
from __future__ import annotations

import dataclasses
import logging
import os
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codes as codes_lib, hashing, machine, \
    query as query_lib
from repro_torch.core.durability import DurableStore, SideTable
from repro_torch.core.shard_wal import live_count
from repro_torch.core.state import MemoryState, resolve_device
from repro_torch.net import protocol as p

_LOG = logging.getLogger(__name__)


class ReplicaDivergence(ValueError):
    """The replica replayed the primary's own log and got a different
    state hash — replication is wrong (or the shipped log / advertised
    hash was tampered with), and serving must not continue from here."""


@dataclasses.dataclass(frozen=True)
class FollowerPolicy:
    """Bounded-staleness policy for a background follower (§12).

    ``max_lag_commands`` — the lag (in commands past the replica's proven
    cursor) the primary tolerates before nudging the follower awake
    immediately; 0 nudges on every flush. It also bounds each shipped
    TAIL slice, so one wake replays bounded work per round.
    ``max_delay_s`` — the follower wakes at least this often regardless
    of nudges, so staleness is bounded by wall clock even when nobody
    writes (the lease heartbeat of the read path)."""
    max_lag_commands: int = 0
    max_delay_s: float = 0.05


class LocalPrimary:
    """The replica-facing surface of a ``DurableStore`` the caller already
    owns: ``tail`` / ``replica_ack`` / ``side_tail`` with the exact
    semantics of a ``ShardHost`` behind a client, minus the codec. The
    serve engine uses this to attach in-process read replicas to its own
    store(s); ``state_fn`` (when given) returns the owner's live applied
    state so the common tail-to-the-live-cursor case hashes without a
    time-travel restore."""

    def __init__(self, store, *, state_fn=None,
                 side_table: Optional[SideTable] = None,
                 ef_construction: int = 32):
        self.store = store
        self._state_fn = state_fn
        self.side_table = side_table
        self.ef_construction = ef_construction
        self.replica_cursors: Dict[int, int] = {}
        # serialize tails/acks against the owner's concurrent appends: a
        # live follower thread reads the WAL while the engine extends it,
        # and the store's own mutation lock is the correct fence (falls
        # back to a private lock for store-likes without one)
        self._lock = getattr(store, "_lock", None) or threading.RLock()

    def _hash_at(self, t: int) -> int:
        if self._state_fn is not None:
            state = self._state_fn()
            if int(state.version.reshape(-1)[0]) == t:
                return hashing.hash_state_device(state)
        return self.store.restore_at(
            t, ef_construction=self.ef_construction)[1]

    def tail(self, from_t: int, *, max_commands: int = 0):
        with self._lock:
            if from_t > self.store.t:
                raise ValueError(
                    f"tail from t={from_t} is ahead of durable cursor "
                    f"{self.store.t}")
            log, t_end = self.store.wal.tail(
                from_t, max_commands=max_commands,
                device=getattr(self.store, "device", None))
            return log, t_end, self._hash_at(t_end)

    def replica_ack(self, replica_id: int, t: int, state_hash: int) -> int:
        with self._lock:
            return self._replica_ack_locked(replica_id, t, state_hash)

    def _replica_ack_locked(self, replica_id: int, t: int,
                            state_hash: int) -> int:
        if t > self.store.t:
            raise ValueError(
                f"replica acked t={t} ahead of the primary's durable "
                f"cursor {self.store.t}")
        expect = self._hash_at(t)
        if state_hash != expect:
            raise ReplicaDivergence(
                f"replica {replica_id} diverged at t={t}: replica "
                f"{state_hash:#x}, primary {expect:#x}")
        prev = self.replica_cursors.get(replica_id, 0)
        self.replica_cursors[replica_id] = max(prev, t)
        return self.replica_cursors[replica_id]

    def side_tail(self, from_index: int):
        if self.side_table is None:
            return [], 0, 0
        count = self.side_table.record_count
        return (self.side_table.records_from(from_index), count,
                self.side_table.digest_at(count))

    def close(self) -> None:
        pass  # the store and side table belong to the caller


class ReplicaStore:
    """A read replica of one primary shard host.

    ``primary`` is anything with the client replication surface —
    ``tail(from_t, max_commands=...) -> (log, t_end, hash)`` and
    ``replica_ack(replica_id, t, hash) -> t`` (a ``RemoteShardClient``
    over any transport). With a ``directory`` the replica keeps its own
    ``DurableStore`` (genesis required on first boot) and survives a kill:
    restart recovery rebuilds the state from the local WAL and catch-up
    resumes from the durable cursor. Without one, it is a pure in-memory
    follower.

    ``prefetch``, when given, is a *second* independent client to the same
    primary; ``catch_up(pipeline=True)`` uses it to request slice t+1
    while slice t is still being applied — the catch-up latency lever
    (``bench_replication.py`` prices it)."""

    def __init__(self, primary, genesis: Optional[MemoryState] = None, *,
                 directory: Optional[str | os.PathLike] = None,
                 replica_id: int = 0, ef_construction: int = 32,
                 prefetch=None, device=None):
        self.device = (genesis.device if device is None and genesis is not None
                       else resolve_device(device))
        self.primary = primary
        self.prefetch = prefetch
        self.replica_id = replica_id
        self.ef_construction = ef_construction
        self.store: Optional[DurableStore] = None
        self.side_table: Optional[SideTable] = None
        self._closed = False
        self._prefetch_thread: Optional[threading.Thread] = None
        # live-follower machinery (§12): one catch-up at a time, whether
        # driven by the background thread or an explicit sync_replicas();
        # the commit lock publishes (state, hash, t) atomically so a
        # concurrent reader never pairs a new state with an old cursor
        self._sync_lock = threading.Lock()
        self._commit_lock = threading.Lock()
        self.follow_policy: Optional[FollowerPolicy] = None
        self.follow_error: Optional[Exception] = None
        # transport faults ridden through by catch-up and the follower
        # (each one logged): an idempotent retry, never a silent one
        self.faults = 0
        self._code_cache: Optional[Tuple[int, object]] = None
        self._follow_thread: Optional[threading.Thread] = None
        self._follow_stop = threading.Event()
        self._follow_wake = threading.Event()
        if directory is not None:
            self.store = DurableStore(directory, genesis, device=self.device)
            self.state, self._hash, self.t = self.store.recover(
                ef_construction=ef_construction)
            # the mirror of the primary's side table (SIDE_TAIL target):
            # same filename the promoted host will serve it from
            self.side_table = SideTable(self.store.dir / "docs.sdt")
        else:
            if genesis is None:
                raise ValueError("an in-memory replica needs a genesis "
                                 "state (or give it a directory)")
            if int(genesis.version) != 0:
                raise ValueError("replica genesis must be at t=0")
            self.state = genesis.to(self.device)
            self._hash = hashing.hash_state_device(self.state)
            self.t = 0

    # ------------------------------------------------------------------ #
    # following the primary
    # ------------------------------------------------------------------ #

    def sync(self, *, max_commands: int = 0) -> int:
        """One catch-up step: tail from the replica's cursor, verify, then
        commit + ack. Returns the new cursor (unchanged when the primary
        has nothing new). Raises ``ReplicaDivergence`` on a hash mismatch
        — nothing is committed in that case — and lets transport faults
        (``TransportError`` / ``ProtocolError``) propagate: the step is
        idempotent, so the caller just runs it again."""
        with self._sync_lock:
            log, t_end, advertised = self.primary.tail(
                self.t, max_commands=max_commands)
            return self._commit_slice(log, t_end, advertised)

    def _commit_slice(self, log, t_end: int, advertised: int) -> int:
        """Verify-commit-ack one shipped slice (the body of ``sync``,
        shared with the pipelined catch-up path)."""
        if t_end == self.t:
            # nothing new; still re-verify our own position against the
            # primary (a free divergence tripwire on idle syncs)
            if advertised != self._hash:
                raise ReplicaDivergence(
                    f"replica at t={self.t} has hash {self._hash:#x}, "
                    f"primary advertises {advertised:#x}")
            self._ack()
            self._sync_side()
            return self.t
        if len(log) != t_end - self.t:
            raise p.ProtocolError(
                f"tail shipped {len(log)} commands for "
                f"[{self.t}, {t_end})")
        candidate = machine.bulk_apply(
            self.state, log.to(self.device),
            ef_construction=self.ef_construction)
        h = hashing.hash_state_device(candidate)
        if h != advertised:
            raise ReplicaDivergence(
                f"replaying [{self.t}, {t_end}) produced {h:#x}, primary "
                f"advertises {advertised:#x}; refusing the cursor")
        # verified: make it durable first (a crash between append and the
        # state commit is repaired by recover() — the WAL is authoritative)
        if self.store is not None:
            self.store.append(log)
        with self._commit_lock:
            self.state = candidate
            self._hash = h
            self.t = t_end
        self._ack()
        self._sync_side()
        return self.t

    def _ack(self) -> None:
        self.primary.replica_ack(self.replica_id, self.t, self._hash)

    def _sync_side(self) -> None:
        """Mirror side-table records shipped alongside the WAL slice —
        only when both ends have a table (idempotent, so a transport
        fault here just defers the mirror to the next sync)."""
        if self.side_table is not None and hasattr(self.primary,
                                                   "side_tail"):
            self.sync_side_table()

    def sync_side_table(self) -> int:
        """Pull the primary's side-table records past our mirror's count
        and verify the *whole prefix* against the primary's one chained
        digest before committing a byte — the TAIL_ACK discipline applied
        to the serving cache. Returns the mirrored record count."""
        if self.side_table is None:
            raise ValueError("an in-memory replica has no side table "
                             "(give the replica a directory)")
        start = self.side_table.record_count
        records, count, advertised = self.primary.side_tail(start)
        if count == 0 and start == 0:
            return 0  # primary ships no side table
        if count < start:
            raise ReplicaDivergence(
                f"primary's side table has {count} records, mirror already "
                f"holds {start} — the mirror is not a prefix of the source")
        if len(records) != count - start:
            raise p.ProtocolError(
                f"side tail shipped {len(records)} records for "
                f"[{start}, {count})")
        # dry-run the chained digest from our prefix before any append:
        # a mismatch must commit nothing
        digest = self.side_table.digest_at(start)
        for raw in records:
            digest = hashing.digest_bytes(struct.pack("<Q", digest) + raw)
        if digest != advertised:
            raise ReplicaDivergence(
                f"side-table prefix digest {digest:#x} != primary's "
                f"{advertised:#x}; refusing the mirrored records")
        for raw in records:
            self.side_table.append_record(raw)
        self.side_table.sync()
        return count

    def catch_up(self, *, max_commands: int = 0, max_rounds: int = 64,
                 pipeline: bool = False) -> int:
        """Run ``sync`` until the replica reaches the primary's cursor,
        riding through transport faults (lost/reordered messages) but
        never through divergence. Returns the **residual lag**: 0 means
        the replica *proved* it reached the primary's cursor (a
        fault-free round shipped nothing new); a positive value is the
        best-known number of commands still ahead of us when the round
        budget ran out — a hot primary outran this catch-up, and the
        caller can tell "caught up" from "gave up".

        With ``pipeline=True`` (requires the ``prefetch`` client), the
        next TAIL is requested on the second connection *while the current
        slice is applying* — the network/codec latency of slice t+1 hides
        behind the bulk_apply of slice t. Verification is unchanged: every
        slice is still hash-checked before commit, whichever connection
        shipped it."""
        if pipeline and self.prefetch is None:
            raise ValueError("pipelined catch-up needs a prefetch client "
                             "(a second connection to the same primary)")
        with self._sync_lock:
            return self._catch_up_locked(max_commands, max_rounds, pipeline)

    def _catch_up_locked(self, max_commands: int, max_rounds: int,
                         pipeline: bool) -> int:
        pending: Optional[Tuple[threading.Thread, dict, int]] = None
        last_t_end = self.t
        for _ in range(max_rounds):
            t_before = self.t
            try:
                if pending is not None:
                    thread, box, from_t = pending
                    thread.join()
                    pending = None
                    if "result" in box and from_t == self.t:
                        log, t_end, advertised = box["result"]
                    else:
                        if "error" in box:
                            self._fault("prefetched TAIL", box["error"])
                        # prefetch faulted or raced a cursor change:
                        # fall back to a direct (idempotent) tail
                        log, t_end, advertised = self.primary.tail(
                            self.t, max_commands=max_commands)
                else:
                    log, t_end, advertised = self.primary.tail(
                        self.t, max_commands=max_commands)
            except (p.TransportError, p.ProtocolError) as e:
                self._fault("TAIL", e)
                continue  # the step is idempotent: just ask again
            last_t_end = max(last_t_end, t_end)
            if pipeline and t_end > self.t:
                pending = self._start_prefetch(t_end, max_commands)
            try:
                self._commit_slice(log, t_end, advertised)
            except (p.TransportError, p.ProtocolError) as e:
                self._fault("commit or ack", e)
                continue
            if self.t == t_before:
                # a fault-free round shipped nothing past our cursor:
                # t_end == t proves the primary's cursor == ours
                return 0
        return self._residual_lag(last_t_end)

    def _fault(self, where: str, e: Exception) -> None:
        self.faults += 1
        _LOG.warning("replica %d at t=%d: %s failed (%s: %s); retrying",
                     self.replica_id, self.t, where, type(e).__name__, e)

    def _residual_lag(self, last_t_end: int) -> int:
        """Best-known commands still ahead of the replica when catch-up
        gives up: the primary's cursor when it is probeable, else the
        newest shipped ``t_end`` (a lower bound — a bounded TAIL never
        advertises the full cursor). Never 0: reaching the cursor exits
        through the proven fault-free path above, so a give-up is always
        reported as real lag."""
        try:
            refresh = getattr(self.primary, "refresh_t", None)
            if refresh is not None:
                return max(1, refresh() - self.t)
            store = getattr(self.primary, "store", None)
            if store is not None:
                return max(1, store.t - self.t)
        except (p.TransportError, p.ProtocolError):
            pass
        return max(1, last_t_end - self.t)

    def _start_prefetch(self, from_t: int, max_commands: int
                        ) -> Tuple[threading.Thread, dict, int]:
        box: dict = {}

        def run():
            try:
                box["result"] = self.prefetch.tail(
                    from_t, max_commands=max_commands)
            except Exception as e:  # noqa: BLE001 — surfaced via the box
                box["error"] = e

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        self._prefetch_thread = thread
        return thread, box, from_t

    # ------------------------------------------------------------------ #
    # live following: the background tailer (DESIGN.md §12)
    # ------------------------------------------------------------------ #

    @property
    def following(self) -> bool:
        """True while the background follower thread is alive."""
        thread = self._follow_thread
        return thread is not None and thread.is_alive()

    def start_following(self, policy: Optional[FollowerPolicy] = None
                        ) -> None:
        """Start the background tailer: a daemon thread loops ``catch_up``
        under ``policy``, waking at least every ``max_delay_s`` and
        immediately on ``notify_writes()``. Same verify-then-ack path as
        an explicit sync — every cursor the follower commits is proven —
        and the thread rides transport faults but STOPS on divergence
        (``follow_error`` records why; a diverged follower must not keep
        serving reads as if it were healthy). Idempotent while a follower
        is already running."""
        if self._closed:
            raise ValueError("cannot follow on a closed replica")
        if self.following:
            return
        self.follow_policy = policy or FollowerPolicy()
        self.follow_error = None
        self._follow_stop.clear()
        self._follow_wake.set()  # first round runs immediately
        self._follow_thread = threading.Thread(
            target=self._follow_loop, daemon=True,
            name=f"replica-{self.replica_id}-follower")
        self._follow_thread.start()

    def notify_writes(self) -> None:
        """Nudge the follower awake (the primary's flush hook): the next
        catch-up round starts now instead of at the ``max_delay_s`` tick.
        Safe to call from any thread; a no-op without a follower."""
        self._follow_wake.set()

    def stop_following(self, *, timeout: float = 10.0) -> None:
        """Stop the background tailer and join it (idempotent). The
        replica stays valid — explicit ``catch_up`` still works, and
        ``start_following`` may be called again."""
        self._follow_stop.set()
        self._follow_wake.set()
        thread = self._follow_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)
        self._follow_thread = None

    def _follow_loop(self) -> None:
        policy = self.follow_policy
        while not self._follow_stop.is_set():
            self._follow_wake.wait(timeout=policy.max_delay_s)
            self._follow_wake.clear()
            if self._follow_stop.is_set():
                return
            try:
                self.catch_up(max_commands=policy.max_lag_commands)
            except (p.TransportError, p.ProtocolError) as e:
                self._fault("follower round", e)
                continue  # transient: the next tick retries idempotently
            except Exception as e:  # noqa: BLE001 — recorded, never silent
                if self._follow_stop.is_set():
                    return  # teardown race: the primary is going away
                # divergence (or any non-transient refusal): stop serving
                # the illusion of a healthy follower — record and halt;
                # the hash check is never relaxed and never retried past
                # a proven mismatch
                self.follow_error = e
                return

    def checkpoint(self) -> None:
        """Snapshot the replica's own verified state (durable replicas
        only) — bounds restart catch-up to the WAL tail past the newest
        snapshot."""
        if self.store is None:
            raise ValueError("in-memory replica has nothing to checkpoint")
        self.store.checkpoint(self.state)

    # ------------------------------------------------------------------ #
    # failover: promotion
    # ------------------------------------------------------------------ #

    def promote(self, *, epoch: Optional[int] = None):
        """Turn this durable replica into the new primary (DESIGN.md §9).

        The replica's WAL is already a *verified prefix*: every slice in
        it was applied to a candidate, hash-compared against the old
        primary, and only then appended — so promotion needs one lockstep
        + hash check, not a replay. Returns a ``ShardHost`` that adopts
        the replica's store, applied state and side-table mirror; the
        replica hands its handles over and must not be synced afterwards.

        Refuses with ``ReplicaDivergence`` when the in-memory state no
        longer matches the proven hash (bit rot / tampering); a WAL/state
        cursor skew (the crash window between append and commit) is first
        reconciled through ``recover()`` — the durable log stays
        authoritative."""
        if self.store is None:
            raise ValueError("only a durable replica can be promoted "
                             "(an in-memory follower has no WAL to adopt)")
        self.stop_following()  # the old primary is gone; stop tailing it
        if self.store.t != self.t:
            # crash window: the WAL holds a verified slice the in-memory
            # state never committed — recover() lands on the durable prefix
            self.state, self._hash, self.t = self.store.recover(
                ef_construction=self.ef_construction)
        if hashing.hash_state_device(self.state) != self._hash:
            raise ReplicaDivergence(
                f"replica {self.replica_id} state no longer matches its "
                f"proven hash at t={self.t}; refusing promotion")
        from repro_torch.net.server import ShardHost  # no import cycle
        side = self.side_table
        if side is not None:
            side.close()  # the promoted host reopens the mirror file
            self.side_table = None
        return ShardHost.adopt(self.store, self.state, self._hash,
                               ef_construction=self.ef_construction,
                               epoch=epoch)

    # ------------------------------------------------------------------ #
    # serving reads
    # ------------------------------------------------------------------ #

    def state_hash(self) -> int:
        """Hash of the replica's verified applied state — equal to the
        primary's at the same cursor, by construction (that equality is
        the ack precondition)."""
        return self._hash

    def snapshot(self) -> Tuple[MemoryState, int, int]:
        """A consistent (state, state_hash, t) triple under the commit
        lock — what a reader racing a live follower must use: commits
        publish the triple atomically, so the pair a read serves from is
        always a *proven* (state, cursor), never a torn mix of two."""
        with self._commit_lock:
            return self.state, self._hash, self.t

    def coarse_table(self, state: MemoryState):
        """The int8 code table of a state this replica served (one of its
        ``snapshot()`` states), built on first use and kept until the
        cursor moves: a proven state at cursor t is the deterministic
        state at t, so ``state.version`` keys the table, as it does a
        ``ShardHost``'s."""
        v = int(state.version)
        cached = self._code_cache
        if cached is None or cached[0] != v:
            cached = (v, codes_lib.build(state))
            self._code_cache = cached
        return cached[1]

    def retrieve(self, queries_raw, k: int, *, ef: int = 64,
                 use_kernel: bool = False, route: str = "auto"
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Planned read on the replica's state: same planner, same routes,
        same bits as the primary at the same cursor — the read-scaling
        path. Returns host (ids [nq, k], scores [nq, k])."""
        state = self.state
        plan = query_lib.plan_query(live_count(state), k, ef,
                                    use_kernel=use_kernel, route=route)
        q = queries_raw if isinstance(queries_raw, torch.Tensor) \
            else torch.from_numpy(np.array(queries_raw))
        ids, scores = query_lib.execute_plan(state, q.to(state.device), k,
                                             plan)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def retrieval_hash(self, queries_raw, k: int, **kw) -> int:
        ids, scores = self.retrieve(queries_raw, k, **kw)
        return query_lib.retrieval_hash(ids, scores)

    def close(self) -> None:
        """Idempotent teardown: join any in-flight prefetch, close both
        transports and the side-table mirror. Benches and kill tests close
        replicas repeatedly — a double close is a no-op."""
        if self._closed:
            return
        self._closed = True
        self.stop_following()
        thread = self._prefetch_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        self._prefetch_thread = None
        for handle in (self.primary, self.prefetch):
            close = getattr(handle, "close", None)
            if close is not None:
                close()
        if self.side_table is not None:
            self.side_table.close()
