"""Fault-tolerant coordinators (the port of ``repro.runtime.coordinator``):
training checkpoint / restart, and serve-side failover by replica
promotion with lease-based failure detection (DESIGN.md §9, §12).

The serving half: when a primary
shard host dies (``TransportError`` / dead subprocess),
``promote_on_primary_loss`` picks the surviving replica with the max
proven durable cursor, proves the takeover with one ``state_hash``
comparison against the durable prefix (per surviving straggler), and
promotes that replica's WAL as the new primary prefix — no replay, because
every record in a replica's WAL was hash-verified against the old primary
before it touched disk. ``promote_sharded`` runs one promotion per shard
and then reconciles the promoted fleet to one global cursor through the
``ShardedDurableStore.recover()`` min-cursor rule (ahead shards roll
back). ``FailureDetector`` heartbeats the primaries under a
``LeaseConfig``, owns the fleet's fencing epoch and promotes on expiry.

The training half (``Coordinator``, ``RunConfig``, ``StragglerPolicy``)
wraps a train loop with the large-scale survival kit:

  * periodic deterministic checkpoints (hash-manifested, in the
    reference's layout through ``checkpoint.manager.CheckpointManager``);
  * failure detection hooks (in tests: injected via ``failure_injector``);
  * the restart path: checkpoint restore, then the step-indexed data
    pipeline resumes bit-identically;
  * straggler mitigation: a rank slower than ``deadline_factor`` x the
    median is flagged, and after ``evict_after`` consecutive flags it is
    treated as failed ("fail-slow = fail").

The loop is deliberately simple: the state machine is deterministic, so
recovery is replay.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager


# --------------------------------------------------------------------------- #
# training: checkpoint / restart and the straggler policy
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0   # step slower than 3x median = flagged
    evict_after: int = 3           # consecutive flags before eviction
    window: int = 20               # median window


@dataclasses.dataclass
class RunConfig:
    total_steps: int
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    straggler: StragglerPolicy = dataclasses.field(
        default_factory=StragglerPolicy)
    max_restarts: int = 8


class Coordinator:
    """Drives (state, batch) -> (state, metrics) steps with checkpoint /
    restart. ``batch_fn(step)`` must be a pure function of the step."""

    def __init__(
        self,
        run: RunConfig,
        train_step: Callable,
        batch_fn: Callable[[int], Any],
        init_state_fn: Callable[[], Any],
        failure_injector: Optional[Callable[[int], Optional[str]]] = None,
        on_restart: Optional[Callable[[int], None]] = None,
    ):
        self.run = run
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.init_state_fn = init_state_fn
        self.failure_injector = failure_injector
        self.on_restart = on_restart
        self.ckpt = CheckpointManager(run.checkpoint_dir,
                                      keep=run.keep_checkpoints,
                                      async_save=False)
        self.step_times: List[float] = []
        self.flag_counts: Dict[int, int] = {}
        self.restarts = 0
        self.events: List[dict] = []

    def _check_stragglers(self, rank_times: Dict[int, float]) -> List[int]:
        """Returns the ranks to evict under the fail-slow policy."""
        pol = self.run.straggler
        if len(rank_times) < 2:
            return []
        med = statistics.median(rank_times.values())
        evict = []
        for rank, t in rank_times.items():
            if t > pol.deadline_factor * max(med, 1e-9):
                self.flag_counts[rank] = self.flag_counts.get(rank, 0) + 1
                if self.flag_counts[rank] >= pol.evict_after:
                    evict.append(rank)
            else:
                self.flag_counts[rank] = 0
        return evict

    def train(self, rank_times_fn: Optional[
            Callable[[int], Dict[int, float]]] = None) -> Any:
        """Run to completion, surviving injected failures; returns the final
        state."""
        step = 0
        proto = self.init_state_fn()
        restored = self.ckpt.restore_latest(proto)
        if restored is not None:
            state, step, _ = restored
            self.events.append({"event": "resume", "step": step})
        else:
            state = proto
        del proto

        while step < self.run.total_steps:
            try:
                if state is None:
                    state = self.init_state_fn()
                fail = (self.failure_injector(step)
                        if self.failure_injector else None)
                if fail:
                    raise RuntimeError(f"injected failure: {fail}")

                t0 = time.monotonic()
                batch = self.batch_fn(step)
                state, metrics = self.train_step(state, batch)
                self.step_times.append(time.monotonic() - t0)

                if rank_times_fn is not None:
                    evict = self._check_stragglers(rank_times_fn(step))
                    if evict:
                        self.events.append(
                            {"event": "straggler_evict", "ranks": evict,
                             "step": step})
                        raise RuntimeError(f"stragglers evicted: {evict}")

                step += 1
                if step % self.run.checkpoint_every == 0 or \
                        step == self.run.total_steps:
                    self.ckpt.save(state, step)
                    self.events.append({"event": "checkpoint", "step": step})
            except Exception as e:  # noqa: BLE001 — the recovery path
                self.restarts += 1
                self.events.append({"event": "failure", "step": step,
                                    "error": str(e)})
                if self.restarts > self.run.max_restarts:
                    raise
                if self.on_restart:
                    self.on_restart(self.restarts)
                state = None  # the failed run's state is not reused
                restored = self.ckpt.restore_latest(self.init_state_fn())
                if restored is None:
                    step = 0
                else:
                    state, step, _ = restored
                self.events.append({"event": "restart", "from_step": step})
        return state


# --------------------------------------------------------------------------- #
# serve-side failover: promotion of a verified replica (DESIGN.md §9)
# --------------------------------------------------------------------------- #


def proven_cursor(replica) -> int:
    """The cursor a replica can *prove*: its own durable WAL cursor (every
    appended slice was hash-verified against the primary before it touched
    disk — the verify-then-append discipline in net/replica.py). A
    SIGKILLed replica may hold one verified slice its in-memory state never
    committed; the WAL is authoritative, so that slice still counts."""
    if replica.store is None:
        raise ValueError("an in-memory follower has no proven durable "
                         "prefix to promote")
    return replica.store.t


def promote_on_primary_loss(replicas, *, ef_construction: int = 32,
                            epoch: Optional[int] = None):
    """Failover for one shard: promote the best surviving replica.

    1. Pick the replica with the **max proven durable cursor** — acked
       work is never lost (every acked cursor <= some replica's proven
       cursor), and the old primary's unshipped suffix is never
       resurrected (nothing past the max proven cursor survives).
    2. Prove the takeover: for each surviving straggler, the winner's
       durable prefix at the straggler's committed cursor must hash to the
       straggler's proven ``state_hash()`` — one ``state_hash`` comparison
       against the durable prefix per survivor. A tampered WAL (winner or
       straggler) breaks this and the promotion is **refused** with
       ``ReplicaDivergence``: a primary that cannot prove its prefix never
       serves.
    3. ``promote()`` the winner: its store, verified state and side-table
       mirror become a ``ShardHost`` with no replay (one lockstep + hash
       check). ``epoch``, when given, stamps the promoted host with the
       new fleet epoch durably (DESIGN.md §12) — promotion IS an epoch
       change, so the dead primary's clients are fenced the moment the
       new one serves.

    Returns ``(host, winner_index, t)``.
    """
    from repro_torch.net.replica import ReplicaDivergence

    replicas = list(replicas)
    if not replicas:
        raise ValueError("no surviving replicas to promote")
    cursors = [proven_cursor(r) for r in replicas]
    winner_idx = int(np.argmax(cursors))
    winner = replicas[winner_idx]
    t = cursors[winner_idx]
    # reconcile the winner's crash window first (WAL may be one verified
    # slice ahead of the committed state) so the prefix checks below read
    # the durable truth
    if winner.store.t != winner.t:
        winner.state, winner._hash, winner.t = winner.store.recover(
            ef_construction=ef_construction)
    for i, straggler in enumerate(replicas):
        if i == winner_idx:
            continue
        st = straggler.t  # committed (acked) cursor: proven at both ends
        expect = straggler.state_hash()
        got = winner.store.restore_at(st, ef_construction=ef_construction)[1]
        if got != expect:
            raise ReplicaDivergence(
                f"promotion refused: winner (replica {winner.replica_id}) "
                f"prefix at t={st} hashes to {got:#x}, surviving replica "
                f"{straggler.replica_id} proved {expect:#x} — a WAL was "
                "tampered with or replication diverged")
    return winner.promote(epoch=epoch), winner_idx, t


def promote_sharded(directory, replica_sets, *, ef_construction: int = 32,
                    epoch: Optional[int] = None, device=None):
    """Failover for a sharded fleet: one promotion per shard, then the
    promoted hosts are reconciled to **one global cursor** through the
    existing ``ShardedDurableStore.recover()`` min-cursor rule — per-shard
    winners at staggered cursors roll the ahead shards back, exactly the
    crash-reconciliation path local shards already take.

    ``directory`` is the coordinator's own store dir (holds ``store.json``
    and the merged-hash records); ``replica_sets[s]`` is the list of
    surviving replicas of shard ``s``. Returns
    ``(store, state, state_hash, t, hosts)`` — the reconciled sharded
    store over the promoted hosts and its recovered global state, on
    ``device`` (the promoted hosts' when None)."""
    from repro_torch.core.shard_wal import ShardedDurableStore
    from repro_torch.net.client import LocalTransport, RemoteShardClient

    hosts = []
    for shard_replicas in replica_sets:
        host, _, _ = promote_on_primary_loss(
            shard_replicas, ef_construction=ef_construction, epoch=epoch)
        hosts.append(host)
    dev = device if device is not None else hosts[0].store.device
    store = ShardedDurableStore(
        directory, backends=[RemoteShardClient(LocalTransport(h), device=dev)
                             for h in hosts], device=dev)
    state, state_hash, t = store.recover(ef_construction=ef_construction)
    return store, state, state_hash, t, hosts


# --------------------------------------------------------------------------- #
# lease-based failure detection → automatic verified promotion (DESIGN.md §12)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """The lease the detector extends on every answered heartbeat.

    A primary holds its lease while it answers HEARTBEAT frames; after
    ``lease_misses`` consecutive unanswered beats (each bounded by the
    transport's timeout — a wedged host times out, it does not hang the
    detector) the lease is expired and failover triggers. ``interval_s``
    paces the optional background thread; ``poll()`` callers pace
    themselves (tests drive the detector deterministically)."""
    interval_s: float = 0.25
    lease_misses: int = 3


class FailureDetector:
    """Heartbeats primary shard hosts; expires leases; auto-promotes.

    ``probes[s]`` is a client with the replication surface's
    ``heartbeat(node_id=...)`` verb (a ``RemoteShardClient``, usually on
    its own connection so a wedged data path cannot starve the lease
    path); ``replica_sets[s]`` is the list of surviving replicas of shard
    ``s`` to promote from when shard ``s``'s lease expires.

    The detector owns the **fleet epoch**: every beat stamps the probed
    host with it (hosts adopt a greater epoch durably), and a promotion
    bumps it first — so the promoted host starts fenced against the dead
    regime's writers, and a *revived* old primary is stamped by the very
    first beat that reaches it, after which its pre-failover clients'
    APPENDs are refused with ``StaleEpochError`` (the fencing invariant:
    at most one epoch's writers can ever commit, and it is the newest
    proven one).

    One-shot per shard: an expired shard promotes once
    (``promote_on_primary_loss`` — every promotion is verified: max
    proven WAL prefix wins, stragglers must hash-match it, divergence
    refuses) and the result lands in ``promoted[s]``; a fleet-wide
    coordinator can instead pass ``sharded_dir`` to reconcile ALL shards
    through ``promote_sharded`` on the first expiry. ``poll()`` runs one
    deterministic round; ``start()`` runs it on a daemon thread every
    ``interval_s``."""

    def __init__(self, probes, replica_sets, *, lease: LeaseConfig = None,
                 epoch: int = 1, node_id: int = 0,
                 sharded_dir: Optional[str] = None,
                 ef_construction: int = 32):
        self.probes = list(probes)
        self.replica_sets = [list(rs) for rs in replica_sets]
        if len(self.probes) != len(self.replica_sets):
            raise ValueError(
                f"{len(self.probes)} probes but "
                f"{len(self.replica_sets)} replica sets")
        self.lease = lease or LeaseConfig()
        self.epoch = int(epoch)
        self.node_id = node_id
        self.sharded_dir = sharded_dir
        self.ef_construction = ef_construction
        self.misses = [0] * len(self.probes)
        self.promoted: Dict[int, Any] = {}   # shard -> promoted ShardHost
        self.sharded_result = None           # promote_sharded(...) tuple
        self.events: List[dict] = []
        self._thread = None
        self._stop = None

    def expired(self, shard: int) -> bool:
        return self.misses[shard] >= self.lease.lease_misses

    def poll(self) -> Dict[int, Any]:
        """One detection round: beat every un-promoted shard, expire
        leases, promote where expired. Returns ``promoted``."""
        from repro_torch.net import protocol as p
        for s, probe in enumerate(self.probes):
            if s in self.promoted or self.sharded_result is not None:
                continue
            try:
                # stamp the probe with the fleet epoch first: the beat is
                # what fences a revived old primary (hosts adopt durably)
                bump = getattr(probe, "bump_epoch", None)
                if bump is not None:
                    bump(self.epoch)
                t, host_epoch, h = probe.heartbeat(node_id=self.node_id)
            except (p.TransportError, p.ProtocolError) as e:
                self.misses[s] += 1
                self.events.append({"event": "miss", "shard": s,
                                    "misses": self.misses[s],
                                    "error": str(e)})
                if self.expired(s):
                    self._fail_over(s)
                continue
            self.misses[s] = 0
            # another detector may have promoted and out-epoched us: adopt
            # (the fleet epoch is a max over everything proven durable)
            self.epoch = max(self.epoch, host_epoch)
            self.events.append({"event": "beat", "shard": s, "t": t,
                                "epoch": host_epoch, "state_hash": h})
        return self.promoted

    def _fail_over(self, shard: int) -> None:
        """The lease expired: bump the fleet epoch FIRST (the promoted
        host must refuse the dead regime's writers from its first
        request), then run the existing verified promotion. A promotion
        that refuses (``ReplicaDivergence``) is recorded and re-raised —
        a survivor that cannot prove its prefix never serves."""
        self.epoch += 1
        self.events.append({"event": "lease_expired", "shard": shard,
                            "epoch": self.epoch})
        try:
            if self.sharded_dir is not None:
                self.sharded_result = promote_sharded(
                    self.sharded_dir, self.replica_sets,
                    ef_construction=self.ef_construction, epoch=self.epoch)
                for s in range(len(self.probes)):
                    self.promoted[s] = self.sharded_result[4][s]
            else:
                host, winner_idx, t = promote_on_primary_loss(
                    self.replica_sets[shard],
                    ef_construction=self.ef_construction, epoch=self.epoch)
                self.promoted[shard] = host
                self.events.append({"event": "promoted", "shard": shard,
                                    "winner": winner_idx, "t": t,
                                    "epoch": self.epoch})
        except Exception as e:
            self.events.append({"event": "promotion_refused",
                                "shard": shard, "error": str(e)})
            raise

    def start(self) -> "FailureDetector":
        """Run ``poll`` on a daemon thread every ``interval_s`` until
        ``stop()`` (or until every shard has failed over)."""
        import threading
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(timeout=self.lease.interval_s):
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001 — recorded above
                    self.events.append({"event": "detector_error",
                                        "error": str(e)})
                    return
                if (len(self.promoted) == len(self.probes)
                        or self.sharded_result is not None):
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="failure-detector")
        self._thread.start()
        return self

    def stop(self, *, timeout: float = 10.0) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=timeout)
        self._thread = None
