"""Failover in both packages on one history: a SIGKILLed primary
subprocess replaced by the replica with the max proven prefix, refused
promotions, the sharded fleet's reconcile, the failure detector's leases
and epochs, the fence, and the replica's own reads. Each outcome of the
port (CPU) must equal the reference's."""
import socket

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_net import K, log_bytes, query_bytes  # noqa: E402
from _torch_replication import both, spawn_primary  # noqa: E402
from test_torch_replication import outcome, primary, raised  # noqa: E402


def read_hash(kit, state, seed):
    q, _ = query_bytes(seed, 4)
    plan = kit.query.plan_query(kit.sw.live_count(state), K, 64)
    return kit.query.retrieval_hash(
        *kit.query.execute_plan(state, kit.q(q), K, plan))


def sigkill_failover(kit, root, seed):
    proc, mk_client = spawn_primary(kit, root / "primary")
    try:
        writer = mk_client()
        batches = [kit.log(log_bytes(seed * 1000 + i, 4)) for i in range(4)]
        reps = [kit.replica(mk_client(), kit.genesis(),
                            directory=root / f"replica_{i}", replica_id=i)
                for i in range(2)]
        writer.append_many(batches[:2])
        lags = [reps[0].catch_up()]      # replica 0 stops following here
        writer.append(batches[2])
        lags.append(reps[1].catch_up())  # replica 1 proves one batch more
        cursors = (reps[0].t, reps[1].t)
        writer.append(batches[3])        # the unshipped suffix...
        t_dead = writer.t
        proc.kill()                      # ...dies with the primary
        proc.wait(timeout=30)
        host, winner, t = kit.coord.promote_on_primary_loss(reps)
        proven = [kit.coord.proven_cursor(r) for r in reps]
        promoted = (winner, t, proven, host.store.t, host.state_hash(),
                    read_hash(kit, host.state, seed))
        # the promoted host is a full primary: it ingests and serves tails
        new_writer = kit.client(kit.Local(host))
        new_writer.append(kit.log(log_bytes(seed + 7, 3)))
        reps[0].primary = new_writer
        lags.append(reps[0].catch_up())
        out = (lags, cursors, t_dead, promoted, outcome(reps[0], host))
        host.close()
        return out
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_sigkilled_primary_promotion_same_outcome(tmp_path):
    lags, (t_lag, t_max), t_dead, (winner, t, *_), _ = both(
        sigkill_failover, tmp_path, 0)
    assert lags == [0, 0, 0] and winner == 1 and t == t_max
    assert 0 < t_lag < t_max < t_dead


def refused_promotions(kit, root):
    host, _ = primary(kit, root, batches=3, seed=5)
    good = kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                       directory=root / "good", replica_id=0)
    good.catch_up()
    forged_host, _ = primary(kit, root / "forged", batches=2, seed=6)
    forged = kit.replica(kit.client(kit.Local(forged_host)), kit.genesis(),
                         directory=root / "forged_rep", replica_id=1)
    forged.catch_up()
    out = {"forged": raised(lambda: kit.coord.promote_on_primary_loss(
        [good, forged]))}
    mem = kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                      replica_id=2)
    mem.catch_up()
    out["in_memory"] = raised(lambda: kit.coord.promote_on_primary_loss(
        [mem]))
    # a crash between the replica's WAL append and its state commit
    rep = kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                      directory=root / "window", replica_id=3)
    rep.catch_up()
    rep.state, rep.t = rep.store.restore_at(0)[0], 0
    rep._hash = rep.store.restore_at(0)[1]
    promoted = rep.promote()
    out["window"] = (promoted.store.t, promoted.state_hash(),
                     host.store.t, host.state_hash())
    promoted.close()
    return out


def test_refused_promotions_same_outcome(tmp_path):
    out = both(refused_promotions, tmp_path)
    assert out["forged"] == "ReplicaDivergence"
    assert out["in_memory"] == "ValueError"
    assert out["window"][:2] == out["window"][2:]


def sharded_failover(kit, root):
    n = 2
    genesis = kit.sharded_genesis(n)
    hosts = [kit.host(root / f"host_{s}",
                      kit.dist.shard_slice(genesis, s, n)) for s in range(n)]
    store = kit.sharded_store(root / "coord", backends=[
        kit.client(kit.Local(h)) for h in hosts])
    batches = [kit.log(log_bytes(30 + i, 5)) for i in range(3)]
    ts = [store.append(b) for b in batches]
    reps = [kit.replica(kit.client(kit.Local(hosts[s])),
                        kit.dist.shard_slice(genesis, s, n),
                        directory=root / f"replica_{s}", replica_id=s)
            for s in range(n)]
    reps[0].catch_up()
    t_stale = store.t - store.planned_advance(batches[-1])
    while reps[1].t < t_stale:
        reps[1].sync(max_commands=1)
    new_store, _, h, t, promoted = kit.coord.promote_sharded(
        root / "coord2", [[reps[0]], [reps[1]]])
    out = (ts, t_stale, h, t, [ph.store.t for ph in promoted],
           new_store.append(batches[2]), new_store.restore_at(new_store.t)[1])
    for ph in promoted:
        ph.close()
    return out


def test_promote_sharded_same_outcome(tmp_path):
    _, t_stale, _, t, promoted_ts, _, _ = both(sharded_failover, tmp_path)
    assert t == t_stale and promoted_ts == [t_stale, t_stale]


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here any more
    return port


def detector(kit, root):
    host, writer = primary(kit, root, batches=2, seed=9)
    reps = [kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                        directory=root / f"replica_{i}", replica_id=i)
            for i in range(2)]
    reps[0].catch_up()
    writer.append(kit.log(log_bytes(9001, 4)))
    reps[1].catch_up()
    live = kit.coord.FailureDetector(
        [kit.client(kit.Local(host))], [reps],
        lease=kit.coord.LeaseConfig(interval_s=0.01, lease_misses=1),
        epoch=1)
    live.poll()
    beat = [e["event"] for e in live.events]
    # a probe whose host is gone: one unanswered beat expires the lease
    dead = kit.client(kit.Local(host))
    dead.transport = kit.Socket("127.0.0.1", _dead_port(), timeout=1.0)
    det = kit.coord.FailureDetector(
        [dead], [reps],
        lease=kit.coord.LeaseConfig(interval_s=0.01, lease_misses=1),
        epoch=live.epoch)
    promoted = det.poll()
    new = promoted[0]
    out = {"beat": (beat, live.misses, live.epoch),
           "failover": ([e["event"] for e in det.events], det.misses,
                        det.epoch, det.expired(0), new.epoch,
                        kit.server.load_epoch(new.store.dir), new.store.t,
                        new.state_hash())}
    # the fence: the old host, stamped with the fleet epoch by a beat,
    # refuses its pre-failover writer
    probe = kit.client(kit.Local(host))
    probe.bump_epoch(det.epoch)
    _, host_epoch, _ = probe.heartbeat()
    t_before = host.store.t
    try:
        writer.append(kit.log(log_bytes(9002, 4)))
        fenced = None
    except kit.p.RemoteError as e:
        fenced = e.kind
    out["fence"] = (host_epoch, fenced, host.store.t == t_before,
                    kit.server.load_epoch(host.store.dir))
    host.close()
    revived = kit.host(root / "primary")
    err = revived.handle(kit.p.Append(base_t=revived.store.t, epoch=0,
                                      logs=(log_bytes(9003, 4),)))
    fresh = kit.client(kit.Local(revived))
    out["revived"] = (revived.epoch, getattr(err, "kind", None), fresh.epoch,
                      fresh.append(kit.log(log_bytes(9004, 4))))
    # a detector beating a host of a newer regime adopts its epoch
    other = kit.coord.FailureDetector([kit.client(kit.Local(revived))], [[]],
                                      epoch=1)
    other.poll()
    out["adopt"] = other.epoch
    new.close()
    revived.close()
    return out


def test_detector_epochs_and_fence_same_outcome(tmp_path):
    out = both(detector, tmp_path)
    events, misses, epoch, expired, new_epoch, stored, t, _ = \
        out["failover"]
    assert out["beat"][0] == ["beat"] and expired and misses == [1]
    assert events == ["miss", "lease_expired", "promoted"]
    assert epoch == new_epoch == stored == 2
    assert out["fence"][:3] == (2, "StaleEpochError", True)
    assert out["revived"][:3] == (2, "StaleEpochError", 2)
    assert out["adopt"] == 2
# --------------------------------------------------------------------------- #
# the replica's own reads
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("route", ["exact", "hnsw", "coarse"])
def test_replica_reads_same_answers(tmp_path, route):
    def reads(kit, root):
        host, _ = primary(kit, root, batches=4, seed=17)
        rep = kit.replica(kit.client(kit.Local(host)), kit.genesis())
        rep.catch_up()
        q, _ = query_bytes(17, 3)
        if route != "coarse":
            ids, sc = rep.retrieve(q, 3, ef=8, route=route)
        else:
            plan = kit.query.plan_query(1, 3, 8, route="coarse",
                                        ef_coarse=8, dim=q.shape[1])
            ids, sc = kit.query.execute_plan(rep.state, kit.q(q), 3, plan)
        return np.asarray(ids).tolist(), np.asarray(sc).tolist()

    both(reads, tmp_path)
