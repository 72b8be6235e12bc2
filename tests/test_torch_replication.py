"""The reference replication suite's scenarios, each run on the reference
and on the port (CPU) with the same history and the same fault schedule:
the outcomes — ``catch_up``'s return (0 proven caught up, else the
residual lag), cursors, hashes, refusals, acked cursors, injected faults,
replica store bytes — must be equal. ``catch_up`` is held to the
reference's value, not to 0."""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from _torch_net import (K, Faulty, Tamper, log_bytes,  # noqa: E402
                        query_bytes, tree_bytes)
from _torch_replication import both  # noqa: E402


def primary(kit, root, batches=3, seed=0):
    """A host with a few seeded mixed-opcode batches ingested through a
    clean wire client."""
    host = kit.host(root / "primary", kit.genesis())
    writer = kit.client(kit.Local(host))
    for i in range(batches):
        writer.append(kit.log(log_bytes(seed * 1000 + i, 5)))
    return host, writer


def replica_over(kit, host, wrap, **kw):
    """A replica whose wire to ``host`` goes through ``wrap(transport)``;
    the handshake runs clean."""
    client = kit.client(kit.Local(host))
    client.transport = wrap(kit.Local(host))
    return kit.replica(client, kit.genesis(), **kw)


def outcome(rep, host):
    return (rep.t, host.store.t, rep.state_hash(), host.state_hash(),
            dict(host.replica_cursors))


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return type(e).__name__
    return None


# --------------------------------------------------------------------------- #
# convergence under lossy schedules
# --------------------------------------------------------------------------- #

def lossy(kit, root, seed):
    host, _ = primary(kit, root, batches=3, seed=seed)
    box = {}

    def wrap(inner):
        box["t"] = Faulty(inner, seed + 1, kit.p, drop_req=0.15,
                          drop_resp=0.15, duplicate=0.15, reorder=0.15,
                          corrupt=0.10)
        return box["t"]

    rep = replica_over(kit, host, wrap, replica_id=3)
    lag = rep.catch_up(max_commands=2, max_rounds=400)
    q, _ = query_bytes(seed, 4)
    return (lag, outcome(rep, host), rep.retrieval_hash(q, K),
            box["t"].faults)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lossy_transport_same_outcome(tmp_path, seed):
    lag, (t, t_host, h, h_host, _), _, faults = both(lossy, tmp_path, seed)
    assert sum(faults.values()) > 0
    assert lag > 0 or (t, h) == (t_host, h_host)


def test_port_replica_counts_and_logs_every_fault(tmp_path, caplog):
    """The faults a port replica rides through are counted on ``faults``
    and each one is logged: none is absorbed silently. A clean wire
    counts none."""
    from _torch_replication import PORT
    host, _ = primary(PORT, tmp_path / "lossy", batches=3)
    box = {}

    def wrap(inner):
        box["t"] = Faulty(inner, 5, PORT.p, drop_req=0.2, drop_resp=0.2,
                          corrupt=0.1)
        return box["t"]

    rep = replica_over(PORT, host, wrap, replica_id=4)
    with caplog.at_level("WARNING", logger="repro_torch.net.replica"):
        rep.catch_up(max_commands=2, max_rounds=400)
    logged = [r for r in caplog.records
              if r.name == "repro_torch.net.replica"]
    assert rep.faults > 0 and len(logged) == rep.faults
    assert rep.faults <= sum(box["t"].faults.values())
    clean_host, _ = primary(PORT, tmp_path / "clean", batches=3)
    clean = replica_over(PORT, clean_host, lambda inner: inner)
    assert clean.catch_up(max_commands=2) == 0 and clean.faults == 0


def test_port_replica_code_table_is_kept_per_cursor(tmp_path):
    """A port replica's coarse table is ``codes.build`` of the state it
    serves, built once per cursor: a second read at the same cursor takes
    the same table, a read after the cursor moved a new one."""
    from repro_torch.core import codes
    from _torch_replication import PORT
    host, writer = primary(PORT, tmp_path, batches=2)
    rep = PORT.replica(PORT.client(PORT.Local(host)), PORT.genesis())
    assert rep.catch_up() == 0
    state, _, _ = rep.snapshot()
    table = rep.coarse_table(state)
    want = codes.build(state)
    for field in ("codes", "offset", "scale", "norms"):
        assert torch.equal(getattr(table, field), getattr(want, field))
    assert rep.coarse_table(rep.snapshot()[0]) is table
    writer.append(PORT.log(log_bytes(77, 5)))
    assert rep.catch_up() == 0
    moved = rep.coarse_table(rep.snapshot()[0])
    assert moved is not table
    assert torch.equal(moved.codes, codes.build(rep.state).codes)


def interleaved(kit, root):
    host = kit.host(root / "primary", kit.genesis())
    writer = kit.client(kit.Local(host))
    rep = replica_over(kit, host, lambda inner: Faulty(
        inner, 42, kit.p, drop_req=0.2, drop_resp=0.2, duplicate=0.2),
        replica_id=9)
    out = []
    for i in range(4):
        writer.append(kit.log(log_bytes(7 * i + 1, 4)))
        out.append((rep.catch_up(max_commands=3, max_rounds=200),
                    outcome(rep, host)))
    return out


def test_interleaved_ingest_under_faults_same_outcome(tmp_path):
    both(interleaved, tmp_path)


def pipelined(kit, root, flaky):
    host, _ = primary(kit, root, batches=4, seed=11)
    prefetch = kit.client(kit.Local(host))
    if flaky:
        prefetch.transport = Faulty(kit.Local(host), 13, kit.p,
                                    drop_resp=0.5)
    serial = kit.replica(kit.client(kit.Local(host)), kit.genesis())
    lag_s = serial.catch_up(max_commands=3)
    piped = kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                        replica_id=1, prefetch=prefetch)
    lag_p = piped.catch_up(max_commands=3, pipeline=True, max_rounds=200)
    refused = raised(lambda: kit.replica(
        kit.client(kit.Local(host)), kit.genesis()).catch_up(pipeline=True))
    q, _ = query_bytes(11, 4)
    out = (lag_s, lag_p, outcome(serial, host), outcome(piped, host),
           serial.retrieval_hash(q, K), piped.retrieval_hash(q, K), refused)
    piped.close()
    piped.close()  # a double close is a no-op
    return out


@pytest.mark.parametrize("flaky", [False, True])
def test_pipelined_catch_up_same_outcome(tmp_path, flaky):
    out = both(pipelined, tmp_path, flaky)
    assert out[2][2] == out[3][2] and out[-1] == "ValueError"


# --------------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------------- #

def refusals(kit, root):
    host, _ = primary(kit, root)
    out = {}
    rep = replica_over(kit, host, lambda inner: Tamper(
        inner, kit.p, "TailAck", lambda m: dataclasses.replace(
            m, state_hash=m.state_hash ^ 1) if m.t_end > m.from_t else None),
        replica_id=1)
    out["tampered_hash"] = (raised(rep.sync), outcome(rep, host))

    def chop(m):
        if m.t_end == m.from_t:
            return None
        log = kit.log(m.log).slice(0, m.t_end - m.from_t - 1)
        return dataclasses.replace(m, log=kit.to_bytes(log))

    rep = replica_over(kit, host, lambda inner: Tamper(
        inner, kit.p, "TailAck", chop), replica_id=2)
    out["torn_tail"] = (raised(rep.sync), outcome(rep, host))
    rep = replica_over(kit, host, lambda inner: inner, replica_id=5)
    out["caught_up"] = rep.catch_up()
    rep._hash ^= 1  # a silently corrupted served state
    out["idle_sync"] = raised(rep.sync)
    h = host.state_hash()
    bad = host.handle(kit.p.ReplicaCursorAck(replica_id=4, t=host.store.t,
                                             state_hash=h ^ 1))
    good = host.handle(kit.p.ReplicaCursorAck(replica_id=4, t=host.store.t,
                                              state_hash=h))
    out["acks"] = (type(bad).__name__, getattr(bad, "kind", None),
                   type(good).__name__, dict(host.replica_cursors))
    return out


def test_refusals_same_outcome(tmp_path):
    out = both(refusals, tmp_path)
    assert out["tampered_hash"][0] == "ReplicaDivergence"
    assert out["torn_tail"][0] == "ProtocolError"
    assert out["idle_sync"] == "ReplicaDivergence"


# --------------------------------------------------------------------------- #
# durable replicas: a crash mid-catch-up, resumed from the replica's WAL
# --------------------------------------------------------------------------- #

def durable_resume(kit, root, seed, cut):
    host, _ = primary(kit, root, batches=3, seed=seed)
    rdir = root / "replica"
    rep = kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                      directory=rdir, replica_id=6)
    for _ in range(cut):
        rep.sync(max_commands=2)
    t_crash = rep.t
    del rep  # nothing closed or flushed
    rep2 = kit.replica(kit.client(kit.Local(host)), directory=rdir,
                       replica_id=6)
    t_reopen = rep2.t
    lag = rep2.catch_up()
    out = (t_crash, t_reopen, lag, outcome(rep2, host))
    rep2.close()
    return out, tree_bytes(rdir)


@pytest.mark.parametrize("seed,cut", [(0, 1), (5, 3), (9, 6)])
def test_crashed_durable_replica_resumes_same_outcome(tmp_path, seed, cut):
    (t_crash, t_reopen, _, _), _ = both(durable_resume, tmp_path, seed, cut)
    assert t_reopen == t_crash


# --------------------------------------------------------------------------- #
# residual lag: an outrun catch-up reports it
# --------------------------------------------------------------------------- #

def outrun(kit, root):
    host, writer = primary(kit, root, batches=1, seed=21)

    class Hot:
        def __init__(self, inner):
            self.inner, self.hot, self.rounds = inner, True, 0

        def request(self, data):
            msg, _, _ = kit.p.decode_frame(data)
            if type(msg).__name__ == "Tail" and self.hot:
                self.rounds += 1
                writer.append(kit.log(log_bytes(200 + self.rounds, 3)))
            return self.inner.request(data)

        def close(self):
            pass

    box = {}

    def wrap(inner):
        box["t"] = Hot(inner)
        return box["t"]

    rep = replica_over(kit, host, wrap, replica_id=0)
    lag = rep.catch_up(max_commands=2, max_rounds=3)
    mid = outcome(rep, host)
    box["t"].hot = False
    return lag, mid, rep.catch_up(), outcome(rep, host)


def test_residual_lag_same_outcome(tmp_path):
    lag, mid, _, _ = both(outrun, tmp_path)
    assert lag > 0 and mid[0] + lag == mid[1]


# --------------------------------------------------------------------------- #
# side-table shipping
# --------------------------------------------------------------------------- #

def side_tables(kit, root):
    host, writer = primary(kit, root, batches=2, seed=3)
    host.side_table.put(1, b"alpha tokens")
    host.side_table.put(2, b"beta tokens")
    rep = kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                      directory=root / "replica", replica_id=0)
    rep.catch_up()
    first = (rep.side_table.record_count, dict(rep.side_table.entries),
             rep.side_table.digest_at(2))
    host.side_table.put(1, b"alpha v2")
    writer.append(kit.log(log_bytes(8, 3)))
    rep.catch_up()
    promoted = rep.promote()
    served = kit.client(kit.Local(promoted)).side_tail(0)
    out = (first, dict(promoted.side_table.entries), served[1:],
           promoted.store.t, promoted.state_hash())
    promoted.close()
    host.close()
    return out


def test_side_table_mirror_same_outcome(tmp_path):
    first, entries, (count, _), _, _ = both(side_tables, tmp_path)
    assert first[0] == 2 and count == 3 and entries[1] == b"alpha v2"


# --------------------------------------------------------------------------- #
# live followers
# --------------------------------------------------------------------------- #

def _await(cond, timeout=60.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "condition never held"
        time.sleep(0.002)


def follow(kit, root):
    host, writer = primary(kit, root, batches=1, seed=31)
    rep = kit.replica(kit.client(kit.Local(host)), kit.genesis(),
                      replica_id=0)
    rep.start_following(kit.rmod.FollowerPolicy(max_lag_commands=0,
                                                max_delay_s=0.01))
    proven = []
    for i in range(3):
        writer.append(kit.log(log_bytes(40 + i, 4)))
        rep.notify_writes()
        _await(lambda: rep.t >= host.store.t)
        proven.append(rep.snapshot()[1:])
    rep.stop_following()
    running = rep.following
    writer.append(kit.log(log_bytes(99, 3)))
    lag = rep.catch_up()
    out = (proven, running, lag, outcome(rep, host), rep.follow_error)
    rep.close()
    # a follower behind a tampering wire stops and records why
    bad = replica_over(kit, host, lambda inner: Tamper(
        inner, kit.p, "TailAck", lambda m: dataclasses.replace(
            m, state_hash=m.state_hash ^ 1) if m.t_end > m.from_t else None),
        replica_id=1)
    bad.start_following(kit.rmod.FollowerPolicy(max_delay_s=0.005))
    _await(lambda: not bad.following)
    return out + (type(bad.follow_error).__name__, bad.t)


def test_follower_same_outcome(tmp_path):
    out = both(follow, tmp_path)
    assert out[1] is False and out[-2:] == ("ReplicaDivergence", 0)
