"""The port's shard host and client against the reference's: the same
request history gives the same response frames and the same store bytes,
and each package's client drives the other's host (in process, through
the other's transport, and over a socket to a port host subprocess)."""
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402,F401
from repro.core import distributed as jdist  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core import shard_wal as jsw  # noqa: E402
from repro.core.contracts import get_contract as jget_contract  # noqa: E402
from repro.core.state import init_state as jinit  # noqa: E402
from repro.net import client as jclient  # noqa: E402
from repro.net import protocol as jp  # noqa: E402
from repro.net import server as jserver  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core import shard_wal as tsw  # noqa: E402
from repro_torch.core.contracts import get_contract  # noqa: E402
from repro_torch.core.state import init_state as tinit  # noqa: E402
from repro_torch.net import client as tclient  # noqa: E402
from repro_torch.net import protocol as tp  # noqa: E402
from repro_torch.net import server as tserver  # noqa: E402
from _torch_net import (CAP, D, K, SRC, insert_bytes, log_bytes,  # noqa: E402
                        port_log, query_bytes, tree_bytes)
from test_torch_protocol import to_port  # noqa: E402


def host_pair(root, contract="Q16.16"):
    j = jserver.ShardHost(root / "j", jinit(CAP, D,
                                           contract=jget_contract(contract)))
    t = tserver.ShardHost(root / "t", tinit(CAP, D,
                                           contract=get_contract(contract),
                                           device="cpu"), device="cpu")
    return j, t


def ask(j, t, jmsg):
    """One request to both hosts; the response frames must be the same
    bytes. Returns the reference's response."""
    jr = j.handle(jmsg)
    tr = t.handle(to_port(jmsg))
    jb, tb = jp.encode_frame(jr, 1), tp.encode_frame(tr, 1)
    assert tb == jb, (type(jmsg).__name__, jr, tr)
    return jr


def batches(contract):
    if contract == "Q16.16":
        return [log_bytes(100 + i, 6) for i in range(4)]
    return [insert_bytes(100 + i, 6, contract, first_id=6 * i)
            for i in range(4)]


def test_same_history_same_frames_and_store_bytes(tmp_path):
    run_history(tmp_path, "Q16.16")


def run_history(tmp_path, contract):
    """Every verb, refusal and fence of the host on one history, in both
    packages: the same response frames, then the same store bytes (the
    other storage types are ``test_torch_net_contracts.py``)."""
    j, t = host_pair(tmp_path, contract)
    b = batches(contract)
    ask(j, t, jp.Hello(epoch=0))
    t1 = ask(j, t, jp.Append(base_t=0, epoch=0, logs=(b[0], b[1]))).t
    # a byte-identical redelivery re-acks; another group at the stale base
    # is refused
    assert ask(j, t, jp.Append(base_t=0, logs=(b[0], b[1]))).t == t1
    assert isinstance(ask(j, t, jp.Append(base_t=0, logs=(b[2],))),
                      jp.ErrorMsg)
    ask(j, t, jp.Cursor())
    h1 = ask(j, t, jp.StateHashReq()).state_hash
    assert t.state_hash() == h1
    _, qb = query_bytes(7, 4, contract)
    isz = jget_contract(contract).np_storage_dtype.itemsize
    for route, k, ef in (("exact", K, 16), ("hnsw", K, 16),
                         ("coarse", 3, 8)):
        ask(j, t, jp.Query(k=k, ef=ef, route=route, nq=4, dim=D,
                           itemsize=isz, data=qb))
    for bad in (dict(itemsize=3), dict(nq=5)):
        kw = {**dict(k=K, ef=16, route="exact", nq=4, dim=D,
                     itemsize=isz, data=qb), **bad}
        assert isinstance(ask(j, t, jp.Query(**kw)), jp.ErrorMsg)
    ask(j, t, jp.Tail(from_t=0, max_commands=2))
    ask(j, t, jp.Tail(from_t=2, max_commands=0))
    assert isinstance(ask(j, t, jp.Tail(from_t=t1 + 1)), jp.ErrorMsg)
    ask(j, t, jp.ReplicaCursorAck(replica_id=3, t=t1, state_hash=h1))
    for rid, ts, h in ((4, t1, h1 ^ 1), (4, t1 + 1, h1)):
        assert isinstance(ask(j, t, jp.ReplicaCursorAck(
            replica_id=rid, t=ts, state_hash=h)), jp.ErrorMsg)
    assert isinstance(ask(j, t, jp.Checkpoint(t=t1, expect_hash=h1 ^ 1)),
                      jp.ErrorMsg)
    ask(j, t, jp.Checkpoint(t=t1, expect_hash=h1))
    t2 = ask(j, t, jp.Append(base_t=t1, logs=(b[2],))).t
    ask(j, t, jp.RestoreAt(t=t1))
    ask(j, t, jp.ReadRange(t0=1, t1=t2))
    for host in (j, t):
        host.side_table.put(5, b"prefix five")
        host.side_table.put(2, b"two")
    ask(j, t, jp.SideTail(from_index=0))
    ask(j, t, jp.SideTail(from_index=1))
    assert isinstance(ask(j, t, jp.SideTail(from_index=3)), jp.ErrorMsg)
    # the fence: a beat stamps epoch 2, an epoch-1 writer is refused
    ask(j, t, jp.Heartbeat(node_id=1, epoch=2))
    err = ask(j, t, jp.Append(base_t=t2, epoch=1, logs=(b[3],)))
    assert err.kind == "StaleEpochError"
    t3 = ask(j, t, jp.Append(base_t=t2, epoch=2, logs=(b[3],))).t
    assert t3 > t2 and tserver.load_epoch(t.store.dir) == 2
    ask(j, t, jp.Rollback(t=t2))
    ask(j, t, jp.Recover())
    ask(j, t, jp.Retain(keep=1))
    ask(j, t, jp.Hello(epoch=5))
    assert t.epoch == j.epoch == 5
    j.close()
    t.close()
    assert tree_bytes(tmp_path / "t") == tree_bytes(tmp_path / "j")


def test_duplicate_group_after_lost_ack_applies_once(tmp_path):
    """A client whose APPEND ack was lost retries at its stale cursor: both
    hosts re-ack without re-applying, whichever client sends it."""
    class DropFirstAck:
        def __init__(self, inner, pmod):
            self.inner, self.p, self.dropped = inner, pmod, False

        def request(self, data):
            resp = self.inner.request(data)
            msg, _, _ = self.p.decode_frame(data)
            if type(msg).__name__ == "Append" and not self.dropped:
                self.dropped = True
                raise self.p.TransportError("injected: append ack lost")
            return resp

        def close(self):
            pass

    j, t = host_pair(tmp_path)
    blob = log_bytes(11, 6)
    # the port's client against the reference host, and the other way round
    tc = tclient.RemoteShardClient(jclient.LocalTransport(j), device="cpu")
    tc.transport = DropFirstAck(jclient.LocalTransport(j), tp)
    jc = jclient.RemoteShardClient(tclient.LocalTransport(t))
    jc.transport = DropFirstAck(tclient.LocalTransport(t), jp)
    with pytest.raises(tp.TransportError):
        tc.append(port_log(blob))
    with pytest.raises(jp.TransportError):
        jc.append(jclient.log_from_bytes(blob, jc.contract))
    assert tc.append(port_log(blob)) == jc.append(
        jclient.log_from_bytes(blob, jc.contract)) == 6
    assert j.store.t == t.store.t == 6 and j.state_hash() == t.state_hash()


def _drive(client, blobs, to_log):
    """Every client verb against one host; returns what the verbs saw."""
    out = {"hello": (client.dim, client.itemsize, client.contract.name,
                     client.t, client.epoch)}
    client.append_many([to_log(b) for b in blobs[:2]])
    out["t1"] = client.t
    out["hash1"] = client.state_hash()
    state, h = client.restore_at(client.t)
    out["restore"] = h
    out["checkpoint"] = client.checkpoint(state)
    client.append(to_log(blobs[2]))
    out["refresh"] = client.refresh_t()
    log, t_end, th = client.tail(1, max_commands=3)
    out["tail"] = (len(log), t_end, th)
    out["read_range"] = len(client.wal.read_range(0, client.t))
    out["replica_ack"] = client.replica_ack(9, out["t1"], out["hash1"][1])
    out["beat"] = client.heartbeat(node_id=3)
    out["bump"] = client.bump_epoch(4)
    out["beat4"] = client.heartbeat()
    out["side"] = client.side_tail(0)
    client.rollback_to(out["t1"])
    out["after_rollback"] = (client.t, client.state_hash())
    _, h, t = client.recover()
    out["recover"] = (h, t)
    out["retain"] = client.retain(1)
    return out


def test_each_client_drives_the_other_packages_host(tmp_path):
    """Transports carry bytes: the port's client over a reference
    ``LocalTransport`` and the reference client over the port's see the
    same answers from every verb, and leave the same store bytes."""
    j, t = host_pair(tmp_path)
    for host in (j, t):
        host.side_table.put(1, b"alpha")
    blobs = [log_bytes(200 + i, 5) for i in range(3)]
    got_t = _drive(tclient.RemoteShardClient(jclient.LocalTransport(j),
                                             device="cpu"), blobs, port_log)
    got_j = _drive(jclient.RemoteShardClient(tclient.LocalTransport(t)),
                   blobs, lambda b: jclient.log_from_bytes(
                       b, jget_contract("Q16.16")))
    assert got_t == got_j
    j.close()
    t.close()
    assert tree_bytes(tmp_path / "t") == tree_bytes(tmp_path / "j")


def test_sharded_stores_over_the_other_packages_hosts(tmp_path):
    """A reference ``ShardedDurableStore(backends=...)`` over port hosts
    and a port one over reference hosts ingest the same batches to the
    same merged hash and answer ``remote_sharded_query`` alike, each
    equal to the in-process sharded read on the same content."""
    n = 2
    jgen = jdist.init_sharded_host(n, CAP, D)
    tgen = tdist.init_sharded_host(n, CAP, D, device="cpu")
    jhosts = [jserver.ShardHost(tmp_path / f"jh{s}",
                                jdist.shard_slice(jgen, s, n))
              for s in range(n)]
    thosts = [tserver.ShardHost(tmp_path / f"th{s}",
                                tdist.shard_slice(tgen, s, n), device="cpu")
              for s in range(n)]
    # the reference coordinator drives port hosts, and the other way round
    jstore = jsw.ShardedDurableStore(tmp_path / "jc", backends=[
        jclient.RemoteShardClient(tclient.LocalTransport(h))
        for h in thosts])
    tclients = [tclient.RemoteShardClient(jclient.LocalTransport(h),
                                          device="cpu") for h in jhosts]
    tstore = tsw.ShardedDurableStore(tmp_path / "tc", backends=tclients,
                                     device="cpu")
    blobs = [log_bytes(300 + i, 8) for i in range(3)]
    for b in blobs:
        assert jstore.append(jclient.log_from_bytes(
            b, jget_contract("Q16.16"))) == tstore.append(port_log(b))
    tstate, th = tstore.restore_at(tstore.t)
    _, jh = jstore.restore_at(jstore.t)
    assert th == jh
    assert tstore.checkpoint(tstate)["t"] == tstore.t
    q, _ = query_bytes(5, 3)
    for route, k, ef in (("exact", K, 16), ("hnsw", K, 16), ("coarse", 3, 8)):
        jplan = jquery.plan_query(jsw.live_count(tstate), k, ef, route=route,
                                  ef_coarse=ef if route == "coarse" else 0,
                                  dim=D)
        tplan = tquery.plan_query(tsw.live_count(tstate), k, ef, route=route,
                                  ef_coarse=ef if route == "coarse" else 0,
                                  dim=D)
        ji, js = jclient.remote_sharded_query(jstore.shards, q, k, jplan)
        ti, ts = tclient.remote_sharded_query(tclients, torch.tensor(q),
                                              k, tplan)
        li, ls = tquery.sharded_host_query(tstate, n, torch.tensor(q),
                                           k, tplan)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        assert np.array_equal(ti.numpy(), li.numpy())
        assert np.array_equal(ts.numpy(), ls.numpy())
    _, h, t = tstore.recover()
    assert (h, t) == (th, tstore.t)
    for h in jhosts + thosts:
        h.close()


def test_port_host_subprocess_serves_both_packages_clients(tmp_path):
    """``python -m repro_torch.net.server --device cpu`` over a real
    socket: the port's and the reference's clients write to it and read
    from it, with the hashes and answers of an in-process reference
    host fed the same batches."""
    argv = [sys.executable, "-m", "repro_torch.net.server",
            "--dir", str(tmp_path / "srv"), "--capacity", str(CAP),
            "--dim", str(D), "--port", "0", "--device", "cpu"]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(SRC)))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING "), line
        port = int(line.split()[1])
        assert proc.stdout.readline().strip() == "CURSOR 0"
        tc = tclient.RemoteShardClient(
            tclient.SocketTransport("127.0.0.1", port), device="cpu")
        jc = jclient.RemoteShardClient(
            jclient.SocketTransport("127.0.0.1", port))
        ref = jserver.ShardHost(tmp_path / "ref", jinit(CAP, D))
        rc = jclient.RemoteShardClient(jclient.LocalTransport(ref))
        blobs = [log_bytes(400 + i, 6) for i in range(3)]
        tc.append(port_log(blobs[0]))
        jc.refresh_t()
        jc.append(jclient.log_from_bytes(blobs[1], jc.contract))
        tc.refresh_t()
        tc.append(port_log(blobs[2]))
        for b in blobs:
            rc.append(jclient.log_from_bytes(b, rc.contract))
        assert tc.state_hash() == jc.state_hash() == rc.state_hash()
        q, _ = query_bytes(9, 4)
        for route, k, ef in (("exact", K, 16), ("coarse", 3, 8)):
            jplan = jquery.plan_query(12, k, ef, route=route,
                                      ef_coarse=ef if route == "coarse"
                                      else 0, dim=D)
            tplan = tquery.plan_query(12, k, ef, route=route,
                                      ef_coarse=ef if route == "coarse"
                                      else 0, dim=D)
            want = rc.query(q, k, jplan)
            for got in (tc.query(torch.tensor(q), k, tplan),
                        jc.query(q, k, jplan)):
                assert all(np.array_equal(a, b) for a, b in zip(got, want))
        tc.close()
        jc.close()
        ref.close()
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_socket_retry_is_counted_and_logged(tmp_path, caplog):
    """A request whose connection died between requests is re-sent once on
    a fresh connection: the transport counts it on ``retries`` and logs
    the host and the message type. A refused fresh connection is no
    retry."""
    host = tserver.ShardHost(tmp_path / "h", tinit(CAP, D, device="cpu"),
                             device="cpu")
    srv = tserver.ShardServer(host).start()
    try:
        tr = tclient.SocketTransport("127.0.0.1", srv.port)
        c = tclient.RemoteShardClient(tr, device="cpu")
        c.heartbeat()
        assert tr.retries == 0
        tr._sock.close()  # the connection dies between requests
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.net.client"):
            assert c.heartbeat() == c.heartbeat()
        assert tr.retries == 1
        (rec,) = [r for r in caplog.records
                  if r.name == "repro_torch.net.client"]
        assert f"127.0.0.1:{srv.port}" in rec.getMessage()
        assert "Heartbeat " in rec.getMessage()
        c.close()
    finally:
        srv.close()
        host.close()
    with socket.socket() as s:  # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    lost = tclient.SocketTransport("127.0.0.1", dead, timeout=5.0)
    with pytest.raises(tp.TransportError):
        lost.request(tp.encode_frame(tp.Heartbeat(node_id=0, epoch=0), 1))
    assert lost.retries == 0
