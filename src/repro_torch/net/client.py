"""Remote shard client: the ``DurableStore`` interface over the wire.

The port of ``repro.net.client``. Frames are the reference's, so a client
of either package drives a host of the other; what a client restores or
reads lands on its ``device`` (``cuda`` unless the caller names another).

``RemoteShardClient`` speaks the protocol to one ``ShardHost`` and exposes
exactly the surface ``shard_wal.ShardedDurableStore`` drives on a local
shard — ``append_many`` / ``checkpoint`` / ``restore_at`` / ``recover`` /
``rollback_to`` / ``retain`` / ``t`` / ``wal.read_range`` — so the
coordinator cannot tell (and must not care) whether a shard is a directory
or a process. Error mapping preserves that symmetry: a server-side refusal
arrives as ``RemoteError`` (a ``ValueError``) and a lost message as
``TransportError`` (an ``OSError``), both inside the coordinator's
existing ``_RESTORE_ERRORS`` recovery envelope.

Transports are one method, ``request(bytes) -> bytes``:

  * ``SocketTransport`` — TCP, one in-flight request per client, one
    reconnect attempt on a dead connection (the request may have executed;
    the protocol's idempotent APPEND makes the retry safe); each retry is
    counted on ``retries`` and logged as a warning, never absorbed
    silently;
  * ``LocalTransport`` — an in-process ``ShardHost`` behind the *full*
    codec round trip, so tests exercise every encode/decode branch without
    sockets (and fault-injection proxies can wrap it).

Request ids are a per-client monotone counter; the client refuses a
response whose id differs from its request's (a reordered or foreign
frame is a ``ProtocolError``, not an answer).
"""
from __future__ import annotations

import logging
import socket
import struct
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.core import hashing, search, snapshot
from repro_torch.core.commands import CommandLog, log_from_bytes, log_to_bytes
from repro_torch.core.contracts import get_contract
from repro_torch.core.state import resolve_device
from repro_torch.net import protocol as p
from repro_torch.net.server import ShardHost, read_frame

_LOG = logging.getLogger(__name__)


def _frame_kind(data: bytes) -> str:
    """The message class named by a frame's header (for logs)."""
    if len(data) < p.HEADER_BYTES:
        return "short frame"
    (msg_type,) = struct.unpack_from("<I", data, 8)
    cls = p.MESSAGE_TYPES.get(msg_type)
    return cls.__name__ if cls is not None else f"type {msg_type}"


class SocketTransport:
    """One TCP connection to a ``ShardServer``; lazily connected, one
    reconnect attempt when the connection died between requests.

    ``timeout`` bounds EVERY socket operation — connect, send and each
    recv — and a deadline miss surfaces as ``TransportError``: a wedged
    (accepting but not answering) host looks exactly like a dead one to
    callers, instead of hanging the follower thread or ``sync_replicas``
    forever. The failure detector's lease math relies on this bound.

    ``retries`` counts the requests re-sent on a fresh connection; each
    one is logged with the host and the request's message type."""

    def __init__(self, address: str, port: int, *, timeout: float = 30.0):
        self.address = address
        self.port = port
        self.timeout = timeout
        self.retries = 0
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    (self.address, self.port), timeout=self.timeout)
                # persistent per-operation deadline (explicit, even though
                # create_connection leaves its timeout on the socket): every
                # send/recv after this point is bounded by ``timeout``
                self._sock.settimeout(self.timeout)
            except OSError as e:
                raise p.TransportError(
                    f"cannot reach shard host {self.address}:{self.port}: "
                    f"{e}") from e
        return self._sock

    def request(self, data: bytes) -> bytes:
        fresh = self._sock is None
        sock = self._connect()
        try:
            sock.sendall(data)
            resp = read_frame(sock)
        except p.TransportError as e:
            self.close()
            if fresh:  # the reconnect already happened; give up
                raise
            # stale connection (server restarted): retry once on a fresh
            # one — idempotent requests make the possible re-execution safe
            return self._retry(data, e)
        except OSError as e:
            # sendall deadline miss / reset: same lost-message semantics as
            # a torn read — map it into the retriable TransportError family
            self.close()
            if fresh:
                raise p.TransportError(
                    f"send to shard host {self.address}:{self.port} "
                    f"failed: {e}") from e
            return self._retry(data, e)
        if resp is None:
            self.close()
            raise p.TransportError(
                f"shard host {self.address}:{self.port} closed the "
                "connection without a response")
        return resp

    def _retry(self, data: bytes, cause: Exception) -> bytes:
        self.retries += 1
        _LOG.warning("shard host %s:%d: %s re-sent on a fresh connection "
                     "after %s: %s", self.address, self.port,
                     _frame_kind(data), type(cause).__name__, cause)
        return self.request(data)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class LocalTransport:
    """An in-process ``ShardHost`` reached through the full wire codec:
    requests are encoded, decoded, handled, and the response re-encoded —
    byte-for-byte what a socket would carry, minus the socket."""

    def __init__(self, host: ShardHost):
        self.host = host

    def request(self, data: bytes) -> bytes:
        msg, rid, end = p.decode_frame(data)
        if end != len(data):
            raise p.ProtocolError(
                f"trailing bytes after request frame ({len(data) - end})")
        return p.encode_frame(self.host.handle(msg), rid)

    def close(self) -> None:
        pass


class _RemoteWal:
    """The slice of ``WriteAheadLog`` the coordinator reads through a
    shard handle (audit log export, tail shipping) — served remotely."""

    def __init__(self, client: "RemoteShardClient"):
        self._client = client

    def read_range(self, t0: int, t1: int, *, device=None) -> CommandLog:
        ack = self._client._request(p.ReadRange(t0=t0, t1=t1), p.LogAck)
        return log_from_bytes(ack.log, self._client.contract,
                              device=device or self._client.device)

    def tail(self, t0: int, max_commands: int = 0, *, device=None
             ) -> Tuple[CommandLog, int]:
        log, t_end, _ = self._client.tail(t0, max_commands=max_commands,
                                          device=device)
        return log, t_end

    @property
    def t(self) -> int:
        return self._client.refresh_t()


class RemoteShardClient:
    """One remote shard, drop-in for a local ``DurableStore`` in
    ``ShardedDurableStore(backends=[...])``. The cached cursor mirrors the
    server's durable cursor and is the APPEND precondition (``base_t``);
    a response lost in transit leaves it stale-low, which the server's
    duplicate detection turns into a safe re-ack on retry."""

    def __init__(self, transport, *, contract=None, epoch: int = 0,
                 device=None):
        self.transport = transport
        self.device = resolve_device(device)
        self._rid = 0
        ack = self._request(p.Hello(epoch=epoch), p.HelloAck)
        self.dim = ack.dim
        self.itemsize = ack.itemsize
        self.contract = get_contract(ack.contract)
        if contract is not None and contract.name != self.contract.name:
            raise ValueError(
                f"shard host speaks contract {self.contract.name!r}, "
                f"coordinator expects {contract.name!r}")
        self._t = ack.t
        # fencing epoch (DESIGN.md §12): carried on every APPEND; the
        # handshake leaves both ends at the max epoch either had seen
        self.epoch = max(epoch, ack.epoch)
        self.wal = _RemoteWal(self)

    # ------------------------------------------------------------------ #

    def _request(self, msg: p.Message, expect_cls: Type[p.Message]
                 ) -> p.Message:
        self._rid += 1
        rid = self._rid
        data = self.transport.request(p.encode_frame(msg, rid))
        resp, resp_rid, end = p.decode_frame(data)
        if end != len(data):
            raise p.ProtocolError(
                f"trailing bytes after response frame ({len(data) - end})")
        if resp_rid != rid and not isinstance(resp, p.ErrorMsg):
            raise p.ProtocolError(
                f"response for request {resp_rid}, expected {rid} "
                "(reordered or foreign frame)")
        return p.expect(resp, expect_cls)

    # ------------------------------------------------------------------ #
    # the DurableStore surface
    # ------------------------------------------------------------------ #

    @property
    def t(self) -> int:
        """The shard's durable cursor as last confirmed over the wire."""
        return self._t

    def refresh_t(self) -> int:
        ack = self._request(p.Cursor(), p.CursorAck)
        self._t = ack.t
        return self._t

    def append(self, log: CommandLog) -> int:
        return self.append_many([log])

    def append_many(self, logs: Sequence[CommandLog]) -> int:
        logs = [log for log in logs if len(log)]
        if not logs:
            return self._t
        ack = self._request(
            p.Append(base_t=self._t, epoch=self.epoch,
                     logs=tuple(log_to_bytes(log) for log in logs)),
            p.AppendAck)
        self._t = ack.t
        return ack.t

    def bump_epoch(self, epoch: int) -> int:
        """Raise this writer's fencing epoch (monotone; a lower value is a
        no-op). The failover coordinator calls this after a promotion so
        the surviving write path speaks the new regime's epoch."""
        self.epoch = max(self.epoch, int(epoch))
        return self.epoch

    def heartbeat(self, *, node_id: int = 0) -> Tuple[int, int, int]:
        """One lease beat (DESIGN.md §12): proves the host alive within the
        transport timeout and stamps it with ``self.epoch`` (the host
        adopts a greater epoch durably). Returns the host's
        (durable cursor, durable epoch, applied state hash)."""
        ack = self._request(
            p.Heartbeat(node_id=node_id, epoch=self.epoch), p.HeartbeatAck)
        self.epoch = max(self.epoch, ack.epoch)
        return ack.t, ack.epoch, ack.state_hash

    def checkpoint(self, state) -> Dict[str, int]:
        """Checkpoint by hash, not by shipping state: the server snapshots
        its *own* applied state after proving it bit-matches the
        coordinator's slice — determinism makes the 64-bit check
        sufficient, and the state never crosses the wire."""
        t = int(state.version.reshape(-1)[0])
        ack = self._request(
            p.Checkpoint(t=t, expect_hash=hashing.hash_state_device(state)),
            p.CheckpointAck)
        return {"t": ack.t, "bytes_written": ack.bytes_written}

    def restore_at(self, t: int, *, ef_construction: int = 32):
        ack = self._request(p.RestoreAt(t=t), p.StateAck)
        state, h = snapshot.restore_bytes(ack.blob, device=self.device)
        if h != ack.state_hash:
            raise p.ProtocolError(
                f"restored state hash {h:#x} != advertised "
                f"{ack.state_hash:#x} at t={t}")
        return state, h

    def recover(self, *, ef_construction: int = 32):
        ack = self._request(p.Recover(), p.StateAck)
        state, h = snapshot.restore_bytes(ack.blob, device=self.device)
        if h != ack.state_hash:
            raise p.ProtocolError(
                f"recovered state hash {h:#x} != advertised "
                f"{ack.state_hash:#x}")
        self._t = ack.t
        return state, h, ack.t

    def rollback_to(self, t: int) -> None:
        ack = self._request(p.Rollback(t=t), p.RollbackAck)
        self._t = ack.t

    def retain(self, keep: int) -> Dict[str, int]:
        ack = self._request(p.Retain(keep=keep), p.RetainAck)
        return {"snapshots_dropped": ack.snapshots_dropped,
                "wal_segments_dropped": ack.wal_segments_dropped,
                "chunks_dropped": ack.chunks_dropped,
                "oldest_snapshot": ack.oldest_snapshot}

    # ------------------------------------------------------------------ #
    # reads + replication
    # ------------------------------------------------------------------ #

    def query(self, queries_raw, k: int, plan) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """Run the coordinator's planned route on the shard's applied
        state; returns host (ids [nq, k], scores [nq, k]) int64 arrays."""
        q = (queries_raw.detach().cpu().numpy()
             if isinstance(queries_raw, torch.Tensor)
             else np.asarray(queries_raw))
        nq, dim = q.shape
        data = q.astype(q.dtype.newbyteorder("<")).tobytes()
        # the coarse route rides the ef field (the route string
        # disambiguates), keeping the frozen Query frame format intact
        ef = plan.ef_coarse if plan.route == "coarse" else plan.ef
        ack = self._request(
            p.Query(k=k, ef=ef, route=plan.route,
                    use_kernel=plan.use_kernel, nq=nq, dim=dim,
                    itemsize=q.dtype.itemsize, data=data),
            p.QueryAck)
        ids = np.frombuffer(ack.ids, dtype="<i8").reshape(ack.nq, ack.k)
        scores = np.frombuffer(ack.scores, dtype="<i8").reshape(ack.nq,
                                                                ack.k)
        return ids, scores

    def state_hash(self) -> Tuple[int, int]:
        """(applied cursor, hash) of the shard's live state."""
        ack = self._request(p.StateHashReq(), p.StateHashAck)
        return ack.t, ack.state_hash

    def tail(self, from_t: int, *, max_commands: int = 0, device=None
             ) -> Tuple[CommandLog, int, int]:
        """Ship the durable commands [from_t, t_end) plus the primary's
        state hash AT t_end — the number a replica must reproduce before
        it may ack. Returns (log, t_end, state_hash), the log on
        ``device`` (the client's when None)."""
        ack = self._request(
            p.Tail(from_t=from_t, max_commands=max_commands), p.TailAck)
        log = log_from_bytes(ack.log, self.contract,
                             device=device or self.device)
        return log, ack.t_end, ack.state_hash

    def side_tail(self, from_index: int) -> Tuple[List[bytes], int, int]:
        """Ship the primary's side-table records [from_index, count) plus
        the chained digest over the whole prefix — the verify target a
        mirroring replica must reproduce (DESIGN.md §9). Returns
        (records, count, table_digest)."""
        ack = self._request(p.SideTail(from_index=from_index), p.SideTailAck)
        return list(ack.records), ack.count, ack.table_digest

    def replica_ack(self, replica_id: int, t: int, state_hash: int) -> int:
        ack = self._request(
            p.ReplicaCursorAck(replica_id=replica_id, t=t,
                               state_hash=state_hash),
            p.ReplicaCursorAckAck)
        return ack.t

    def close(self) -> None:
        self.transport.close()


def remote_sharded_query(clients: Sequence[RemoteShardClient], queries_raw,
                         k: int, plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The planned route fanned out over remote shard hosts — the wire
    twin of ``query.sharded_host_query``: every shard executes the same
    plan on its applied state, candidates combine with the one
    order-invariant (score, id) merge, so the answer is bit-identical to
    the in-process sharded read on the same content. Returns
    (ids [nq, k], scores [nq, k]) on the first client's device."""
    dev = clients[0].device
    ids_parts, score_parts = [], []
    for c in clients:
        ids, scores = c.query(queries_raw, k, plan)
        ids_parts.append(torch.from_numpy(np.array(ids, np.int64)).to(dev))
        score_parts.append(
            torch.from_numpy(np.array(scores, np.int64)).to(dev))
    flat_ids = torch.cat(ids_parts, dim=-1)
    flat_scores = torch.cat(score_parts, dim=-1)
    s_out, i_out = search.merge_candidates(flat_scores, flat_ids, k)
    return i_out, s_out
