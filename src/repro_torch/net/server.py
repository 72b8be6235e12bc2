"""Shard host: one ``DurableStore`` + its applied state behind the wire
protocol (DESIGN.md §8).

The port of ``repro.net.server``: the same verbs, refusals and response
frames, with the applied state on the host's ``device`` (``cuda`` unless
the caller names another). QUERY runs ``query.execute_plan`` there: the
exact route through qgemm + qtopk, the coarse route through qcoarse +
qtopk + the qgemm re-rank. A kernel that fails on the host reaches the
client as a ``RemoteError``, like every other refusal; nothing falls back.

``ShardHost`` is the transport-free request handler — every protocol
message maps onto the durable-store primitive the coordinator would have
called locally (append_many / checkpoint / restore_at / recover /
rollback_to / retain / read_range), plus the replication verbs (TAIL,
REPLICA_ACK, STATE_HASH) and the planned read path (QUERY executes the
coordinator's ``QueryPlan`` route on the applied state). ``ShardServer``
wraps a host in a TCP accept loop, one frame per request; the CLI
(``python -m repro_torch.net.server``) runs one shard per process and prints
``LISTENING <port>`` so a launcher or test can find the bound port.

Two invariants make the host correct under an at-least-once transport:

  * APPEND carries the client's expected base cursor; the host applies
    only at that cursor, and recognizes a byte-identical redelivery of the
    last committed group (same base, same digest, cursor already advanced)
    as a duplicate to re-ack — exactly-once commit over retries;
  * every hash the host advertises (HELLO, TAIL, STATE_HASH, REPLICA_ACK
    verification) is ``hashing.hash_pytree`` of a state the determinism
    contract makes bit-reproducible, so the remote end can *check* it
    rather than trust it.

A third invariant fences failover (DESIGN.md §12): the host keeps a
**durable fencing epoch** (an ``epoch`` file beside the store) that only
ever increases — adopted from HELLO, HEARTBEAT or APPEND frames carrying
a greater one, persisted *before* it takes effect. An APPEND whose epoch
is below the host's durable epoch is refused with ``StaleEpochError``:
once the failure detector stamps a revived old primary with the fleet
epoch, that host's pre-failover writers can never commit again.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import socket
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codes as codes_lib
from repro_torch.core import hashing, machine, query as query_lib, snapshot
from repro_torch.core.commands import log_from_bytes, log_to_bytes
from repro_torch.core.contracts import DEFAULT_CONTRACT, get_contract
from repro_torch.core.durability import DurableStore, SideTable
from repro_torch.core.shard_wal import live_count
from repro_torch.core.state import MemoryState, init_state
from repro_torch.net import protocol as p

_VDT = {1: "<i1", 2: "<i2", 4: "<i4", 8: "<i8"}

EPOCH_FILE = "epoch"


def load_epoch(directory) -> int:
    """The shard's durable fencing epoch (0 when never stamped)."""
    path = pathlib.Path(directory) / EPOCH_FILE
    try:
        return int(path.read_text().strip())
    except (FileNotFoundError, ValueError):
        return 0


def persist_epoch(directory, epoch: int) -> None:
    """Durably record the fencing epoch (write-then-rename + fsync, the
    WAL discipline: the fence must survive exactly the crashes it exists
    to fence)."""
    path = pathlib.Path(directory) / EPOCH_FILE
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        f.write(f"{int(epoch)}\n")
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)


class ShardHost:
    """The request handler: one durable shard, its applied state, and the
    replication bookkeeping — no sockets. ``handle(msg)`` is the entire
    server semantics; ``ShardServer`` and the in-process ``LocalTransport``
    drive the same code path, so fault-injection tests exercise exactly
    the bytes and branches production traffic does."""

    def __init__(self, directory, genesis: Optional[MemoryState] = None, *,
                 segment_records: int = 1024,
                 ef_construction: int = 32, device=None,
                 chunk_size: int = snapshot.DEFAULT_CHUNK_SIZE):
        # chunk_size applies to a fresh store (store.json records it)
        self.store = DurableStore(directory, genesis,
                                  segment_records=segment_records,
                                  chunk_size=chunk_size, device=device)
        self.ef_construction = ef_construction
        # compressed-tier cache, keyed by applied cursor: the code table is
        # a pure function of the state (DESIGN.md §10), so any holder of the
        # same durable prefix derives the same table — caching is a cost
        # choice, never a semantic one. One per host.
        self._code_cache: Optional[Tuple[int, object]] = None
        self._lock = threading.RLock()
        # (base_t, group digest, resulting t) of the last committed group —
        # the duplicate-APPEND detector (at-least-once transport)
        self._last_group: Optional[Tuple[int, int, int]] = None
        self.replica_cursors: Dict[int, int] = {}  # replica_id -> acked t
        self.state, self._hash, t = self.store.recover(
            ef_construction=ef_construction)
        assert t == self.store.t
        # serving-layer cache shipped to replicas via SIDE_TAIL (§9): doc
        # token prefixes and friends, torn-tail-truncated on open like the
        # engine's own table
        self.side_table = SideTable(self.store.dir / "docs.sdt")
        # fencing epoch (§12): survives restarts — a revived host stays
        # fenced at whatever epoch it was last stamped with
        self.epoch = load_epoch(self.store.dir)
        self._closed = False

    @classmethod
    def adopt(cls, store: DurableStore, state: MemoryState, state_hash: int,
              *, ef_construction: int = 32,
              epoch: Optional[int] = None) -> "ShardHost":
        """Wrap an already-open store + verified applied state as a host
        WITHOUT the recovery replay — the promotion path (DESIGN.md §9):
        a replica's state is proven bit-identical at its cursor, so the
        new primary adopts it after one lockstep check instead of
        rebuilding it from the WAL. ``epoch``, when given, stamps the
        promoted host with the new fleet epoch durably (§12) — promotion
        IS an epoch change, so the old regime's writers are fenced from
        the first request the new primary serves."""
        if int(state.version) != store.t:
            raise ValueError(
                f"adopt: applied cursor {int(state.version)} != durable "
                f"cursor {store.t} — recover() first")
        host = cls.__new__(cls)
        host.store = store
        host.ef_construction = ef_construction
        host._code_cache = None
        host._lock = threading.RLock()
        host._last_group = None
        host.replica_cursors = {}
        host.state = state
        host._hash = state_hash
        host.side_table = SideTable(store.dir / "docs.sdt")
        host.epoch = load_epoch(store.dir)
        host._closed = False
        if epoch is not None:
            host._adopt_epoch(epoch)
        return host

    def _adopt_epoch(self, epoch: int) -> None:
        """Monotone epoch adoption: persist BEFORE honoring, so a crash
        can only lose an *advance* (re-stamped by the next beat), never
        resurrect a fenced regime."""
        if epoch > self.epoch:
            persist_epoch(self.store.dir, epoch)
            self.epoch = epoch

    def close(self) -> None:
        """Idempotent teardown (the side table holds the only file handle
        that outlives a request)."""
        with self._lock:
            if self._closed:
                return
            self.side_table.close()
            self._closed = True

    # ------------------------------------------------------------------ #

    @property
    def contract(self):
        return self.store.wal.contract

    def state_hash(self) -> int:
        return self._hash

    def _hash_at(self, t: int) -> int:
        """The shard's state hash as of cursor ``t`` — live when ``t`` is
        the applied cursor, otherwise a time-travel restore (total over the
        retained window: the genesis snapshot exists from birth)."""
        if t == int(self.state.version):
            return self._hash
        return self.store.restore_at(
            t, ef_construction=self.ef_construction)[1]

    def handle(self, msg: p.Message) -> p.Message:
        """One request to one response. Every refusal becomes an ERROR
        frame carrying the exception class name, so the client can rebuild
        the same exception family (``RemoteError`` is a ``ValueError``) and
        the coordinator's local error handling stays transport-agnostic."""
        with self._lock:
            try:
                return self._dispatch(msg)
            except Exception as e:  # noqa: BLE001 — becomes a typed frame
                return p.ErrorMsg(kind=type(e).__name__, message=str(e))

    # ------------------------------------------------------------------ #

    def _dispatch(self, msg: p.Message) -> p.Message:
        if isinstance(msg, p.Hello):
            self._adopt_epoch(msg.epoch)
            isz = self.contract.np_storage_dtype.itemsize
            return p.HelloAck(dim=self.store.wal.dim, itemsize=isz,
                              contract=self.contract.name, t=self.store.t,
                              state_hash=self._hash, epoch=self.epoch)
        if isinstance(msg, p.Heartbeat):
            self._adopt_epoch(msg.epoch)
            return p.HeartbeatAck(t=self.store.t, epoch=self.epoch,
                                  state_hash=self._hash)
        if isinstance(msg, p.Cursor):
            return p.CursorAck(t=self.store.t)
        if isinstance(msg, p.Append):
            return self._do_append(msg)
        if isinstance(msg, p.Query):
            return self._do_query(msg)
        if isinstance(msg, p.Checkpoint):
            return self._do_checkpoint(msg)
        if isinstance(msg, p.RestoreAt):
            state, h = self.store.restore_at(
                msg.t, ef_construction=self.ef_construction)
            return p.StateAck(t=msg.t, state_hash=h,
                              blob=snapshot.snapshot_bytes(state))
        if isinstance(msg, p.Recover):
            self.state, self._hash, t = self.store.recover(
                ef_construction=self.ef_construction)
            self._last_group = None
            return p.StateAck(t=t, state_hash=self._hash,
                              blob=snapshot.snapshot_bytes(self.state))
        if isinstance(msg, p.Rollback):
            self.store.rollback_to(msg.t)
            self.state, self._hash = self.store.restore_at(
                msg.t, ef_construction=self.ef_construction)
            self._last_group = None
            return p.RollbackAck(t=msg.t)
        if isinstance(msg, p.Tail):
            return self._do_tail(msg)
        if isinstance(msg, p.ReplicaCursorAck):
            return self._do_replica_ack(msg)
        if isinstance(msg, p.StateHashReq):
            return p.StateHashAck(t=int(self.state.version),
                                  state_hash=self._hash)
        if isinstance(msg, p.ReadRange):
            # read straight into host memory: the commands only become bytes
            log = self.store.wal.read_range(msg.t0, msg.t1, device="cpu")
            return p.LogAck(log=log_to_bytes(log))
        if isinstance(msg, p.SideTail):
            count = self.side_table.record_count
            if msg.from_index > count:
                raise ValueError(
                    f"side tail from index {msg.from_index} is ahead of the "
                    f"table's {count} records")
            return p.SideTailAck(
                from_index=msg.from_index, count=count,
                table_digest=self.side_table.digest_at(count),
                records=tuple(self.side_table.records_from(msg.from_index)))
        if isinstance(msg, p.Retain):
            stats = self.store.retain(msg.keep)
            return p.RetainAck(
                snapshots_dropped=stats["snapshots_dropped"],
                wal_segments_dropped=stats["wal_segments_dropped"],
                chunks_dropped=stats["chunks_dropped"],
                oldest_snapshot=stats["oldest_snapshot"])
        raise ValueError(f"request type {type(msg).__name__} not servable")

    # ------------------------------------------------------------------ #

    def _do_append(self, msg: p.Append) -> p.AppendAck:
        if msg.epoch < self.epoch:
            # the fence (§12): this writer belongs to a pre-failover
            # regime — refuse BEFORE any cursor/duplicate logic, so a
            # fenced client cannot even re-ack old work
            raise p.StaleEpochError(
                f"append carries epoch {msg.epoch}, host is fenced at "
                f"epoch {self.epoch}: this writer was superseded by a "
                "promotion and must not commit")
        self._adopt_epoch(msg.epoch)
        if not msg.logs:
            return p.AppendAck(t=self.store.t)
        digest = hashing.digest_bytes(b"".join(msg.logs))
        if msg.base_t != self.store.t:
            last = self._last_group
            if (last is not None and msg.base_t == last[0]
                    and digest == last[1] and self.store.t == last[2]):
                # byte-identical redelivery of the committed group (the
                # ack was lost in transit): re-ack, never re-apply
                return p.AppendAck(t=self.store.t)
            raise ValueError(
                f"append base_t={msg.base_t} != durable cursor "
                f"{self.store.t}; recover() the coordinator first")
        logs = [log_from_bytes(b, self.contract, device=self.store.device)
                for b in msg.logs]
        # WAL first, then the applied state — a crash between the two is
        # exactly the recover() case (state rebuilt from the durable log)
        t = self.store.append_many(logs)
        state = self.state
        for log in logs:
            state = machine.bulk_apply(state, log,
                                       ef_construction=self.ef_construction)
        assert int(state.version) == t, "applied state fell out of lockstep"
        self.state = state
        self._hash = hashing.hash_state_device(state)
        self._last_group = (msg.base_t, digest, t)
        return p.AppendAck(t=t)

    def _coarse_table(self):
        """The shard's int8 code table at the current applied cursor,
        derived from the state on first use and kept until the cursor
        moves (every applied command advances ``state.version``, and a
        rollback to cursor t restores the deterministic state at t, so
        the cursor fully keys the table)."""
        v = int(self.state.version)
        if self._code_cache is None or self._code_cache[0] != v:
            self._code_cache = (v, codes_lib.build(self.state))
        return self._code_cache[1]

    def _do_query(self, msg: p.Query) -> p.QueryAck:
        vdt = _VDT.get(msg.itemsize)
        if vdt is None:
            raise ValueError(f"unsupported query itemsize {msg.itemsize}")
        want = msg.nq * msg.dim * msg.itemsize
        if len(msg.data) != want:
            raise ValueError(
                f"query payload is {len(msg.data)} bytes, "
                f"[{msg.nq}, {msg.dim}] x {msg.itemsize} needs {want}")
        # np.frombuffer is read-only: copy before handing it to torch
        queries = torch.from_numpy(
            np.frombuffer(msg.data, dtype=vdt).reshape(msg.nq, msg.dim)
            .copy()).to(device=self.state.device,
                        dtype=self.contract.storage_dtype)
        # the wire Query reuses the ef field for the coarse candidate-set
        # size (the route string disambiguates), so the frozen frame
        # format carries the compressed tier without a fields change
        coarse = msg.route == query_lib.ROUTE_COARSE
        plan = query_lib.QueryPlan(
            route=msg.route, k=msg.k, ef=msg.ef, use_kernel=msg.use_kernel,
            live_count=live_count(self.state), reason="remote",
            ef_coarse=msg.ef if coarse else 0, dim=msg.dim)
        table = self._coarse_table() if coarse else None
        ids, scores = query_lib.execute_plan(self.state, queries, msg.k, plan,
                                             codes=table)
        ids_h = ids.cpu().numpy().astype("<i8")
        scores_h = scores.cpu().numpy().astype("<i8")
        return p.QueryAck(nq=msg.nq, k=msg.k, ids=ids_h.tobytes(),
                          scores=scores_h.tobytes())

    def _do_checkpoint(self, msg: p.Checkpoint) -> p.CheckpointAck:
        if msg.t != int(self.state.version):
            raise ValueError(
                f"checkpoint at t={msg.t} but applied cursor is "
                f"{int(self.state.version)}")
        if msg.expect_hash != self._hash:
            raise ValueError(
                f"checkpoint hash mismatch at t={msg.t}: coordinator slice "
                f"{msg.expect_hash:#x}, applied shard {self._hash:#x} — "
                "the shard diverged from the coordinator's audit twin")
        stats = self.store.checkpoint(self.state)
        return p.CheckpointAck(t=msg.t,
                               bytes_written=stats.get("bytes_written", 0))

    def _do_tail(self, msg: p.Tail) -> p.TailAck:
        if msg.from_t > self.store.t:
            raise ValueError(
                f"tail from t={msg.from_t} is ahead of durable cursor "
                f"{self.store.t}")
        log, t_end = self.store.wal.tail(msg.from_t,
                                         max_commands=msg.max_commands,
                                         device="cpu")
        return p.TailAck(from_t=msg.from_t, t_end=t_end,
                         state_hash=self._hash_at(t_end),
                         log=log_to_bytes(log))

    def _do_replica_ack(self, msg: p.ReplicaCursorAck) -> p.Message:
        if msg.t > self.store.t:
            raise ValueError(
                f"replica acked t={msg.t} ahead of the primary's durable "
                f"cursor {self.store.t}")
        expect = self._hash_at(msg.t)
        if msg.state_hash != expect:
            raise ValueError(
                f"replica {msg.replica_id} diverged at t={msg.t}: replica "
                f"{msg.state_hash:#x}, primary {expect:#x}")
        prev = self.replica_cursors.get(msg.replica_id, 0)
        self.replica_cursors[msg.replica_id] = max(prev, msg.t)
        return p.ReplicaCursorAckAck(t=self.replica_cursors[msg.replica_id])


# --------------------------------------------------------------------------- #
# TCP server
# --------------------------------------------------------------------------- #


def read_frame(sock: socket.socket) -> Optional[bytes]:
    """Read exactly one frame off a stream socket (None on clean EOF at a
    frame boundary). A connection that dies mid-frame raises
    TransportError — the frame was torn, not delivered."""
    header = _read_exact(sock, p.HEADER_BYTES, eof_ok=True)
    if header is None:
        return None
    total = p.frame_length(header)  # validates magic/format
    rest = _read_exact(sock, total - p.HEADER_BYTES, eof_ok=False)
    return header + rest


def _read_exact(sock: socket.socket, n: int, *, eof_ok: bool
                ) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError as e:
            raise p.TransportError(f"connection lost mid-frame: {e}") from e
        if not chunk:
            if eof_ok and not buf:
                return None
            raise p.TransportError(
                f"connection closed after {len(buf)}/{n} bytes of a frame")
        buf += chunk
    return buf


class ShardServer:
    """A ``ShardHost`` behind a TCP accept loop: one frame in, one frame
    out, connections served on daemon threads (the host serializes on its
    own lock, so concurrency never reorders a connection's commits)."""

    def __init__(self, host: ShardHost, *, address: str = "127.0.0.1",
                 port: int = 0):
        self.host = host
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((address, port))
        self._sock.listen(16)
        self.address, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ShardServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # close() shut the listener down
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    frame = read_frame(conn)
                except (p.TransportError, p.ProtocolError):
                    return  # torn/garbage stream: drop the connection
                if frame is None:
                    return
                try:
                    msg, rid, _ = p.decode_frame(frame)
                    resp = self.host.handle(msg)
                except p.ProtocolError as e:
                    resp, rid = p.ErrorMsg(kind="ProtocolError",
                                           message=str(e)), 0
                try:
                    conn.sendall(p.encode_frame(resp, rid))
                except OSError:
                    return

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serve one durable shard over the wire protocol")
    ap.add_argument("--dir", required=True, help="shard store directory")
    ap.add_argument("--capacity", type=int, default=0,
                    help="genesis capacity (required when --dir is fresh)")
    ap.add_argument("--dim", type=int, default=0,
                    help="genesis vector dim (required when --dir is fresh)")
    ap.add_argument("--contract", default=DEFAULT_CONTRACT.name)
    ap.add_argument("--segment-records", type=int, default=1024)
    ap.add_argument("--chunk-size", type=int,
                    default=snapshot.DEFAULT_CHUNK_SIZE,
                    help="snapshot chunk bytes of a fresh --dir")
    ap.add_argument("--ef-construction", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where the shard's state lives and its reads run")
    ap.add_argument("--address", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed on stdout)")
    args = ap.parse_args(argv)

    directory = pathlib.Path(args.dir)
    genesis = None
    if not (directory / "store.json").exists():
        if not (args.capacity and args.dim):
            ap.error("--capacity and --dim are required for a fresh --dir")
        genesis = init_state(args.capacity, args.dim,
                             contract=get_contract(args.contract),
                             device=args.device)
    host = ShardHost(directory, genesis,
                     segment_records=args.segment_records,
                     ef_construction=args.ef_construction,
                     device=args.device, chunk_size=args.chunk_size)
    server = ShardServer(host, address=args.address, port=args.port)
    print(f"LISTENING {server.port}", flush=True)
    print(f"CURSOR {host.store.t}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
