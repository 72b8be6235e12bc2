"""Deterministic wire protocol for shard serving + replication (DESIGN.md §8).

The port of ``repro.net.protocol``, byte for byte: the same frames, the
same digest (``hashing.digest_bytes``) and the same refusals, so a
client of either package talks to a host of the other.

One frame layout for every message, little-endian throughout — the WAL
record discipline (docs/wal-format.md) applied to the network:

  offset  size  field
  0       4     magic  b"VWIR"
  4       4     u32 format = 2
  8       4     u32 msg_type
  12      8     u64 request_id   (echoed by the response; reordered or
                                  foreign responses are detected, not
                                  silently consumed)
  20      4     u32 payload length N
  24      N     payload          (canonical per-type encoding below)
  24+N    8     u64 digest = hashing.digest_bytes(frame[0:24+N])

The digest makes a torn, truncated or bit-flipped frame a *decode error*
(``ProtocolError``), never a silently different message — the property
tests/test_protocol.py and tests/test_torch_protocol.py pin byte-by-byte.
Payload encodings are canonical (field order fixed, strings as u32-len +
utf8, arrays as raw little-endian bytes), so encoding is deterministic:
the same message always produces the same bytes, and every message type
is byte-frozen by a golden fixture (scripts/gen_golden_wire.py).

Command logs travel as ``commands.log_to_bytes`` blobs; states travel as
v1 snapshot blobs (``snapshot.snapshot_bytes``), whose embedded state hash
is re-verified on restore — integrity is checked at the frame layer AND at
the content layer.

Transports are a one-method seam (``request(bytes) -> bytes``) so the
fault-injection suite can drop, duplicate, delay, reorder and corrupt
messages without sockets; ``TransportError`` is the "message lost" signal
retriable callers (the replica's catch-up loop, the group-commit writer's
pending buffer) recover from.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Tuple, Type

from repro_torch.core import hashing

MAGIC = b"VWIR"
# format 2: HEARTBEAT/HEARTBEAT_ACK lease frames + the fencing epoch
# carried by HELLO / HELLO_ACK / APPEND (DESIGN.md §12). Any payload
# change is a format bump + a deliberate golden-fixture regeneration
# (scripts/gen_golden_wire.py) — never a silent reinterpretation.
WIRE_FORMAT = 2
HEADER_BYTES = 24
DIGEST_BYTES = 8

# message type ids (u32). Requests are odd-ish historical accidents are
# avoided: every type is explicit and golden-fixture-frozen.
HELLO = 1
HELLO_ACK = 2
CURSOR = 3
CURSOR_ACK = 4
APPEND = 5
APPEND_ACK = 6
QUERY = 7
QUERY_ACK = 8
CHECKPOINT = 9
CHECKPOINT_ACK = 10
RESTORE_AT = 11
STATE_ACK = 12
RECOVER = 13
ROLLBACK = 14
ROLLBACK_ACK = 15
TAIL = 16
TAIL_ACK = 17
REPLICA_ACK = 18
REPLICA_ACK_ACK = 19
STATE_HASH = 20
STATE_HASH_ACK = 21
READ_RANGE = 22
LOG_ACK = 23
RETAIN = 24
RETAIN_ACK = 25
SIDE_TAIL = 26
SIDE_TAIL_ACK = 27
HEARTBEAT = 28
HEARTBEAT_ACK = 29
ERROR = 255


class ProtocolError(ValueError):
    """A frame or payload failed to decode: torn, truncated, bit-flipped,
    wrong magic/format, trailing garbage, or a response whose request id
    does not match the request (reordered/foreign delivery)."""


class TransportError(OSError):
    """A message was lost in transit (connection refused/reset, timeout,
    injected drop). The request may or may not have reached the server —
    callers must treat delivery as at-least-once and rely on the
    protocol's idempotence (e.g. APPEND's base-cursor precondition)."""


class RemoteError(ValueError):
    """The server executed the request and refused it. ``kind`` carries the
    server-side exception class name; subclassing ValueError keeps the
    coordinator's transport-agnostic error handling (restore fallbacks,
    rollback refusals) working identically for local and remote shards."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.remote_message = message


class StaleEpochError(ValueError):
    """A write carried an epoch below the host's durable epoch — the
    writer belongs to a fenced (pre-failover) regime. A revived old
    primary that was stamped with the fleet epoch refuses its old
    clients' APPENDs with this, so a split brain can never commit; the
    refusal crosses the wire as ``RemoteError(kind="StaleEpochError")``."""


# --------------------------------------------------------------------------- #
# strict little-endian payload reader/writer
# --------------------------------------------------------------------------- #


class _Writer:
    def __init__(self):
        self._parts = []

    def u8(self, v: int):
        self._parts.append(struct.pack("<B", v))

    def u32(self, v: int):
        self._parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self._parts.append(struct.pack("<Q", v & ((1 << 64) - 1)))

    def i64(self, v: int):
        self._parts.append(struct.pack("<q", v))

    def str_(self, s: str):
        b = s.encode()
        self.u32(len(b))
        self._parts.append(b)

    def bytes_(self, b: bytes):
        self.u32(len(b))
        self._parts.append(bytes(b))

    def bytes_list(self, bs):
        self.u32(len(bs))
        for b in bs:
            self.bytes_(b)

    def value(self) -> bytes:
        return b"".join(self._parts)


class _Reader:
    def __init__(self, data: bytes):
        self._d = data
        self._off = 0

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._d):
            raise ProtocolError(
                f"payload truncated: wanted {n} bytes at offset {self._off}, "
                f"payload is {len(self._d)} bytes")
        out = self._d[self._off:self._off + n]
        self._off += n
        return out

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def str_(self) -> str:
        n = self.u32()
        try:
            return self._take(n).decode()
        except UnicodeDecodeError as e:
            raise ProtocolError(f"invalid utf8 string: {e}") from e

    def bytes_(self) -> bytes:
        return self._take(self.u32())

    def bytes_list(self) -> Tuple[bytes, ...]:
        return tuple(self.bytes_() for _ in range(self.u32()))

    def done(self) -> None:
        if self._off != len(self._d):
            raise ProtocolError(
                f"trailing garbage: {len(self._d) - self._off} bytes past "
                "the end of the payload")


# --------------------------------------------------------------------------- #
# message dataclasses — canonical field order IS the wire order
# --------------------------------------------------------------------------- #
#
# FIELDS maps each dataclass field to its wire kind; encode/decode walk the
# spec in order, so adding a field is a format change (bump WIRE_FORMAT and
# regenerate the golden fixtures deliberately).

_FIELD_KINDS = ("u8", "u32", "u64", "i64", "str", "bytes", "bytes_list",
                "bool")


@dataclasses.dataclass(frozen=True)
class Message:
    # deliberately un-annotated: class metadata, not dataclass fields
    TYPE = -1
    FIELDS = ()

    def encode_payload(self) -> bytes:
        w = _Writer()
        for name, kind in self.FIELDS:
            v = getattr(self, name)
            if kind == "u8":
                w.u8(v)
            elif kind == "bool":
                w.u8(1 if v else 0)
            elif kind == "u32":
                w.u32(v)
            elif kind == "u64":
                w.u64(v)
            elif kind == "i64":
                w.i64(v)
            elif kind == "str":
                w.str_(v)
            elif kind == "bytes":
                w.bytes_(v)
            elif kind == "bytes_list":
                w.bytes_list(v)
            else:  # pragma: no cover — spec typo guard
                raise AssertionError(f"unknown field kind {kind}")
        return w.value()

    @classmethod
    def decode_payload(cls, payload: bytes) -> "Message":
        r = _Reader(payload)
        kwargs = {}
        for name, kind in cls.FIELDS:
            if kind == "u8":
                kwargs[name] = r.u8()
            elif kind == "bool":
                kwargs[name] = bool(r.u8())
            elif kind == "u32":
                kwargs[name] = r.u32()
            elif kind == "u64":
                kwargs[name] = r.u64()
            elif kind == "i64":
                kwargs[name] = r.i64()
            elif kind == "str":
                kwargs[name] = r.str_()
            elif kind == "bytes":
                kwargs[name] = r.bytes_()
            elif kind == "bytes_list":
                kwargs[name] = r.bytes_list()
            else:  # pragma: no cover
                raise AssertionError(f"unknown field kind {kind}")
        r.done()
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class Hello(Message):
    """Open a session: learn the shard's shape before trusting it.
    ``epoch`` is the client's fencing epoch (DESIGN.md §12) — the host
    adopts a greater one and advertises its own in the ack, so both ends
    leave the handshake agreeing on the newest regime either has seen."""
    TYPE = HELLO
    FIELDS = (("epoch", "u64"),)
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class HelloAck(Message):
    TYPE = HELLO_ACK
    FIELDS = (("dim", "u32"), ("itemsize", "u32"), ("contract", "str"),
              ("t", "u64"), ("state_hash", "u64"), ("epoch", "u64"))
    dim: int = 0
    itemsize: int = 0
    contract: str = ""
    t: int = 0
    state_hash: int = 0
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class Cursor(Message):
    """The shard's durable cursor (the fleet-lockstep probe)."""
    TYPE = CURSOR
    FIELDS = ()


@dataclasses.dataclass(frozen=True)
class CursorAck(Message):
    TYPE = CURSOR_ACK
    FIELDS = (("t", "u64"),)
    t: int = 0


@dataclasses.dataclass(frozen=True)
class Append(Message):
    """Group-commit this shard's share of one or more batches.

    ``base_t`` is the precondition cursor: the server applies only when its
    durable cursor equals it, and recognizes an exact re-delivery (same
    base, same bytes, cursor already advanced) as a duplicate to re-ack —
    exactly-once commit semantics over an at-least-once transport.
    ``epoch`` is the writer's fencing epoch: a host whose durable epoch is
    greater refuses the append with ``StaleEpochError`` — the fence that
    keeps a revived pre-failover primary's clients from committing."""
    TYPE = APPEND
    FIELDS = (("base_t", "u64"), ("epoch", "u64"), ("logs", "bytes_list"))
    base_t: int = 0
    epoch: int = 0
    logs: Tuple[bytes, ...] = ()


@dataclasses.dataclass(frozen=True)
class AppendAck(Message):
    TYPE = APPEND_ACK
    FIELDS = (("t", "u64"),)
    t: int = 0


@dataclasses.dataclass(frozen=True)
class Query(Message):
    """Run the planned route on the shard's applied state; the coordinator
    merges per-shard candidates with the order-invariant combine."""
    TYPE = QUERY
    FIELDS = (("k", "u32"), ("ef", "u32"), ("route", "str"),
              ("use_kernel", "bool"), ("nq", "u32"), ("dim", "u32"),
              ("itemsize", "u32"), ("data", "bytes"))
    k: int = 0
    ef: int = 0
    route: str = "exact"
    use_kernel: bool = False
    nq: int = 0
    dim: int = 0
    itemsize: int = 4
    data: bytes = b""


@dataclasses.dataclass(frozen=True)
class QueryAck(Message):
    TYPE = QUERY_ACK
    FIELDS = (("nq", "u32"), ("k", "u32"), ("ids", "bytes"),
              ("scores", "bytes"))
    nq: int = 0
    k: int = 0
    ids: bytes = b""     # [nq, k] int64 LE
    scores: bytes = b""  # [nq, k] int64 LE


@dataclasses.dataclass(frozen=True)
class Checkpoint(Message):
    """Snapshot the shard's applied state at cursor ``t`` — but only if its
    ``hash_pytree`` equals ``expect_hash``: the coordinator's slice and the
    server's applied state are bit-identical by the determinism contract,
    so a mismatch is divergence and must refuse, not snapshot."""
    TYPE = CHECKPOINT
    FIELDS = (("t", "u64"), ("expect_hash", "u64"))
    t: int = 0
    expect_hash: int = 0


@dataclasses.dataclass(frozen=True)
class CheckpointAck(Message):
    TYPE = CHECKPOINT_ACK
    FIELDS = (("t", "u64"), ("bytes_written", "u64"))
    t: int = 0
    bytes_written: int = 0


@dataclasses.dataclass(frozen=True)
class RestoreAt(Message):
    TYPE = RESTORE_AT
    FIELDS = (("t", "u64"),)
    t: int = 0


@dataclasses.dataclass(frozen=True)
class StateAck(Message):
    """A full shard state in flight: v1 snapshot blob (self-verifying — the
    embedded hash is re-checked on restore) + the cursor and hash."""
    TYPE = STATE_ACK
    FIELDS = (("t", "u64"), ("state_hash", "u64"), ("blob", "bytes"))
    t: int = 0
    state_hash: int = 0
    blob: bytes = b""


@dataclasses.dataclass(frozen=True)
class Recover(Message):
    TYPE = RECOVER
    FIELDS = ()


@dataclasses.dataclass(frozen=True)
class Rollback(Message):
    TYPE = ROLLBACK
    FIELDS = (("t", "u64"),)
    t: int = 0


@dataclasses.dataclass(frozen=True)
class RollbackAck(Message):
    TYPE = ROLLBACK_ACK
    FIELDS = (("t", "u64"),)
    t: int = 0


@dataclasses.dataclass(frozen=True)
class Tail(Message):
    """Log shipping: the commands [from_t, min(cursor, from_t + max)) plus
    the primary's state hash AT the returned end cursor — the hash the
    replica must reproduce before acking. ``max_commands=0`` = no bound."""
    TYPE = TAIL
    FIELDS = (("from_t", "u64"), ("max_commands", "u32"))
    from_t: int = 0
    max_commands: int = 0


@dataclasses.dataclass(frozen=True)
class TailAck(Message):
    TYPE = TAIL_ACK
    FIELDS = (("from_t", "u64"), ("t_end", "u64"), ("state_hash", "u64"),
              ("log", "bytes"))
    from_t: int = 0
    t_end: int = 0
    state_hash: int = 0
    log: bytes = b""  # commands.log_to_bytes of [from_t, t_end)


@dataclasses.dataclass(frozen=True)
class ReplicaCursorAck(Message):
    """A replica's verified-cursor ack. The primary refuses an ack whose
    hash contradicts its own state at that cursor — a divergent replica is
    an error at BOTH ends, never a bookkeeping entry."""
    TYPE = REPLICA_ACK
    FIELDS = (("replica_id", "u64"), ("t", "u64"), ("state_hash", "u64"))
    replica_id: int = 0
    t: int = 0
    state_hash: int = 0


@dataclasses.dataclass(frozen=True)
class ReplicaCursorAckAck(Message):
    TYPE = REPLICA_ACK_ACK
    FIELDS = (("t", "u64"),)
    t: int = 0


@dataclasses.dataclass(frozen=True)
class StateHashReq(Message):
    TYPE = STATE_HASH
    FIELDS = ()


@dataclasses.dataclass(frozen=True)
class StateHashAck(Message):
    TYPE = STATE_HASH_ACK
    FIELDS = (("t", "u64"), ("state_hash", "u64"))
    t: int = 0
    state_hash: int = 0


@dataclasses.dataclass(frozen=True)
class ReadRange(Message):
    TYPE = READ_RANGE
    FIELDS = (("t0", "u64"), ("t1", "u64"))
    t0: int = 0
    t1: int = 0


@dataclasses.dataclass(frozen=True)
class LogAck(Message):
    TYPE = LOG_ACK
    FIELDS = (("log", "bytes"),)
    log: bytes = b""


@dataclasses.dataclass(frozen=True)
class Retain(Message):
    TYPE = RETAIN
    FIELDS = (("keep", "u32"),)
    keep: int = 1


@dataclasses.dataclass(frozen=True)
class RetainAck(Message):
    TYPE = RETAIN_ACK
    FIELDS = (("snapshots_dropped", "u64"), ("wal_segments_dropped", "u64"),
              ("chunks_dropped", "u64"), ("oldest_snapshot", "u64"))
    snapshots_dropped: int = 0
    wal_segments_dropped: int = 0
    chunks_dropped: int = 0
    oldest_snapshot: int = 0


@dataclasses.dataclass(frozen=True)
class SideTail(Message):
    """Side-table shipping: pull the primary's ``SideTable`` records from
    record index ``from_index`` onward, so a replica mirrors doc token
    prefixes alongside the WAL slices it tails — a promoted replica then
    serves prefixes without refilling."""
    TYPE = SIDE_TAIL
    FIELDS = (("from_index", "u64"),)
    from_index: int = 0


@dataclasses.dataclass(frozen=True)
class SideTailAck(Message):
    """Raw self-validating side-table records [from_index, count) plus the
    primary's running digest over ALL record bytes up to ``count`` — the
    content-layer verify target, exactly like TAIL_ACK's ``state_hash``."""
    TYPE = SIDE_TAIL_ACK
    FIELDS = (("from_index", "u64"), ("count", "u64"),
              ("table_digest", "u64"), ("records", "bytes_list"))
    from_index: int = 0
    count: int = 0
    table_digest: int = 0
    records: Tuple[bytes, ...] = ()


@dataclasses.dataclass(frozen=True)
class Heartbeat(Message):
    """One lease beat from the failure detector (DESIGN.md §12): proves
    the host is alive AND stamps it with the detector's fleet epoch —
    the host adopts a greater epoch durably, which is what fences a
    revived old primary's writers. ``node_id`` identifies the detector
    (diagnostics only; liveness is per-connection)."""
    TYPE = HEARTBEAT
    FIELDS = (("node_id", "u64"), ("epoch", "u64"))
    node_id: int = 0
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class HeartbeatAck(Message):
    """The host's durable cursor, durable epoch and applied state hash —
    one beat doubles as a liveness proof and a divergence tripwire."""
    TYPE = HEARTBEAT_ACK
    FIELDS = (("t", "u64"), ("epoch", "u64"), ("state_hash", "u64"))
    t: int = 0
    epoch: int = 0
    state_hash: int = 0


@dataclasses.dataclass(frozen=True)
class ErrorMsg(Message):
    TYPE = ERROR
    FIELDS = (("kind", "str"), ("message", "str"))
    kind: str = "ValueError"
    message: str = ""


MESSAGE_TYPES: Dict[int, Type[Message]] = {
    cls.TYPE: cls for cls in (
        Hello, HelloAck, Cursor, CursorAck, Append, AppendAck, Query,
        QueryAck, Checkpoint, CheckpointAck, RestoreAt, StateAck, Recover,
        Rollback, RollbackAck, Tail, TailAck, ReplicaCursorAck,
        ReplicaCursorAckAck, StateHashReq, StateHashAck, ReadRange, LogAck,
        Retain, RetainAck, SideTail, SideTailAck, Heartbeat, HeartbeatAck,
        ErrorMsg)
}
assert len(MESSAGE_TYPES) == 30, "duplicate message type id"


# --------------------------------------------------------------------------- #
# frame encode / decode
# --------------------------------------------------------------------------- #


def encode_frame(msg: Message, request_id: int) -> bytes:
    payload = msg.encode_payload()
    head = (MAGIC + struct.pack("<II", WIRE_FORMAT, msg.TYPE)
            + struct.pack("<QI", request_id & ((1 << 64) - 1), len(payload)))
    body = head + payload
    return body + struct.pack("<Q", hashing.digest_bytes(body))


def frame_length(header: bytes) -> int:
    """Total frame size from the fixed 24-byte header (for stream reads).
    Validates magic and format up front so a desynced stream fails fast."""
    if len(header) < HEADER_BYTES:
        raise ProtocolError(
            f"short frame header: {len(header)} < {HEADER_BYTES} bytes")
    if header[:4] != MAGIC:
        raise ProtocolError("bad frame magic")
    (fmt,) = struct.unpack_from("<I", header, 4)
    if fmt != WIRE_FORMAT:
        raise ProtocolError(f"unsupported wire format {fmt}")
    (n,) = struct.unpack_from("<I", header, 20)
    return HEADER_BYTES + n + DIGEST_BYTES


def decode_frame(data: bytes, offset: int = 0) -> Tuple[Message, int, int]:
    """Decode one frame at ``offset``; returns (message, request_id,
    next_offset). Raises ProtocolError on anything short of a bit-perfect
    frame: truncation, digest mismatch, unknown type, payload garbage."""
    view = data[offset:offset + HEADER_BYTES]
    total = frame_length(view)  # validates magic/format, may raise
    if offset + total > len(data):
        raise ProtocolError(
            f"truncated frame: need {total} bytes, have {len(data) - offset}")
    body = data[offset:offset + total - DIGEST_BYTES]
    (stored,) = struct.unpack_from("<Q", data, offset + total - DIGEST_BYTES)
    if stored != hashing.digest_bytes(body):
        raise ProtocolError("frame digest mismatch (corrupt or torn frame)")
    (msg_type,) = struct.unpack_from("<I", data, offset + 8)
    (request_id, n) = struct.unpack_from("<QI", data, offset + 12)
    cls = MESSAGE_TYPES.get(msg_type)
    if cls is None:
        raise ProtocolError(f"unknown message type {msg_type}")
    payload = data[offset + HEADER_BYTES:offset + HEADER_BYTES + n]
    return cls.decode_payload(payload), request_id, offset + total


def raise_if_error(msg: Message) -> Message:
    """Turn a server ERROR frame into the client-side exception hierarchy."""
    if isinstance(msg, ErrorMsg):
        raise RemoteError(msg.kind, msg.message)
    return msg


def expect(msg: Message, cls: Type[Message]) -> Message:
    raise_if_error(msg)
    if not isinstance(msg, cls):
        raise ProtocolError(
            f"expected {cls.__name__}, got {type(msg).__name__}")
    return msg
