"""The port's wire protocol against the reference's, byte for byte: the
golden frames, seeded messages of every type encoded by both packages and
decoded by the other, and the reference suite's rejection cases."""
import dataclasses
import json
import pathlib
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

import repro  # noqa: E402,F401
from repro.net import protocol as jp  # noqa: E402
from repro_torch.core import hashing as thashing  # noqa: E402
from repro_torch.net import protocol as tp  # noqa: E402
from test_protocol import _golden_messages  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "golden_wire"
INDEX = json.loads((FIXTURES / "golden_wire.json").read_text())
GOLDEN = _golden_messages()
NAMES = [name for name, _, _ in GOLDEN]


def to_port(msg):
    """The port's message of the same type and fields as a reference one."""
    return tp.MESSAGE_TYPES[msg.TYPE](**dataclasses.asdict(msg))


def port_golden(name):
    _, msg, rid = GOLDEN[NAMES.index(name)]
    return to_port(msg), rid


def test_message_table_matches_reference():
    assert tp.WIRE_FORMAT == jp.WIRE_FORMAT == INDEX["wire_format"]
    assert (tp.MAGIC, tp.HEADER_BYTES, tp.DIGEST_BYTES) == \
        (jp.MAGIC, jp.HEADER_BYTES, jp.DIGEST_BYTES)
    assert sorted(tp.MESSAGE_TYPES) == sorted(jp.MESSAGE_TYPES)
    for t, cls in tp.MESSAGE_TYPES.items():
        ref = jp.MESSAGE_TYPES[t]
        assert cls.__name__ == ref.__name__ and cls.FIELDS == ref.FIELDS
    assert len(INDEX["frames"]) == len(tp.MESSAGE_TYPES) == 30


@pytest.mark.parametrize("name", NAMES)
def test_golden_frame_round_trips_byte_for_byte(name):
    frozen = (FIXTURES / f"{name}.bin").read_bytes()
    meta = INDEX["frames"][name]
    msg, rid, end = tp.decode_frame(frozen)
    want, want_rid = port_golden(name)
    assert msg == want and rid == want_rid == meta["request_id"]
    assert msg.TYPE == meta["msg_type"] and end == len(frozen) == meta["bytes"]
    assert tp.encode_frame(msg, rid) == frozen
    assert tp.frame_length(frozen[:tp.HEADER_BYTES]) == len(frozen)


# --------------------------------------------------------------------------- #
# seeded messages of every type: the same bytes from both encoders
# --------------------------------------------------------------------------- #

def _value(rng, kind):
    if kind in ("u8",):
        return int(rng.integers(0, 256))
    if kind == "bool":
        return bool(rng.integers(0, 2))
    if kind == "u32":
        return int(rng.integers(0, 1 << 32, dtype=np.uint64))
    if kind == "u64":
        return int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
    if kind == "i64":
        return int(rng.integers(-(1 << 63), 1 << 63))
    if kind == "str":
        alphabet = "abcXYZ09_.é→"
        return "".join(alphabet[i] for i in
                       rng.integers(0, len(alphabet), rng.integers(0, 12)))
    if kind == "bytes":
        return rng.bytes(int(rng.integers(0, 64)))
    if kind == "bytes_list":
        return tuple(rng.bytes(int(rng.integers(0, 24)))
                     for _ in range(int(rng.integers(0, 4))))
    raise AssertionError(kind)


def seeded_pair(msg_type, seed):
    """(reference message, port message, request id) with seeded fields."""
    rng = np.random.default_rng(seed * 1000 + msg_type)
    ref_cls = jp.MESSAGE_TYPES[msg_type]
    fields = {name: _value(rng, kind) for name, kind in ref_cls.FIELDS}
    rid = int(rng.integers(0, 1 << 63))
    return ref_cls(**fields), tp.MESSAGE_TYPES[msg_type](**fields), rid


@pytest.mark.parametrize("msg_type", sorted(jp.MESSAGE_TYPES))
def test_seeded_messages_cross_encode(msg_type):
    for seed in range(4):
        jmsg, tmsg, rid = seeded_pair(msg_type, seed)
        jb, tb = jp.encode_frame(jmsg, rid), tp.encode_frame(tmsg, rid)
        assert tb == jb
        got, got_rid, end = tp.decode_frame(jb)
        assert (got, got_rid, end) == (tmsg, rid, len(jb))
        back, back_rid, _ = jp.decode_frame(tb)
        assert (back, back_rid) == (jmsg, rid)


def test_concatenated_frames_decode_in_sequence():
    msgs = [(to_port(m), rid) for _, m, rid in GOLDEN]
    stream = b"".join(tp.encode_frame(m, rid) for m, rid in msgs)
    assert stream == b"".join(jp.encode_frame(m, rid) for _, m, rid in GOLDEN)
    off = 0
    for msg, rid in msgs:
        got, got_rid, off = tp.decode_frame(stream, off)
        assert (got, got_rid) == (msg, rid)
    assert off == len(stream)


# --------------------------------------------------------------------------- #
# rejections: the reference suite's cases against the port
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", NAMES)
def test_every_truncation_point_is_rejected(name):
    msg, rid = port_golden(name)
    frame = tp.encode_frame(msg, rid)
    for cut in range(len(frame)):
        with pytest.raises(tp.ProtocolError):
            tp.decode_frame(frame[:cut])
        with pytest.raises(jp.ProtocolError):
            jp.decode_frame(frame[:cut])


@pytest.mark.parametrize("name", NAMES)
def test_single_bit_flips_are_rejected(name):
    msg, rid = port_golden(name)
    frame = tp.encode_frame(msg, rid)
    rng = np.random.default_rng(NAMES.index(name))
    for bit in rng.integers(0, len(frame) * 8, 12):
        bad = bytearray(frame)
        bad[bit // 8] ^= 1 << (bit % 8)
        with pytest.raises(tp.ProtocolError):
            tp.decode_frame(bytes(bad))


@pytest.mark.parametrize("extra", [1, 7, 64])
def test_appended_garbage_is_not_consumed(extra):
    for name in NAMES:
        msg, rid = port_golden(name)
        frame = tp.encode_frame(msg, rid)
        data = frame + bytes((extra * 37 + i) % 251 for i in range(extra))
        got, got_rid, end = tp.decode_frame(data)
        assert (got, got_rid, end) == (msg, rid, len(frame))
        with pytest.raises(tp.ProtocolError):
            tp.decode_frame(data, end)


def _signed(body: bytes) -> bytes:
    return body + struct.pack("<Q", thashing.digest_bytes(body))


def test_trailing_garbage_inside_payload_rejected():
    payload = tp.CursorAck(t=5).encode_payload() + b"\x00"
    head = (tp.MAGIC + struct.pack("<II", tp.WIRE_FORMAT, tp.CURSOR_ACK)
            + struct.pack("<QI", 1, len(payload)))
    frame = _signed(head + payload)
    with pytest.raises(tp.ProtocolError, match="trailing garbage"):
        tp.decode_frame(frame)
    with pytest.raises(jp.ProtocolError, match="trailing garbage"):
        jp.decode_frame(frame)


def test_unknown_message_type_rejected():
    frame = _signed(tp.MAGIC + struct.pack("<II", tp.WIRE_FORMAT, 200)
                    + struct.pack("<QI", 1, 0))
    with pytest.raises(tp.ProtocolError, match="unknown message type"):
        tp.decode_frame(frame)


def test_bad_magic_and_format_rejected():
    frame = tp.encode_frame(tp.Cursor(), 1)
    with pytest.raises(tp.ProtocolError, match="magic"):
        tp.frame_length(b"XXXX" + frame[4:tp.HEADER_BYTES])
    bad_fmt = frame[:4] + (99).to_bytes(4, "little") + frame[8:]
    with pytest.raises(tp.ProtocolError, match="wire format"):
        tp.frame_length(bad_fmt[:tp.HEADER_BYTES])
    with pytest.raises(tp.ProtocolError, match="short frame header"):
        tp.frame_length(b"VWIR")


def test_invalid_utf8_string_rejected():
    frame = bytearray(tp.encode_frame(tp.ErrorMsg(kind="E", message="x"), 1))
    idx = tp.HEADER_BYTES + 4
    assert frame[idx:idx + 1] == b"E"
    frame[idx] = 0xFF
    frame = _signed(bytes(frame[:-tp.DIGEST_BYTES]))
    with pytest.raises(tp.ProtocolError, match="utf8"):
        tp.decode_frame(frame)


@pytest.mark.parametrize("kind", ["ValueError", "KeyError", "RuntimeError",
                                  "StaleEpochError", "ProtocolError"])
def test_error_kinds_cross_the_wire(kind):
    """A reference host's ERROR frame becomes the port's RemoteError of the
    same kind, and the other way round."""
    jframe = jp.encode_frame(jp.ErrorMsg(kind=kind, message="refused m"), 9)
    msg, rid, _ = tp.decode_frame(jframe)
    with pytest.raises(tp.RemoteError) as ei:
        tp.raise_if_error(msg)
    assert (ei.value.kind, ei.value.remote_message, rid) == \
        (kind, "refused m", 9)
    assert isinstance(ei.value, ValueError)
    tmsg, _, _ = jp.decode_frame(tp.encode_frame(msg, 9))
    with pytest.raises(jp.RemoteError) as ej:
        jp.raise_if_error(tmsg)
    assert str(ej.value) == str(ei.value)


def test_expect_and_exception_families():
    with pytest.raises(tp.RemoteError) as ei:
        tp.expect(tp.ErrorMsg(kind="KeyError", message="no snapshot at 7"),
                  tp.CursorAck)
    assert ei.value.kind == "KeyError" and "no snapshot at 7" in str(ei.value)
    with pytest.raises(tp.ProtocolError, match="expected AppendAck"):
        tp.expect(tp.CursorAck(t=1), tp.AppendAck)
    assert tp.expect(tp.CursorAck(t=1), tp.CursorAck) == tp.CursorAck(t=1)
    assert issubclass(tp.TransportError, OSError)
    for cls in (tp.RemoteError, tp.ProtocolError, tp.StaleEpochError):
        assert issubclass(cls, ValueError)
