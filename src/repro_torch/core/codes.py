"""Deterministic compressed vector tier: int8 codes over Q16.16 rows.

The port of ``repro.core.codes`` (DESIGN.md §10). The code table is a pure
integer function of the live rows, so it is replay-invariant state, not a
cache: the same live content gives the same codes, bit for bit, on every
device and in both packages.

Per-dimension integer scalar quantization:

    offset_j = ((lo_j + hi_j) >> 1 >> e_j) << e_j      (multiple of scale_j)
    scale_j  = 2^e_j,  e_j = smallest e with 127 * 2^e >= dev_j
    code_ij  = clip(round_nearest((raw_ij - offset_j) / scale_j), -127, 127)

with lo/hi the per-dim min/max over live rows and dev_j the max deviation
from the midpoint. Every step keeps the reference's dtypes (the int32
wraparound of ``hi - mid`` at the contract extremes included); dead rows
encode as all-zero codes with zero norms.

``refresh`` maintains the table incrementally (only the touched rows
re-encode while the power-of-two params hold, a full ``build`` when they
drift), ``query_weights`` gives the int32 weights of the coarse scan
(``kernels/qcoarse``), and the table rides the chunked v2 snapshot format
as a VLRQ manifest. Every function runs on the tensors' own device.
"""
from __future__ import annotations

import dataclasses
import io
import struct
from typing import Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import fixedpoint as fp
from repro_torch.core import hashing, machine
from repro_torch.core import snapshot as snap
from repro_torch.core.state import MemoryState, resolve_device

# smallest e with 127 * 2^e >= dev, searched over e in [0, MAX_EXP)
MAX_EXP = 16
# |query weight| bound for boundary-normalized inputs (kernel exactness)
W_BOUND = 1 << 28

METRIC_L2 = "l2"
METRIC_DOT = "dot"

# rows encoded per step: the int64 temporaries of one step stay near
# 0.6 GB at d = 2304 (encoding is element-local, so the values do not
# depend on the step)
_ENCODE_ROWS = 1 << 15


@dataclasses.dataclass(frozen=True)
class CodeTable:
    """The compressed tier. Invariant: ``table == build(state)``. Field
    order is the reference's, which is the hash order."""
    codes: torch.Tensor    # [capacity, dim] int8; dead rows all-zero
    offset: torch.Tensor   # [dim] int32, a multiple of scale
    scale: torch.Tensor    # [dim] int32, a power of two >= 1
    norms: torch.Tensor    # [capacity] int64: sum_j (codes*scale)^2; dead 0


# --------------------------------------------------------------------------- #
# params + encoding: integer-only, pure in the live rows
# --------------------------------------------------------------------------- #


def code_params(vectors: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dim (offset int32, scale int32) from the live rows only."""
    v = vectors.to(torch.int32)
    live = valid[:, None]
    big = 2**31 - 1
    lo = torch.where(live, v, big).min(dim=0).values
    hi = torch.where(live, v, -big).max(dim=0).values
    has = valid.any()
    lo = torch.where(has, lo, 0)
    hi = torch.where(has, hi, 0)
    # midpoint in int64: lo+hi can overflow int32 at the contract extremes
    mid = ((lo.to(torch.int64) + hi.to(torch.int64)) >> 1).to(torch.int32)
    dev = torch.maximum(hi - mid, mid - lo)                    # int32, wraps
    need = torch.div(dev + 126, 127, rounding_mode="floor")    # ceil(dev/127)
    powers = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=v.device),
        torch.arange(MAX_EXP, dtype=torch.int32, device=v.device))
    e = torch.sum(powers[None, :] < need[:, None], dim=1).to(torch.int32)
    one = torch.ones_like(e)
    scale = torch.bitwise_left_shift(one, e)
    # bucket the offset to a multiple of scale (arithmetic shifts on int32)
    offset = torch.bitwise_left_shift(torch.bitwise_right_shift(mid, e), e)
    return offset, scale


def _encode_block(vectors: torch.Tensor, valid: torch.Tensor,
                  offset: torch.Tensor, scale: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    v = vectors.to(torch.int64)
    sc = scale.to(torch.int64)[None, :]
    delta = v - offset.to(torch.int64)[None, :]
    c = fp._int_div_round_to_nearest(delta, sc)
    c = torch.clamp(c, -127, 127)
    c = torch.where(valid[:, None], c, 0).to(torch.int8)
    deq = c.to(torch.int64) * sc
    norms = torch.where(valid, torch.sum(deq * deq, dim=-1), 0)
    return c, norms


def encode_rows(vectors: torch.Tensor, valid: torch.Tensor,
                offset: torch.Tensor, scale: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 [n, dim], norms int64 [n]) for rows under fixed params.

    Element-local: code_ij depends only on (raw_ij, valid_i, offset_j,
    scale_j), so the rows are encoded in steps of ``_ENCODE_ROWS``."""
    n = vectors.shape[0]
    if n <= _ENCODE_ROWS:
        return _encode_block(vectors, valid, offset, scale)
    codes = torch.empty(vectors.shape, dtype=torch.int8, device=vectors.device)
    norms = torch.empty((n,), dtype=torch.int64, device=vectors.device)
    for a in range(0, n, _ENCODE_ROWS):
        b = min(a + _ENCODE_ROWS, n)
        codes[a:b], norms[a:b] = _encode_block(vectors[a:b], valid[a:b],
                                               offset, scale)
    return codes, norms


def _build_with(state: MemoryState, offset: torch.Tensor,
                scale: torch.Tensor) -> CodeTable:
    c, norms = encode_rows(state.vectors, state.valid, offset, scale)
    return CodeTable(codes=c, offset=offset, scale=scale, norms=norms)


def build(state: MemoryState) -> CodeTable:
    """The reference constructor: the whole table from the live rows."""
    return _build_with(state, *code_params(state.vectors, state.valid))


def refresh(table: CodeTable, state: MemoryState, touched_slots) -> CodeTable:
    """Incremental maintenance: bit-identical to ``build(state)`` given
    ``touched_slots`` covers every slot whose (vector, valid) changed.

    The params are recomputed and compared on the host; while they hold,
    only the touched rows re-encode, and a drift re-encodes everything,
    which is exactly ``build``. The table is not modified in place."""
    offset, scale = code_params(state.vectors, state.valid)
    if bool(obs.host_item(torch.any(offset != table.offset))) \
            or bool(obs.host_item(torch.any(scale != table.scale))):
        return _build_with(state, offset, scale)
    t = torch.as_tensor(touched_slots).to(device=state.device,
                                          dtype=torch.int64).reshape(-1)
    if t.numel() == 0:
        return table
    c_sub, n_sub = encode_rows(state.vectors[t], state.valid[t],
                               table.offset, table.scale)
    codes = table.codes.clone()
    codes[t] = c_sub
    norms = table.norms.clone()
    norms[t] = n_sub
    return CodeTable(codes=codes, offset=table.offset, scale=table.scale,
                     norms=norms)


def diff_slots(prev: MemoryState, cur: MemoryState) -> torch.Tensor:
    """Slots whose (vector, valid) changed between two states (int32, on
    the states' device): the touched set a generic log must refresh."""
    changed = torch.any(prev.vectors != cur.vectors, dim=-1)
    changed |= prev.valid != cur.valid
    return torch.nonzero(changed).reshape(-1).to(torch.int32)


def apply_with_codes(state: MemoryState, table: CodeTable, log, *,
                     ef_construction: int = 32
                     ) -> Tuple[MemoryState, CodeTable]:
    """``machine.bulk_apply`` plus table maintenance in one step."""
    new_state = machine.bulk_apply(state, log, ef_construction=ef_construction)
    return new_state, refresh(table, new_state, diff_slots(state, new_state))


# --------------------------------------------------------------------------- #
# query-side weights for the coarse scan
# --------------------------------------------------------------------------- #


def query_weights(queries_raw: torch.Tensor, table: CodeTable, metric: str
                  ) -> torch.Tensor:
    """int32 weights w [nq, dim] such that ranking by the integer dot
    ``S_i = sum_j w_j * codes_ij`` (plus the row norms for L2) orders rows
    by their metric against the dequantized vectors:

      l2 : w_j = (q_j - offset_j) * scale_j
      dot: w_j = q_j * scale_j

    Computed in int64 then clipped to +-W_BOUND so the qcoarse limb planes
    stay int32-exact."""
    q = queries_raw.to(torch.int64)
    s = table.scale.to(torch.int64)[None, :]
    if metric == METRIC_L2:
        w = (q - table.offset.to(torch.int64)[None, :]) * s
    elif metric == METRIC_DOT:
        w = q * s
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.clamp(w, -W_BOUND, W_BOUND).to(torch.int32)


def table_hash(table: CodeTable) -> int:
    """Platform-invariant hash of the table (``hash_pytree`` of its four
    leaves), computed on the table's device."""
    return hashing.hash_state_device(table)


# --------------------------------------------------------------------------- #
# durability: the table rides the chunked v2 snapshot format
# --------------------------------------------------------------------------- #

MAGIC_CODES = b"VLRQ"
_FORMAT_VERSION = 1
_U64 = (1 << 64) - 1
# fixed leaf order + dtypes: the restore refuses anything that isn't
# exactly a CodeTable
_LEAVES = (("codes", np.int8), ("offset", np.int32),
           ("scale", np.int32), ("norms", np.int64))


def snapshot_table_v2(table: CodeTable, cursor: int, store, *,
                      chunk_size: int = 8192) -> Tuple[bytes, dict]:
    """Write the table's chunks into a ``snapshot.ChunkStore`` and return
    (manifest bytes, stats), byte-identical to the reference's manifest."""
    store.reset_stats()
    buf = io.BytesIO()
    buf.write(MAGIC_CODES)
    buf.write(struct.pack("<I", _FORMAT_VERSION))
    buf.write(struct.pack("<Q", int(cursor) & _U64))
    buf.write(struct.pack("<I", chunk_size))
    buf.write(struct.pack("<I", len(_LEAVES)))
    total = 0
    for name, dtype in _LEAVES:
        arr = np.asarray(getattr(table, name).detach().cpu().numpy(),
                         dtype=dtype)
        payload = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        total += len(payload)
        snap._write_str(buf, name)
        buf.write(struct.pack("<I", arr.ndim))
        for d in arr.shape:
            buf.write(struct.pack("<Q", d))
        keys = snap.put_chunks(store, payload, chunk_size)
        buf.write(struct.pack("<Q", len(payload)))
        buf.write(struct.pack("<I", len(keys)))
        for key in keys:
            buf.write(struct.pack("<Q", key))
    buf.write(struct.pack("<Q", table_hash(table)))
    stats = {"chunks": store.puts, "chunks_written": store.writes,
             "bytes_written": store.bytes_written, "bytes_total": total,
             "manifest_bytes": buf.tell()}
    return buf.getvalue(), stats


def restore_table_v2(data: bytes, store, *, device=None
                     ) -> Tuple[CodeTable, int]:
    """Reassemble a table manifest against its chunk store onto ``device``
    (``cuda`` when None); every chunk's content hash and the whole-table
    hash are verified. Returns (table, cursor)."""
    dev = resolve_device(device)
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC_CODES:
        raise ValueError("not a Valori code-table manifest")
    (ver,) = struct.unpack("<I", buf.read(4))
    if ver != _FORMAT_VERSION:
        raise ValueError(f"unsupported code-table format {ver}")
    (cursor,) = struct.unpack("<Q", buf.read(8))
    buf.read(4)  # chunk_size: recorded for tooling; lengths self-describe
    (n_leaves,) = struct.unpack("<I", buf.read(4))
    if n_leaves != len(_LEAVES):
        raise ValueError(f"code-table manifest has {n_leaves} leaves")
    arrays = {}
    for name, dtype in _LEAVES:
        got = snap._read_str(buf)
        if got != name:
            raise ValueError(f"leaf {got!r} where {name!r} expected")
        (ndim,) = struct.unpack("<I", buf.read(4))
        shape = tuple(struct.unpack("<Q", buf.read(8))[0]
                      for _ in range(ndim))
        (nbytes,) = struct.unpack("<Q", buf.read(8))
        (n_chunks,) = struct.unpack("<I", buf.read(4))
        parts = [store.get(struct.unpack("<Q", buf.read(8))[0])
                 for _ in range(n_chunks)]
        payload = b"".join(parts)
        if len(payload) != nbytes:
            raise ValueError(f"leaf {name}: got {len(payload)} bytes, "
                             f"manifest says {nbytes}")
        arr = np.frombuffer(payload, dtype=np.dtype(dtype).newbyteorder("<"))
        arrays[name] = torch.from_numpy(
            arr.astype(dtype).reshape(shape)).to(dev)
    (stored_hash,) = struct.unpack("<Q", buf.read(8))
    table = CodeTable(**arrays)
    actual = table_hash(table)
    if actual != stored_hash:
        raise ValueError(f"code-table hash mismatch: stored "
                         f"{stored_hash:#x}, got {actual:#x}")
    return table, cursor


def table_manifest_cursor(data: bytes) -> int:
    if data[:4] != MAGIC_CODES:
        raise ValueError("not a Valori code-table manifest")
    (cursor,) = struct.unpack("<Q", data[8:16])
    return cursor


def table_manifest_chunk_keys(data: bytes) -> list:
    """All chunk keys a code-table manifest references (retention sweeps)."""
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC_CODES:
        raise ValueError("not a Valori code-table manifest")
    buf.read(16)  # version, cursor, chunk_size
    (n_leaves,) = struct.unpack("<I", buf.read(4))
    keys = []
    for _ in range(n_leaves):
        snap._read_str(buf)
        (ndim,) = struct.unpack("<I", buf.read(4))
        buf.read(8 * ndim + 8)
        (n_chunks,) = struct.unpack("<I", buf.read(4))
        for _ in range(n_chunks):
            (key,) = struct.unpack("<Q", buf.read(8))
            keys.append(key)
    return keys
