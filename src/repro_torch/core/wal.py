"""Segmented write-ahead log for the command stream (DESIGN.md §5).

The port of ``repro.core.wal``. The command log IS the memory (paper
§3.1), so durability means making the log itself durable. This module
persists ``CommandLog`` records in append-only segment files with a
per-segment FNV-1a hash chain, byte for byte in the reference's format
(``docs/wal-format.md``), so a WAL written by either package opens in the
other:

Segment file ``seg_<base_t:020d>.wal`` (all little-endian):

  header:  magic 'VWSG' | u32 fmt=1 | u32 dim | u32 vec-itemsize
           | u64 base_t (logical index of the first command in the file)
           | str contract (u32 len + utf8)
           | u64 chain_0 = FNV-1a(header bytes)      — seeds the chain
  record:  u32 storage-op | i64 arg0 | i64 arg1 | i64 arg2
           | vec payload (dim * itemsize bytes, INSERT records only)
           | u64 chain_i = (chain_{i-1} ^ digest(record bytes)) * FNV_PRIME

Storage ops are the machine opcodes (0..5) plus ``NOP_RUN`` (0xFFFFFFFE):
a run of k zero-argument NOPs as one record with arg0 = k. Non-INSERT
records carry no vector payload (F never reads ``vec`` outside INSERT), so
read-back canonicalizes those payloads to zero.

Crash safety: a torn write leaves a partial record or a record whose chain
word no longer matches; on open the longest valid record prefix is kept
and the torn tail truncated in place. Group commit (``append_many`` /
``GroupCommitWriter``) batches logs under one fsync with the same
record-granular torn-tail contract. ``compact_log`` rewrites provably-dead
commands as NOPs while keeping the log's length, under the bit-exact
contract ``hash(bulk_apply(genesis, compact(log))) == hash(replay(genesis,
log))``.

Records are encoded and decoded on the host: an append from a card-resident
log copies it to the host once, and ``read_range`` puts the decoded log on
the device the caller names (``cuda`` when None).
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import pathlib
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.commands import (DELETE, INSERT, LINK, NOP, SET_META,
                                       UNLINK, CommandLog, log_from_numpy,
                                       log_to_numpy)
from repro_torch.core.contracts import (DEFAULT_CONTRACT, PrecisionContract,
                                        get_contract)
from repro_torch.core.state import MemoryState

SEGMENT_MAGIC = b"VWSG"
SEGMENT_FORMAT = 1
NOP_RUN = 0xFFFFFFFE  # storage-only opcode: arg0 zero-NOPs in one record

_U64 = (1 << 64) - 1


_fnv1a = hashing._fnv1a_bytes  # header hashing (small payloads)


def _chain_step(chain: int, body: bytes) -> int:
    """One FNV-1a step over the record's word digest."""
    return ((chain ^ hashing.digest_bytes(body)) * hashing.FNV_PRIME) & _U64


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


# --------------------------------------------------------------------------- #
# durability policies (DESIGN.md §6)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class GroupCommitPolicy:
    """When a ``GroupCommitWriter`` flushes its pending group: once
    ``max_batch`` commands are pending, or once the oldest has waited
    ``max_delay_s`` (checked at ``submit``/``flush``; with ``timer_flush``
    also by a daemon thread, so the delay holds as a wall-clock bound)."""
    max_batch: int = 64
    max_delay_s: float = 0.010
    timer_flush: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When scheduled compaction rewrites the WAL: every ``check_every``
    appended commands, once the log holds ``min_commands``, the dead ratio
    is measured with one host mirror pass, and the rewrite runs only when
    folded / n reaches ``dead_ratio``."""
    dead_ratio: float = 0.5
    min_commands: int = 1024
    check_every: int = 1024

    def __post_init__(self):
        if not 0.0 < self.dead_ratio <= 1.0:
            raise ValueError("dead_ratio must be in (0, 1]")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")


# --------------------------------------------------------------------------- #
# segment encode / decode
# --------------------------------------------------------------------------- #


def _segment_header(dim: int, itemsize: int, base_t: int,
                    contract_name: str) -> bytes:
    hdr = (SEGMENT_MAGIC + struct.pack("<III", SEGMENT_FORMAT, dim, itemsize)
           + struct.pack("<Q", base_t) + _pack_str(contract_name))
    return hdr + struct.pack("<Q", _fnv1a(hdr))


def _encode_record(op: int, a0: int, a1: int, a2: int,
                   vec_bytes: bytes, chain: int) -> Tuple[bytes, int]:
    body = struct.pack("<Iqqq", op, a0, a1, a2)
    if op == INSERT:
        body += vec_bytes
    chain = _chain_step(chain, body)
    return body + struct.pack("<Q", chain), chain


@dataclasses.dataclass
class _SegmentData:
    base_t: int
    n_commands: int          # logical commands (NOP runs expanded)
    clean: bool              # chain verified through EOF
    valid_bytes: int         # offset of the last valid record boundary
    chain: int               # chain value at the last valid record
    contract_name: str       # precision contract recorded in the header
    fields: Dict[str, np.ndarray]  # opcode/arg0/arg1/arg2/vec, expanded
    header_bytes: int        # byte offset where records start
    bounds: List[Tuple[int, int]]  # per record: (offset after, cum commands)


def _read_segment(path: pathlib.Path, *, strict: bool = True,
                  expect_dim: Optional[int] = None) -> _SegmentData:
    data = path.read_bytes()

    def fail(msg):
        raise ValueError(f"{path.name}: {msg}")

    if data[:4] != SEGMENT_MAGIC:
        fail("not a WAL segment")
    fmt, dim, itemsize = struct.unpack_from("<III", data, 4)
    if fmt != SEGMENT_FORMAT:
        fail(f"unsupported WAL format {fmt}")
    off = 16
    (base_t,) = struct.unpack_from("<Q", data, off)
    off += 8
    (n,) = struct.unpack_from("<I", data, off)
    contract_name = data[off + 4:off + 4 + n].decode()
    off += 4 + n
    get_contract(contract_name)  # validates
    if expect_dim is not None and dim != expect_dim:
        fail(f"dim mismatch: segment {dim}, expected {expect_dim}")
    (chain,) = struct.unpack_from("<Q", data, off)
    if chain != _fnv1a(data[:off]):
        fail("corrupt segment header")
    off += 8

    vec_nbytes = dim * itemsize
    header_bytes = off
    bounds: List[Tuple[int, int]] = []
    ops: List[int] = []
    a0s: List[int] = []
    a1s: List[int] = []
    a2s: List[int] = []
    vecs: List[Tuple[int, bytes]] = []  # (record index, payload) sparse
    clean = True
    valid_bytes = off
    n_commands = 0
    while off < len(data):
        if off + 28 + 8 > len(data):
            clean = False
            break
        op, a0, a1, a2 = struct.unpack_from("<Iqqq", data, off)
        body_len = 28 + (vec_nbytes if op == INSERT else 0)
        if off + body_len + 8 > len(data):
            clean = False
            break
        body = data[off:off + body_len]
        (stored,) = struct.unpack_from("<Q", data, off + body_len)
        next_chain = _chain_step(chain, body)
        if stored != next_chain:
            clean = False
            break
        chain = next_chain
        off += body_len + 8
        valid_bytes = off
        if op == NOP_RUN:
            if a0 < 0:
                clean = False
                valid_bytes -= body_len + 8
                break
            ops.extend([NOP] * a0)
            a0s.extend([0] * a0)
            a1s.extend([0] * a0)
            a2s.extend([0] * a0)
            n_commands += int(a0)
        else:
            if op == INSERT:
                vecs.append((len(ops), body[28:]))
            ops.append(op)
            a0s.append(a0)
            a1s.append(a1)
            a2s.append(a2)
            n_commands += 1
        bounds.append((off, n_commands))
    if strict and not clean:
        fail(f"torn/corrupt record at byte {valid_bytes}")

    vdt = np.dtype(f"<i{itemsize}")
    vec = np.zeros((n_commands, dim), vdt)
    for idx, payload in vecs:
        vec[idx] = np.frombuffer(payload, dtype=vdt)
    fields = dict(
        opcode=np.asarray(ops, np.int32), arg0=np.asarray(a0s, np.int64),
        arg1=np.asarray(a1s, np.int64), arg2=np.asarray(a2s, np.int64),
        vec=vec,
    )
    return _SegmentData(base_t=base_t, n_commands=n_commands, clean=clean,
                        valid_bytes=valid_bytes, chain=chain,
                        contract_name=contract_name, fields=fields,
                        header_bytes=header_bytes, bounds=bounds)


def _zero_fields(n: int, dim: int, contract: PrecisionContract
                 ) -> Dict[str, np.ndarray]:
    """The fields of n zero-argument NOPs."""
    return dict(
        opcode=np.zeros((n,), np.int32), arg0=np.zeros((n,), np.int64),
        arg1=np.zeros((n,), np.int64), arg2=np.zeros((n,), np.int64),
        vec=np.zeros((n, dim), contract.np_storage_dtype))


# --------------------------------------------------------------------------- #
# the WAL
# --------------------------------------------------------------------------- #


class WriteAheadLog:
    """Append-only, segmented, hash-chained command log on disk.

    ``t`` is the monotone applied-command cursor: the logical index of the
    next command to be appended. ``read_range(t0, t1)`` returns the commands
    [t0, t1) as a ``CommandLog``; replaying a round-tripped range is
    bit-identical to replaying the original commands.
    """

    def __init__(self, directory: str | os.PathLike, dim: Optional[int] = None,
                 contract: Optional[PrecisionContract] = None, *,
                 segment_records: int = 1024):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.contract = contract  # None ⇒ adopt from segment headers
        self.segment_records = segment_records
        self.torn_tail_dropped = 0  # bytes truncated from a torn tail on open

        self._repair_interrupted_compaction()
        for stale in self.dir.glob("*.tmp"):  # stillborn segment creations
            if stale.is_file():
                stale.unlink()

        self._segments: List[Tuple[int, pathlib.Path, int]] = []  # (base, path, n)
        paths = sorted(self.dir.glob("seg_*.wal"))
        self._dim = dim
        tail_seg: Optional[_SegmentData] = None
        for i, p in enumerate(paths):
            last = i == len(paths) - 1
            if last:
                try:
                    seg = _read_segment(p, strict=False)
                except (ValueError, struct.error):  # short header ⇒ struct
                    # stillborn tail: the crash tore the header itself.
                    # Headers are fsynced at creation before any record can
                    # be appended, so an unreadable header implies zero
                    # durable records — dropping the file loses nothing.
                    self.torn_tail_dropped += p.stat().st_size
                    p.unlink()
                    continue
                if (self._dim is not None
                        and seg.fields["vec"].shape[1] != self._dim):
                    raise ValueError(
                        f"{p.name}: dim {seg.fields['vec'].shape[1]} != "
                        f"expected {self._dim}")
            else:
                seg = _read_segment(p, strict=True, expect_dim=self._dim)
            if self._dim is None:
                self._dim = seg.fields["vec"].shape[1]
            # the header is authoritative for the storage contract: reopening
            # with a mismatched (or defaulted) contract would wrap-cast
            # read_range payloads into the wrong dtype with no error
            hdr_contract = get_contract(seg.contract_name)
            if self.contract is None:
                self.contract = hdr_contract
            elif self.contract.name != hdr_contract.name:
                raise ValueError(
                    f"{p.name}: segment contract {hdr_contract.name!r} != "
                    f"given contract {self.contract.name!r}")
            if not seg.clean:
                # torn tail: truncate to the longest valid record prefix so
                # future appends extend a verified chain
                self.torn_tail_dropped += p.stat().st_size - seg.valid_bytes
                with open(p, "r+b") as f:
                    f.truncate(seg.valid_bytes)
                    f.flush()
                    os.fsync(f.fileno())
            self._segments.append((seg.base_t, p, seg.n_commands))
            if last:
                tail_seg = seg
        if self._dim is None:
            raise ValueError("empty WAL directory needs an explicit dim")
        if self.contract is None:  # fresh, empty WAL with no override
            self.contract = DEFAULT_CONTRACT
        self._last_compact_check = 0  # cursor at the last policy check

        if self._segments:
            if tail_seg is None:  # stillborn tail was dropped: the previous
                tail_seg = _read_segment(  # segment is the live tail now
                    self._segments[-1][1], strict=True, expect_dim=self._dim)
            base, _, n = self._segments[-1]
            self.t = base + n
            self._chain = tail_seg.chain
            self._cur_records = n
        else:
            self.t = 0
            self._chain = None   # set when the first segment is created
            self._cur_records = 0

    # ------------------------------------------------------------------ #
    @property
    def dim(self) -> int:
        return self._dim

    def segments(self) -> List[Tuple[int, int]]:
        """[(base_t, n_commands)] in order."""
        return [(b, n) for b, _, n in self._segments]

    def _itemsize(self) -> int:
        return self.contract.np_storage_dtype.itemsize

    def _open_segment(self) -> None:
        path = self.dir / f"seg_{self.t:020d}.wal"
        hdr = _segment_header(self._dim, self._itemsize(), self.t,
                              self.contract.name)
        tmp = path.with_suffix(".wal.tmp")
        with open(tmp, "wb") as f:  # fsync+rename: a crash can leave a
            f.write(hdr)            # stale .tmp (ignored on open), never a
            f.flush()               # torn header at the live name
            os.fsync(f.fileno())
        tmp.rename(path)
        self._chain = _fnv1a(hdr[:-8])
        self._segments.append((self.t, path, 0))
        self._cur_records = 0

    # ------------------------------------------------------------------ #
    def _validated_fields(self, log: CommandLog) -> Tuple[np.ndarray, ...]:
        arrays = log_to_numpy(log)  # one copy to the host per field
        vec = arrays["vec"]
        if vec.shape[1] != self._dim:
            raise ValueError(f"log dim {vec.shape[1]} != WAL dim {self._dim}")
        expected = self.contract.np_storage_dtype
        if vec.dtype != expected:
            # a mismatched itemsize would desync record framing — every
            # later record would read as torn and be silently discarded
            raise ValueError(
                f"log vec dtype {vec.dtype} != WAL storage dtype {expected}")
        return (arrays["opcode"], arrays["arg0"], arrays["arg1"],
                arrays["arg2"], vec)

    def append(self, log: CommandLog) -> int:
        """Durably append a command log; returns the new cursor ``t``.

        Invariant: on return every record is fsynced, so a crash can only
        lose commands the caller was never acked for. One fsync per touched
        segment."""
        if len(log) == 0:
            return self.t
        return self._append_fields(*self._validated_fields(log))

    def append_many(self, logs: Sequence[CommandLog]) -> int:
        """Group commit: durably append several command logs with a single
        fsync per touched segment (usually exactly one). Returns the new
        cursor ``t``. The torn-tail contract is unchanged and record-
        granular: a crash inside the group's write leaves the longest valid
        record prefix, possibly a partial group."""
        logs = [log for log in logs if len(log)]
        if not logs:
            return self.t
        fields = [self._validated_fields(log) for log in logs]
        # NOP runs must not merge across log boundaries: each log's records
        # are encoded exactly as a lone append would encode them, so the
        # grouped segment bytes equal the ungrouped ones
        breaks, acc = set(), 0
        for f in fields[:-1]:
            acc += len(f[0])
            breaks.add(acc)
        return self._append_fields(
            *(np.concatenate([f[j] for f in fields]) for j in range(5)),
            run_breaks=frozenset(breaks))

    def _append_fields(self, opcode, arg0, arg1, arg2, vec, *,
                       run_breaks: frozenset = frozenset()) -> int:
        n = len(opcode)
        vdt = vec.dtype.newbyteorder("<")

        i = 0
        while i < n:
            if self._chain is None or self._cur_records >= self.segment_records:
                self._open_segment()
            room = self.segment_records - self._cur_records
            stop = min(n, i + room)
            buf = bytearray()
            chain = self._chain
            wrote = 0
            while i < stop:
                op = int(opcode[i])
                if (op == NOP and arg0[i] == 0 and arg1[i] == 0
                        and arg2[i] == 0):
                    j = i
                    while (j < stop and opcode[j] == NOP and arg0[j] == 0
                           and arg1[j] == 0 and arg2[j] == 0
                           and (j == i or j not in run_breaks)):
                        j += 1
                    rec, chain = _encode_record(NOP_RUN, j - i, 0, 0, b"",
                                                chain)
                    wrote += j - i
                    i = j
                else:
                    vb = vec[i].astype(vdt, copy=False).tobytes() \
                        if op == INSERT else b""
                    rec, chain = _encode_record(op, int(arg0[i]), int(arg1[i]),
                                                int(arg2[i]), vb, chain)
                    wrote += 1
                    i += 1
                buf += rec
            base, path, cnt = self._segments[-1]
            with open(path, "ab") as f:
                f.write(bytes(buf))
                f.flush()
                os.fsync(f.fileno())
            self._chain = chain
            self._cur_records = cnt + wrote
            self._segments[-1] = (base, path, self._cur_records)
            self.t += wrote
        return self.t

    # ------------------------------------------------------------------ #
    def read_range(self, t0: int, t1: int, *, device=None) -> CommandLog:
        """Commands [t0, t1) as a CommandLog on ``device`` (``cuda`` when
        None); strict: every chain word must verify."""
        if not 0 <= t0 <= t1 <= self.t:
            raise ValueError(f"range [{t0}, {t1}) outside WAL [0, {self.t})")
        parts = []
        cover = t0
        for base, path, cnt in self._segments:
            if base + cnt <= t0 or base >= t1:
                continue
            if base > cover:
                raise ValueError(
                    f"WAL gap at [{cover}, {base}): that history was "
                    "dropped by retention or lost to a torn tail")
            seg = _read_segment(path, strict=True, expect_dim=self._dim)
            lo = max(t0 - base, 0)
            hi = min(t1 - base, cnt)
            parts.append({k: v[lo:hi] for k, v in seg.fields.items()})
            cover = base + cnt
        if cover < t1:
            raise ValueError(
                f"WAL gap at [{cover}, {t1}): that history was dropped by "
                "retention or lost to a torn tail")
        if not parts:
            parts = [_zero_fields(0, self._dim, self.contract)]
        cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        return log_from_numpy(cat, self.contract, device=device)

    def tail(self, t0: int, max_commands: int = 0, *, device=None
             ) -> Tuple[CommandLog, int]:
        """Stream the durable tail from ``t0``: the commands [t0, t_end)
        with ``t_end = min(t, t0 + max_commands)`` (``max_commands=0``
        means everything durable). Returns (log, t_end)."""
        if not 0 <= t0 <= self.t:
            raise ValueError(f"tail from t={t0} outside WAL [0, {self.t}]")
        t_end = self.t if max_commands <= 0 \
            else min(self.t, t0 + max_commands)
        return self.read_range(t0, t_end, device=device), t_end

    # ------------------------------------------------------------------ #
    def drop_below(self, t: int) -> int:
        """Delete whole segments entirely below ``t`` (retention). Returns
        the number of segments removed; partial segments are kept."""
        removed = 0
        keep = []
        for base, path, cnt in self._segments:
            if base + cnt <= t and base + cnt <= self.t:
                path.unlink()
                removed += 1
            else:
                keep.append((base, path, cnt))
        if removed and (not keep
                        or keep[-1][1] != self._segments[-1][1]):
            # the active tail segment itself was dropped: the next append
            # must open a fresh segment at the current cursor, not write
            # into the unlinked file's stale bookkeeping
            self._chain = None
            self._cur_records = 0
        self._segments = keep
        return removed

    def reset_to(self, t: int) -> None:
        """Advance the cursor past a lost region (recovery found a snapshot
        newer than the durable WAL prefix). The gap [self.t, t) becomes a
        permanent hole: ``read_range`` refuses it, and the next append
        opens a fresh segment at base ``t``."""
        if t < self.t:
            raise ValueError(f"cannot reset cursor backwards ({t} < {self.t})")
        if t == self.t:
            return
        self.t = t
        self._chain = None
        self._cur_records = 0

    def truncate_to(self, t: int) -> None:
        """Roll the log back to logical time ``t``: every record at or above
        ``t`` is deleted from disk. A NOP run straddling ``t`` is split: the
        segment is truncated at the record boundary below the run and a
        shorter run is re-appended. Raises if ``t`` falls inside a lost gap
        (reset_to hole): that history cannot be re-entered."""
        if not 0 <= t <= self.t:
            raise ValueError(f"truncate_to({t}) outside WAL [0, {self.t}]")
        if t == self.t:
            return
        # refuse BEFORE deleting anything: t must sit inside or at the end
        # of a live segment (t=0 with no retained prefix is the empty log)
        covered = t == 0 and (not self._segments
                              or self._segments[0][0] == 0)
        covered = covered or any(base <= t <= base + cnt
                                 for base, _, cnt in self._segments)
        if not covered:
            raise ValueError(
                f"truncate_to({t}): t falls inside a lost gap or retained-"
                "away history; that history cannot be re-entered")
        nop_remainder = 0
        for base, path, cnt in list(self._segments):
            if base >= t:
                path.unlink()
            elif base + cnt > t:
                # straddling segment: cut at the last whole-record boundary
                # at/below t, using the framing the verifying parse derived
                seg = _read_segment(path, strict=True, expect_dim=self._dim)
                target = t - base
                cut, cum = seg.header_bytes, 0
                for off_after, cum_after in seg.bounds:
                    if cum_after > target:
                        break  # record straddles t (only a NOP run can)
                    cut, cum = off_after, cum_after
                nop_remainder = target - cum
                with open(path, "r+b") as f:
                    f.truncate(cut)
                    f.flush()
                    os.fsync(f.fileno())
        fresh = WriteAheadLog(self.dir, self._dim, self.contract,
                              segment_records=self.segment_records)
        self.__dict__.update(fresh.__dict__)
        if nop_remainder:
            self.append(log_from_numpy(
                _zero_fields(nop_remainder, self._dim, self.contract),
                self.contract, device="cpu"))
        if self.t < t:
            # coverage was verified before any deletion, so a short cursor
            # here means every segment at/above t was deleted whole and a
            # pre-existing reset_to hole ends at t: preserve the hole
            self.reset_to(t)
        if self.t != t:
            raise RuntimeError(f"truncate_to({t}) landed at {self.t}")

    def _repair_interrupted_compaction(self) -> None:
        """Finish or roll back a compaction the process died inside of. The
        commit marker lists the new segment set and is written (fsynced)
        only after that set is complete in compact.tmp: marker present ⇒
        roll forward, marker absent ⇒ discard the partial build."""
        marker = self.dir / "compact.commit"
        tmp = self.dir / "compact.tmp"
        if marker.exists():
            keep = set(marker.read_text().split())
            for p in self.dir.glob("seg_*.wal"):
                if p.name not in keep:
                    p.unlink()          # old segment superseded by the swap
            if tmp.exists():
                for p in sorted(tmp.glob("seg_*.wal")):
                    os.replace(p, self.dir / p.name)
                for p in tmp.iterdir():
                    p.unlink()
                tmp.rmdir()
            marker.unlink()
        elif tmp.exists():
            for p in tmp.iterdir():
                p.unlink()
            tmp.rmdir()

    def compact(self, genesis: MemoryState, *,
                min_dead_ratio: float = 0.0) -> Dict[str, int]:
        """Rewrite the whole WAL with dead commands folded to NOPs (and NOP
        runs RLE'd on disk); logical time is preserved exactly. Crash-safe:
        the new segment set is built and fsynced aside, committed with a
        marker, then swapped in. Below ``min_dead_ratio`` (or when nothing
        folds) the WAL is left untouched and ``stats["skipped"]`` is 1."""
        if self._segments and self._segments[0][0] != 0:
            raise ValueError("cannot compact a WAL whose head was retained "
                             "away (needs the full history from t=0)")
        raw = self.read_range(0, self.t, device="cpu")  # a host mirror pass
        before = sum(p.stat().st_size for _, p, _ in self._segments)
        compacted, stats = compact_log(genesis, raw)
        stats["dead_ratio"] = stats["folded"] / max(stats["n"], 1)
        if stats["folded"] == 0 or stats["dead_ratio"] < min_dead_ratio:
            stats.update(skipped=1, bytes_before=before, bytes_after=before)
            return stats
        stats["skipped"] = 0

        marker = self.dir / "compact.commit"
        tmp = self.dir / "compact.tmp"
        self._repair_interrupted_compaction()  # clear any previous leftovers
        tmp.mkdir()
        new = WriteAheadLog(tmp, self._dim, self.contract,
                            segment_records=self.segment_records)
        new.append(compacted)
        if new.t != self.t:
            raise RuntimeError("compaction must preserve logical time")
        names = sorted(p.name for p in tmp.glob("seg_*.wal"))
        with open(marker, "wb") as f:  # commit point
            f.write("\n".join(names).encode())
            f.flush()
            os.fsync(f.fileno())
        self._repair_interrupted_compaction()  # roll the swap forward
        fresh = WriteAheadLog(self.dir, self._dim, self.contract,
                              segment_records=self.segment_records)
        self.__dict__.update(fresh.__dict__)
        after = sum(p.stat().st_size for _, p, _ in self._segments)
        stats["bytes_before"] = before
        stats["bytes_after"] = after
        return stats

    def maybe_compact(self, genesis,
                      policy: Optional[CompactionPolicy]
                      ) -> Optional[Dict[str, int]]:
        """Run ``compact`` iff the scheduling policy says it is due. Returns
        the compact stats when a check ran, else None. ``genesis`` may be
        the t=0 state or a zero-arg callable returning it (or None to skip
        the check)."""
        if policy is None:
            return None
        if self.t - self._last_compact_check < policy.check_every:
            return None
        self._last_compact_check = self.t
        if self.t < policy.min_commands:
            return None
        if self._segments and self._segments[0][0] != 0:
            return None  # head retained away: nothing to fold from genesis
        if callable(genesis):
            genesis = genesis()
        if genesis is None:
            return None  # caller could not produce the t=0 state: skip
        stats = self.compact(genesis, min_dead_ratio=policy.dead_ratio)
        self._last_compact_check = self.t  # compact() reloads bookkeeping
        return stats


# --------------------------------------------------------------------------- #
# group commit
# --------------------------------------------------------------------------- #


class GroupCommitWriter:
    """Batches submitted command logs and commits them with one fsync per
    group — the high-QPS ingest path (DESIGN.md §6).

    ``sink`` is anything with ``append_many(logs) -> t`` and a durable
    cursor ``t`` (``WriteAheadLog``, ``durability.DurableStore``,
    ``shard_wal.ShardedDurableStore``). A sink with ``planned_advance``
    (sharded) advances by each batch's NOP-padded common share length, not
    its command count; one with ``append_many_routed`` takes batches the
    caller already routed. ``submit`` buffers a log and flushes when the
    policy's batch or delay bound is hit; ``flush`` forces the pending group durable. With
    ``policy.timer_flush`` a daemon thread flushes when the oldest pending
    command's deadline passes; submits, foreground flushes and timer
    flushes serialize on one lock, so the commit order is the submit order.

    Crash contract: commands in a flushed group are durable before
    ``flush`` returns; commands still pending were never acked."""

    def __init__(self, sink, policy: GroupCommitPolicy = GroupCommitPolicy(),
                 *, pre_flush=None):
        self.sink = sink
        self.policy = policy
        # runs (under the writer lock) immediately before the sink commit of
        # every flush — foreground, policy-driven or timer-driven
        self.pre_flush = pre_flush
        self._pending: List[CommandLog] = []
        self._routed: List[Optional[CommandLog]] = []  # pre-routed shares
        self._advance: List[int] = []  # cursor advance each log will cause
        self._pending_n = 0
        self._oldest: Optional[float] = None
        self.groups = 0        # flushes that wrote something
        self.submitted = 0     # commands ever submitted
        self.timer_flushes = 0  # flushes the deadline thread initiated
        self._cv = threading.Condition(threading.RLock())
        self._closed = False
        self._timer: Optional[threading.Thread] = None
        if policy.timer_flush:
            self._timer = threading.Thread(target=self._timer_loop,
                                           daemon=True)
            self._timer.start()

    @property
    def pending(self) -> int:
        """Commands buffered but not yet durable."""
        with self._cv:
            return self._pending_n

    @property
    def target_t(self) -> int:
        """The cursor the sink will reach once pending commands flush:
        exact for every sink, since a sharded sink's advance per batch is
        asked of it (``planned_advance``)."""
        with self._cv:
            return self.sink.t + sum(self._advance)

    def _sink_advance(self, log: CommandLog) -> int:
        fn = getattr(self.sink, "planned_advance", None)
        return fn(log) if fn is not None else len(log)

    def submit(self, log: CommandLog, *,
               routed: Optional[CommandLog] = None) -> int:
        """Buffer a log for the next group commit; returns ``target_t``.
        The commands are NOT durable until the group flushes. A caller that
        already routed the log for a sharded sink passes its ``[n_shards,
        L]`` ``routed`` shares, so neither the advance nor the sink
        re-routes."""
        with self._cv:
            if len(log):
                self._pending.append(log)
                self._routed.append(routed)
                # a routed batch's padded common share length IS its
                # global-cursor advance
                self._advance.append(
                    int(routed.opcode.shape[1]) if routed is not None
                    else self._sink_advance(log))
                self._pending_n += len(log)
                self.submitted += len(log)
                if self._oldest is None:
                    self._oldest = time.monotonic()
                    self._cv.notify_all()  # the timer re-arms its deadline
            if (self._pending_n >= self.policy.max_batch
                    or (self._oldest is not None
                        and time.monotonic() - self._oldest
                        >= self.policy.max_delay_s)):
                self._flush_locked()
            return self.sink.t + sum(self._advance)

    def flush(self) -> int:
        """Make every pending command durable (one group commit); returns
        the sink's durable cursor. On a sink failure, whatever prefix the
        sink already made durable is dropped from the buffer and the rest
        stays retryable."""
        with self._cv:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._pending:
            # nothing buffered: no stale deadline may survive (a timer
            # thread re-checking an expired _oldest must wait, not spin)
            self._oldest = None
        if self._pending:
            if self.pre_flush is not None:
                self.pre_flush()
            t0 = self.sink.t
            append_routed = getattr(self.sink, "append_many_routed", None)
            try:
                if (append_routed is not None
                        and all(r is not None for r in self._routed)):
                    append_routed(self._routed)
                else:
                    self.sink.append_many(self._pending)
            except BaseException:
                self._drop_landed(self.sink.t - t0)
                raise
            self._pending = []
            self._routed = []
            self._advance = []
            self._pending_n = 0
            self._oldest = None
            self.groups += 1
        return self.sink.t

    def _timer_loop(self) -> None:
        # Deadline watcher (policy.timer_flush), under the same lock as
        # submit/flush, so a timer flush can never interleave inside a
        # submit or reorder the group relative to the submit order.
        with self._cv:
            while not self._closed:
                if self._oldest is None:
                    self._cv.wait()
                    continue
                delay = self._oldest + self.policy.max_delay_s \
                    - time.monotonic()
                if delay > 0:
                    self._cv.wait(delay)
                    continue
                try:
                    self.timer_flushes += 1
                    self._flush_locked()
                except Exception:  # noqa: BLE001 — the group stays pending
                    # (flush's retry contract); the next deadline or a
                    # foreground flush retries and surfaces the error
                    self._cv.wait(self.policy.max_delay_s or 0.001)

    def close(self) -> None:
        """Flush any pending group and stop the deadline thread. The writer
        stays usable afterwards, just without background flushes."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            self._flush_locked()
        if self._timer is not None:
            self._timer.join(timeout=5)
            self._timer = None

    def _drop_landed(self, landed: int) -> None:
        """Remove what a failed flush already made durable, in the sink's
        cursor units. A single-host sink advances one per command, so a
        mid-log remainder is sliced off for retry (and re-routed, should it
        reach a sharded sink). A sink with ``planned_advance`` advances in
        padded batch units: whole batches whose advance landed are popped,
        and a batch the failure cut mid-way is popped too — its durable
        prefix is already on some shards (the store refuses appends until
        ``recover()``), so re-queueing any of it could only duplicate
        durable commands. Never-acked work may be dropped; durable work
        must never repeat."""
        batch_units = getattr(self.sink, "planned_advance", None) is not None
        while landed > 0 and self._pending:
            log = self._pending[0]
            if batch_units or len(log) <= landed:
                adv = self._advance[0] if batch_units else len(log)
                self._pending_n -= len(log)
                self._pending.pop(0)
                self._routed.pop(0)
                self._advance.pop(0)
                landed = landed - adv if landed >= adv else 0
            else:
                self._pending[0] = log.slice(landed, len(log))
                self._routed[0] = None  # a sliced log needs re-routing
                self._advance[0] = self._sink_advance(self._pending[0])
                self._pending_n -= landed
                landed = 0
        if not self._pending:
            # nothing left to flush: clear the deadline too, or a timer
            # thread would spin on no-op flushes forever
            self._oldest = None


# --------------------------------------------------------------------------- #
# compaction: fold provably-dead commands to NOPs
# --------------------------------------------------------------------------- #
#
# The contract is bit-exact final-state equality, so a command may only be
# folded when replacing it with NOP provably leaves every leaf of the final
# state unchanged (NOP advances ``version`` like any command). Admissible
# folds, proven by a host mirror of F's bookkeeping: apply-time no-ops
# (INSERT into a full arena, DELETE of an absent id, LINK that is a
# duplicate / has no free entry / names an absent id, UNLINK with no
# match); a SET_META a later SET_META to the same cell overwrites (F never
# reads ``meta``); an upsert INSERT a later write to the same slot
# overwrites with no fresh INSERT between (graph construction reads
# vectors); a LINK/UNLINK pair on an otherwise-untouched row. Never a fresh
# INSERT or an INSERT→DELETE pair: the slot, cursor and HNSW edges survive.


def compact_log(genesis: MemoryState,
                log: CommandLog) -> Tuple[CommandLog, Dict[str, int]]:
    """Return (same-length log with dead commands folded to zero-NOPs,
    stats); ``hash(bulk_apply(genesis, out)) == hash(replay(genesis,
    log))``. The analysis runs on the host; the log keeps its device."""
    meta_cols = genesis.meta.shape[1]

    ids_h = genesis.ids.cpu().numpy()
    valid_h = genesis.valid.cpu().numpy()
    links_h = genesis.links.cpu().numpy().copy()
    id2slot = {int(i): s for s, i in enumerate(ids_h) if valid_h[s]}
    free = [int(s) for s in np.nonzero(~valid_h)[0]]  # sorted ⇒ a valid heap

    arrays = log_to_numpy(log)
    opcode, arg0, arg1 = arrays["opcode"], arrays["arg0"], arrays["arg1"]
    n = len(opcode)
    dead = np.zeros((n,), bool)

    pending_vec: Dict[int, int] = {}              # slot -> foldable upsert idx
    pending_meta: Dict[Tuple[int, int], int] = {} # (slot, col) -> write idx
    row_pending: Dict[int, Dict[int, int]] = {}   # slot_a -> {slot_b: link idx}
    last_fresh = -1                               # idx of last fresh INSERT

    for i in range(n):
        op = min(max(int(opcode[i]), 0), 5)  # F clips, mirror clips
        a = int(arg0[i])
        if op == NOP:
            continue
        if op == INSERT:
            slot = id2slot.get(a)
            if slot is not None:  # upsert: in-place vector write
                prev = pending_vec.get(slot)
                if prev is not None and last_fresh < prev:
                    dead[prev] = True
                pending_vec[slot] = i
            elif free:            # fresh insert
                slot = heapq.heappop(free)
                id2slot[a] = slot
                prev = pending_vec.pop(slot, None)
                if prev is not None and last_fresh < prev:
                    dead[prev] = True
                last_fresh = i
            else:                 # arena full: rejected, pure no-op
                dead[i] = True
        elif op == DELETE:
            slot = id2slot.pop(a, None)
            if slot is None:
                dead[i] = True
            else:
                heapq.heappush(free, slot)
        elif op in (LINK, UNLINK):
            b = int(arg1[i])
            sa = id2slot.get(a)
            sb = id2slot.get(b)
            if sa is None or sb is None:
                dead[i] = True
                continue
            row = links_h[sa]
            pend = row_pending.setdefault(sa, {})
            if op == LINK:
                if (row == sb).any() or not (row < 0).any():
                    dead[i] = True  # duplicate / row full: no write
                    pend.clear()    # but it DID observe the row layout
                else:
                    pos = int(np.argmax(row < 0))
                    row[pos] = sb
                    pend.clear()
                    pend[sb] = i    # foldable if unlinked untouched
            else:  # UNLINK
                if not (row == sb).any():
                    dead[i] = True
                    pend.clear()
                else:
                    prev = pend.get(sb)
                    if prev is not None:
                        dead[prev] = True
                        dead[i] = True
                    row[row == sb] = -1
                    pend.clear()
        elif op == SET_META:
            slot = id2slot.get(a)
            if slot is None:
                dead[i] = True
            else:
                col = min(max(int(arg1[i]), 0), meta_cols - 1)
                prev = pending_meta.get((slot, col))
                if prev is not None:
                    dead[prev] = True
                pending_meta[(slot, col)] = i

    folded = int(dead.sum())
    if folded == 0:
        return log, {"n": n, "folded": 0}
    keep = ~dead
    out = {"opcode": np.where(keep, opcode, NOP).astype(np.int32),
           "arg0": np.where(keep, arg0, 0).astype(np.int64),
           "arg1": np.where(keep, arg1, 0).astype(np.int64),
           "arg2": np.where(keep, arrays["arg2"], 0).astype(np.int64),
           "vec": np.where(keep[:, None], arrays["vec"], 0).astype(
               arrays["vec"].dtype)}
    return CommandLog(**{k: torch.from_numpy(v).to(log.device)
                         for k, v in out.items()}), {"n": n, "folded": folded}
