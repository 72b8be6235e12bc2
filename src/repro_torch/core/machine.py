"""The pure state-machine transition function F (paper §3.1, §5.2).

``S_{t+1} = F(S_t, C_t)``; ``replay`` folds a whole log. Semantics are the
reference's (``repro.core.machine``), command for command: total,
deterministic, every command advancing ``version`` (rejected ones too).

* INSERT(id, vec): upsert. An existing id overwrites its row in place; a
  new id takes the lowest free slot, claimed clean (meta zeroed, links
  cleared), and enters the HNSW graph. A full arena rejects new ids.
* DELETE(id): clear the valid bit and the id; if that killed the HNSW
  entry, promote the deterministic replacement (``hnsw``).
* LINK(a, b) / UNLINK(a, b): typed user edges in ``links``.
* SET_META(id, slot, value): write a metadata word.

The port runs F as host control flow over a ``WorkingState``: the vectors
(cloned once per call, then written in place) stay on the state's device;
ids, valid, links and meta are host mirrors for the duration of the call.
On the card the graph stays there too: the fresh inserts of F queue up and
one launch of the qhnsw insert kernel links each run of them
(``hnsw.link_pending``), the reference's scan of ``hnsw_insert``. A run
ends before any command that would change what its inserts read: a
DELETE (the valid mask, the entry), an upsert (a stored row), a fresh
insert into a slot that once held a graph node (its stale inbound edges
make it visible), or another kind of insert. Rows written ahead of their
insert are invisible to the graph until then (no edge names them), so a
run links exactly the graph sequential F would. The appliers are
generators that yield where a run must end; ``_run`` drives them and
links, for several shards' working states at once with one launch per
round. On the host the graph is a numpy mirror, inserts link at once and
nothing is ever pending. Every public function returns a fresh
MemoryState and leaves its input untouched.

``bulk_apply`` is the batched ingest path (DESIGN.md §3): the host
segments the log by opcode while mirroring F's slot allocator, applies
clean INSERT runs with one batched scatter (then graph-inserts the fresh
rows in order), DELETE and SET_META runs with one probe and one scatter,
and everything order-sensitive sequentially. It equals ``replay`` hash for
hash.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import hnsw
from repro_torch.core.commands import (DELETE, INSERT, LINK, NOP, NUM_OPCODES,
                                       SET_META, UNLINK, CommandLog)
from repro_torch.core.state import (DeviceGraph, MemoryState, WorkingState,
                                    graph_on_host)
from repro_torch.kernels.qhnsw import ref as qhnsw_ref


def _slot_of_id(ws: WorkingState, ext_id: int) -> int:
    match = (ws.ids == ext_id) & ws.valid
    slot = int(np.argmax(match))
    return slot if match[slot] else -1


# --------------------------------------------------------------------------- #
# opcode handlers — each mutates the working state
# --------------------------------------------------------------------------- #


def _insert_target(ws: WorkingState, a0: int) -> Tuple[int, bool]:
    """(slot, upsert) an INSERT of ``a0`` writes: its live slot, else the
    lowest free one; slot -1 when a full arena rejects the new id."""
    existing = _slot_of_id(ws, a0)
    if existing >= 0:
        return existing, True
    free = ~ws.valid
    return (int(np.argmax(free)) if free.any() else -1), False


def _op_insert(ws: WorkingState, a0: int, vec: torch.Tensor, ef: int,
               target: Tuple[int, bool]) -> None:
    slot, has_existing = target
    if slot < 0:
        return  # full arena rejects new ids
    ws.vectors[slot] = vec
    ws.ids[slot] = a0
    ws.valid[slot] = True
    ws.touch(slot)
    ws.cursor = max(ws.cursor, slot + 1)
    if has_existing:
        return  # overwrites keep their meta, links and graph edges
    ws.count += 1
    ws.meta[slot] = 0
    ws.links[slot] = -1
    hnsw.link(ws, slot, ef, fast=False)


def _op_delete(ws: WorkingState, a0: int) -> None:
    slot = _slot_of_id(ws, a0)
    if slot >= 0:
        ws.valid[slot] = False
        ws.ids[slot] = -1
        ws.touch(slot)
        ws.count -= 1
    hnsw._ensure_live_entry_ws(ws)


def _op_link(ws: WorkingState, a0: int, a1: int) -> None:
    a, b = _slot_of_id(ws, a0), _slot_of_id(ws, a1)
    if a < 0 or b < 0:
        return
    row = ws.links[a]
    free = row < 0
    if free.any() and not (row == b).any():
        row[int(np.argmax(free))] = b


def _op_unlink(ws: WorkingState, a0: int, a1: int) -> None:
    a, b = _slot_of_id(ws, a0), _slot_of_id(ws, a1)
    if a >= 0 and b >= 0:
        ws.links[a][ws.links[a] == b] = -1


def _op_set_meta(ws: WorkingState, a0: int, a1: int, a2: int) -> None:
    slot = _slot_of_id(ws, a0)
    if slot >= 0:
        ws.meta[slot, min(max(a1, 0), ws.meta.shape[1] - 1)] = a2


def _apply_one(ws: WorkingState, op: int, a0: int, a1: int, a2: int,
               vec: torch.Tensor, ef: int):
    """Generator: F without the version bump; yields first where the
    queued inserts must be linked before this command."""
    op = min(max(op, 0), NUM_OPCODES - 1)
    if op == INSERT:
        target = _insert_target(ws, a0)
        slot, upsert = target
        if ws.pending and slot >= 0 and (
                upsert or ws.in_graph[slot] or hnsw.needs_link(ws, ef, False)):
            yield
        _op_insert(ws, a0, vec, ef, target)
    elif op == DELETE:
        if ws.pending:
            yield
        _op_delete(ws, a0)
    elif op == LINK:
        _op_link(ws, a0, a1)
    elif op == UNLINK:
        _op_unlink(ws, a0, a1)
    elif op == SET_META:
        _op_set_meta(ws, a0, a1, a2)


def _host_fields(log: CommandLog):
    return [obs.host(getattr(log, f)).numpy()
            for f in ("opcode", "arg0", "arg1", "arg2")]


def _scan(ws: WorkingState, log: CommandLog, ef: int, bump: bool):
    """Generator: F command by command (see ``_run``)."""
    opcode, arg0, arg1, arg2 = _host_fields(log)
    for i in range(len(log)):
        yield from _apply_one(ws, int(opcode[i]), int(arg0[i]), int(arg1[i]),
                              int(arg2[i]), log.vec[i], ef)
        if bump:
            ws.version += 1


def working_lanes(stacked: MemoryState) -> List[WorkingState]:
    """Writable working states of a stacked state's lanes (shards): on the
    card lanes of one ``DeviceGraph`` (a clone of the stacked arena and
    graph), so that ``_run`` links all their runs with one launch."""
    lanes = qhnsw_ref.lanes(stacked)
    if graph_on_host(stacked.device):
        return [WorkingState(lane, writable=True) for lane in lanes]
    graph = DeviceGraph.of(stacked)
    return [WorkingState(lane, graph=graph, lane=s)
            for s, lane in enumerate(lanes)]


def stacked_state(wss: List[WorkingState], like: MemoryState) -> MemoryState:
    """``working_lanes``' states written back as one stacked state."""
    if wss[0].host_graph:
        return qhnsw_ref.stack_lanes([ws.to_state() for ws in wss])
    dev, graph = like.device, wss[0].graph

    def host(field):
        return torch.from_numpy(np.stack([getattr(ws, field) for ws in wss])
                                ).to(dev)

    def scalar(field, dt):
        return torch.tensor([getattr(ws, field) for ws in wss], dtype=dt,
                            device=dev)

    return dataclasses.replace(
        like, vectors=graph.vectors, ids=host("ids"), valid=host("valid"),
        links=host("links"), meta=host("meta"),
        hnsw_neighbors=graph.neighbors, hnsw_levels=graph.levels,
        hnsw_entry=scalar("entry", torch.int32),
        cursor=scalar("cursor", torch.int32),
        count=scalar("count", torch.int32),
        version=scalar("version", torch.int64))


def _run(lanes: List[WorkingState], gens: list) -> None:
    """Drive one applier generator per working state to its end. Each
    round advances every live generator to its next yield (or its end),
    then links every lane's queued inserts with one launch; lanes share
    one ``DeviceGraph`` (the shards of a stacked state) or are one."""
    live = list(range(len(gens)))
    while live:
        nxt = []
        for i in live:
            try:
                next(gens[i])
                nxt.append(i)
            except StopIteration:
                pass
        hnsw.link_pending(lanes)
        live = nxt


# --------------------------------------------------------------------------- #
# F and replay
# --------------------------------------------------------------------------- #


def apply_command(state: MemoryState, rec: CommandLog, *,
                  ef_construction: int = 32) -> MemoryState:
    """S_{t+1} = F(S_t, C_t) for a one-command log ``rec``."""
    if len(rec) != 1:
        raise ValueError(f"apply_command takes one command, got {len(rec)}")
    return replay(state, rec, ef_construction=ef_construction)


def replay(state: MemoryState, log: CommandLog, *,
           ef_construction: int = 32) -> MemoryState:
    """Apply a whole log one command at a time: the definitional
    Apply(S_0, {C_i}). A pure function of (state, log)."""
    ws = WorkingState(state, writable=True)
    _run([ws], [_scan(ws, log, ef_construction, bump=True)])
    return ws.to_state()


def apply_chunked(state: MemoryState, log: CommandLog, chunk: int, *,
                  ef_construction: int = 32) -> MemoryState:
    """Replay in host-driven chunks (batch boundaries cannot matter)."""
    n = len(log)
    for start in range(0, n, chunk):
        state = replay(state, log.slice(start, min(start + chunk, n)),
                       ef_construction=ef_construction)
    return state


# --------------------------------------------------------------------------- #
# bulk apply: the batched ingestion path (DESIGN.md §3)
# --------------------------------------------------------------------------- #


def _pad_log(log: CommandLog, target: int) -> CommandLog:
    """NOP-pad a sub-log to ``target`` records."""
    pad = target - len(log)
    if pad == 0:
        return log
    dev = log.device
    z = lambda dt: torch.zeros((pad,), dtype=dt, device=dev)  # noqa: E731
    return log.concat(CommandLog(
        opcode=z(torch.int32), arg0=z(torch.int64), arg1=z(torch.int64),
        arg2=z(torch.int64),
        vec=torch.zeros((pad, log.dim), dtype=log.vec.dtype, device=dev)))


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _probe_slots(ws: WorkingState, keys: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched ``slot_of_id`` against one state: (found[n], slots[n]), the
    lowest valid slot holding each key."""
    live = np.flatnonzero(ws.valid)
    order = live[np.argsort(ws.ids[live], kind="stable")]
    sid = ws.ids[order]
    pos = np.clip(np.searchsorted(sid, keys), 0, max(len(sid) - 1, 0))
    if len(sid) == 0:
        return np.zeros(len(keys), bool), np.zeros(len(keys), np.int64)
    return sid[pos] == keys, order[pos]


def _apply_insert_segment(ws: WorkingState, log: CommandLog, n_real: int,
                          ef: int) -> None:
    """Clean INSERT run (fresh, distinct ids): command i takes the i-th
    lowest free slot; commands past the free supply are rejected."""
    m, cap = len(log), ws.capacity
    free_idx = np.flatnonzero(~ws.valid)
    idx = np.arange(m)
    accepted = (idx < n_real) & (idx < len(free_idx))
    slots = np.full(m, cap, np.int64)
    slots[accepted] = free_idx[:int(accepted.sum())]
    acc = slots[accepted]
    if len(acc):
        dev = ws.device
        ws.vectors[torch.from_numpy(acc).to(dev)] = \
            log.vec[torch.from_numpy(np.flatnonzero(accepted)).to(dev)]
        ws.ids[acc] = obs.host(log.arg0).numpy()[accepted]
        ws.valid[acc] = True
        ws.touch(acc)
        ws.meta[acc] = 0
        ws.links[acc] = -1
        ws.count += len(acc)
        ws.cursor = max(ws.cursor, int(acc.max()) + 1)
    ws.version += n_real
    # graph construction in log order over the fresh rows only
    for slot in acc.tolist():
        hnsw.link(ws, slot, ef, fast=True)


def _apply_delete_segment(ws: WorkingState, arg0: np.ndarray,
                          first_occ: np.ndarray, n_real: int) -> None:
    """DELETE run: one probe against the segment-entry state, one scatter,
    one entry repair at the end (equal to per-command repair)."""
    found, slots = _probe_slots(ws, arg0)
    do = found & first_occ & (np.arange(len(arg0)) < n_real)
    ws.valid[slots[do]] = False
    ws.ids[slots[do]] = -1
    ws.touch(slots[do])
    ws.count -= int(do.sum())
    ws.version += n_real
    hnsw._ensure_live_entry_ws(ws)


def _apply_meta_segment(ws: WorkingState, arg0, arg1, arg2, last_occ,
                        n_real: int) -> None:
    """SET_META run: one probe, one scatter (last write per key wins)."""
    found, slots = _probe_slots(ws, arg0)
    mslot = np.clip(arg1, 0, ws.meta.shape[1] - 1)
    do = found & last_occ & (np.arange(len(arg0)) < n_real)
    ws.meta[slots[do], mslot[do]] = arg2[do]
    ws.version += n_real


def _apply_seq_segment(ws: WorkingState, log: CommandLog, n_real: int,
                       ef: int):
    """Generator: the order-sensitive remainder, F command by command; NOP
    padding must not advance logical time, so the version moves by
    ``n_real``."""
    yield from _scan(ws, log, ef, bump=False)
    ws.version += n_real


_BATCH_CHUNK = 512  # longest DELETE / SET_META run one probe covers


class _HostAllocator:
    """Host mirror of F's slot allocator, driven during segmentation: the
    live id→slot map, the free-slot min-heap and per-slot graph virginity.
    A fresh insert landing on a slot that once held a graph node (stale
    inbound edges survive deletion) is a hazard and goes sequential."""

    def __init__(self, ws: WorkingState):
        self.id2slot = {int(i): int(s)
                        for s, i in zip(np.flatnonzero(ws.valid),
                                        ws.ids[ws.valid])}
        self.free = np.flatnonzero(~ws.valid).tolist()  # already sorted
        self.virgin = ~ws.graph_nodes()

    def next_slot_virgin(self) -> bool:
        return (not self.free) or bool(self.virgin[self.free[0]])

    def insert(self, ext_id: int) -> None:
        if ext_id in self.id2slot:
            return
        if self.free:
            slot = heapq.heappop(self.free)
            self.id2slot[ext_id] = slot
            self.virgin[slot] = False

    def delete(self, ext_id: int) -> None:
        slot = self.id2slot.pop(ext_id, None)
        if slot is not None:
            heapq.heappush(self.free, slot)


def _segment_log(opcode, arg0, alloc: _HostAllocator) -> List[tuple]:
    """Split the log into batched segments (kind, start, stop, aux) while
    simulating F's allocation bookkeeping, so that every place where a
    batch would behave differently from sequential replay is a hazard."""
    segments = []
    n = len(opcode)
    i = 0
    while i < n:
        op = int(opcode[i])
        if op == NOP:
            j = i
            while j < n and opcode[j] == NOP:
                j += 1
            segments.append(("nop", i, j, None))
        elif op == INSERT:
            j = i
            seg_ids = set()
            while j < n and opcode[j] == INSERT:
                a = int(arg0[j])
                if a in alloc.id2slot or a in seg_ids:
                    break  # upsert or duplicate ⇒ order matters
                if not alloc.next_slot_virgin():
                    break  # reused slot has stale inbound edges
                alloc.insert(a)
                seg_ids.add(a)
                j += 1
            if j > i:
                segments.append(("insert", i, j, None))
            else:
                alloc.insert(int(arg0[i]))
                j = i + 1
                segments.append(("seq", i, j, None))
        elif op == DELETE:
            j = min(i + _BATCH_CHUNK, n)
            k = i
            seen = set()
            first_occ = []
            while k < j and opcode[k] == DELETE:
                a = int(arg0[k])
                first_occ.append(a not in seen)
                seen.add(a)
                alloc.delete(a)
                k += 1
            segments.append(("delete", i, k, np.asarray(first_occ, bool)))
            j = k
        elif op == SET_META:
            j = min(i + _BATCH_CHUNK, n)
            k = i
            while k < j and opcode[k] == op:
                k += 1
            segments.append(("run", i, k, op))
            j = k
        else:  # LINK / UNLINK (and out-of-range opcodes): sequential
            k = i
            while k < n and opcode[k] == op:
                k += 1
            segments.append(("seq", i, k, None))
            j = k
        i = j

    merged = []  # coalesce adjacent sequential segments
    for seg in segments:
        if merged and seg[0] == "seq" and merged[-1][0] == "seq":
            merged[-1] = ("seq", merged[-1][1], seg[2], None)
        else:
            merged.append(seg)
    return merged


def _bulk(ws: WorkingState, log: CommandLog, ef: int):
    """Generator: the segments of ``bulk_apply`` (see ``_run``)."""
    opcode, arg0, arg1, arg2 = _host_fields(log)
    for kind, a, b, aux in _segment_log(opcode, arg0, _HostAllocator(ws)):
        m = b - a
        if kind == "nop":
            ws.version += m
        elif kind == "insert":
            if hnsw.needs_link(ws, ef, True):
                yield
            _apply_insert_segment(ws, _pad_log(log.slice(a, b), _pow2(m)), m,
                                  ef)
        elif kind == "delete":
            if ws.pending:
                yield
            _apply_delete_segment(ws, arg0[a:b], aux, m)
        elif kind == "run" and aux == SET_META:
            mslots = np.clip(arg1[a:b], 0, ws.meta.shape[1] - 1)
            occ = np.zeros(m, bool)
            seen = set()
            for t in range(m - 1, -1, -1):  # last write per (id, slot) wins
                key = (int(arg0[a + t]), int(mslots[t]))
                occ[t] = key not in seen
                seen.add(key)
            _apply_meta_segment(ws, arg0[a:b], arg1[a:b], arg2[a:b], occ, m)
        else:  # "seq": LINK/UNLINK runs and hazardous INSERTs
            yield from _apply_seq_segment(
                ws, _pad_log(log.slice(a, b), _pow2(m)), m, ef)


def bulk_apply(state: MemoryState, log: CommandLog, *,
               ef_construction: int = 32) -> MemoryState:
    """Apply a whole log in batched form; hash-identical to ``replay``."""
    if len(log) == 0:
        return state
    with obs.span("machine.bulk_apply"):
        ws = WorkingState(state, writable=True)
        _run([ws], [_bulk(ws, log, ef_construction)])
        return ws.to_state()
