"""Deterministic HNSW (paper §7), ported from the reference's
``repro.core.hnsw`` decision for decision.

No stochastic ingredient survives: the command log fixes the insert
order, a node's level is a pure function of its external id (trailing
ones of a SplitMix64 avalanche), and the entry point is the first inserted
node until a DELETE tombstones it (then ``ensure_live_entry`` promotes the
live node with the greatest raw level, lowest id first). Every comparison
is an integer (distance, slot) lexicographic compare, so the graph — which
is hashed state — is bit-identical to the reference's.

Where the state lies on the card, the graph work runs there as the
reference runs it under ``jit``: the batched search and every insert are
the qhnsw kernels (``kernels/qhnsw``, ``csrc/qhnsw.cu``), and the
adjacency, levels and entry never leave the card. Inserts of F queue on a
``WorkingState`` and ``link_pending`` links each run of them with one
launch. A CPU state runs the kernels' plain version
(``kernels/qhnsw/ref.py``): Python control flow over host mirrors of the
graph. ``search_layer`` and ``greedy_step_level``, the reference's
per-level functions, run the plain version on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.state import MemoryState, WorkingState
from repro_torch.kernels.qhnsw import ops as _ops
from repro_torch.kernels.qhnsw import ref as _ref
from repro_torch.kernels.qhnsw.ref import (INF, PAD, level_of_id,  # noqa: F401
                                           splitmix64)


# --------------------------------------------------------------------------- #
# insert
# --------------------------------------------------------------------------- #


def hnsw_insert(state: MemoryState, new_slot, *, ef_construction: int = 32,
                m: Optional[int] = None, fast: bool = False) -> MemoryState:
    """Incrementally insert the (already stored) row at ``new_slot``.
    ``fast=True`` is the bulk-ingest bookkeeping; the graph is identical."""
    slots = torch.tensor([[int(new_slot)]], dtype=torch.int32)
    return _ops.qhnsw_insert(state, slots, 1, ef_construction=ef_construction,
                             fast=fast, m=m)


def link(ws: WorkingState, slot: int, ef_construction: int,
         fast: bool) -> None:
    """Insert the stored row at ``slot`` into ws's graph: now, on the host;
    on the card, queued on ``ws.pending`` for ``link_pending`` (the host
    takes the entry the kernel will: the first node of an empty graph).
    The caller links what is pending before anything changes what the
    queued inserts would read (``needs_link``)."""
    if ws.host_graph:
        _ref._insert(ws, int(slot), ef_construction, fast=fast)
        return
    if not ws.pending:
        ws.pending_key = (ef_construction, fast)
        ws.run_entry = ws.entry
    ws.pending.append(int(slot))
    ws.in_graph[slot] = True
    if ws.entry < 0:
        ws.entry = int(slot)


def needs_link(ws: WorkingState, ef_construction: int, fast: bool) -> bool:
    """Whether ws has queued inserts of another kind (ef, variant) than the
    next one: a run is one launch of one kind."""
    return bool(not ws.host_graph and ws.pending
                and ws.pending_key != (ef_construction, fast))


def link_pending(lanes: Sequence[WorkingState]) -> None:
    """Link every lane's queued inserts with one launch of the insert
    kernel (the lanes share one ``DeviceGraph``, in lane order): the card's
    ids / valid take the host's changes first, then each lane's entry as
    its run's first insert saw it."""
    lanes = [ws for ws in lanes if not ws.host_graph]
    if not any(ws.pending for ws in lanes):
        return
    with obs.span("hnsw.link"):
        _link(lanes)


def _link(lanes: Sequence[WorkingState]) -> None:
    g = lanes[0].graph
    if len(lanes) != g.vectors.shape[0] or any(
            ws.graph is not g or ws.lane != s for s, ws in enumerate(lanes)):
        raise ValueError("link_pending takes every lane of one DeviceGraph, "
                         "in lane order")
    dev = g.vectors.device
    keys = {ws.pending_key for ws in lanes if ws.pending}
    if len(keys) != 1:
        raise ValueError(f"one launch links one kind of insert, got {keys}")
    ef, fast = keys.pop()
    for ws in lanes:
        if ws.dirty:
            idx = np.unique(np.asarray(ws.dirty, np.int64))
            at = torch.from_numpy(idx).to(dev)
            g.ids[ws.lane].index_copy_(0, at, torch.from_numpy(
                ws.ids[idx]).to(dev))
            g.valid[ws.lane].index_copy_(0, at, torch.from_numpy(
                ws.valid[idx]).to(dev))
            ws.dirty = []
    g.entry.copy_(torch.tensor([ws.run_entry if ws.pending else ws.entry
                                for ws in lanes], dtype=torch.int32))
    slots, n_real = _ref.pack_slots([ws.pending for ws in lanes],
                                    g.vectors.shape[1])
    _ops.link_(g.tensors(), torch.from_numpy(slots), n_real, ef, fast)
    for ws in lanes:
        ws.pending = []


def greedy_step_level(state: MemoryState, q_raw: torch.Tensor, level: int,
                      start_slot: int) -> int:
    ws = WorkingState(state, host_graph=True)
    return _ref._drive1(ws, _ref._query(q_raw, ws),
                        _ref._greedy(ws, {}, int(level), int(start_slot)))


def search_layer(state: MemoryState, q_raw: torch.Tensor, entry_slot: int,
                 level: int, ef: int, max_iters: Optional[int] = None,
                 fast: bool = False, dead_ok: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists[ef] int64, slots[ef] int32) on the state's device."""
    ws = WorkingState(state, host_graph=True)
    d, s = _ref._drive1(ws, _ref._query(q_raw, ws),
                        _ref._search_layer(ws, {}, int(entry_slot), int(level),
                                           ef, max_iters, fast, dead_ok))
    return (torch.from_numpy(d).to(state.device),
            torch.from_numpy(s.astype(np.int32)).to(state.device))


# --------------------------------------------------------------------------- #
# entry-point repair on delete (DESIGN.md §11)
# --------------------------------------------------------------------------- #


def raw_levels(state: MemoryState) -> torch.Tensor:
    """``level_of_id`` over the whole arena: [capacity] int32."""
    return torch.from_numpy(level_of_id(state.ids.cpu().numpy(),
                                        state.hnsw_max_levels)).to(state.device)


def _repair_entry_host(ids: np.ndarray, valid: np.ndarray,
                       max_levels: int) -> int:
    """The live slot maximizing (raw level, then lowest id); -1 if none —
    exactly the node a fresh build of the same live rows makes its entry."""
    live = np.flatnonzero(valid)
    if len(live) == 0:
        return -1
    lv = level_of_id(ids[live], max_levels)
    top = live[lv == lv.max()]
    return int(top[np.argmin(ids[top])])


def repair_entry(state: MemoryState) -> torch.Tensor:
    slot = _repair_entry_host(state.ids.cpu().numpy(),
                              state.valid.cpu().numpy(), state.hnsw_max_levels)
    return torch.tensor(slot, dtype=torch.int32, device=state.device)


def _ensure_live_entry_ws(ws: WorkingState) -> None:
    e = ws.entry
    if e >= 0 and not ws.valid[min(e, ws.capacity - 1)]:
        ws.entry = _repair_entry_host(ws.ids, ws.valid, ws.max_levels)


def ensure_live_entry(state: MemoryState) -> MemoryState:
    """Post-delete invariant: the entry is live, or -1 when nothing is.
    Repair touches only ``hnsw_entry``; the dead node keeps its edges."""
    entry = int(state.hnsw_entry)
    safe = min(max(entry, 0), state.capacity - 1)
    if entry >= 0 and not bool(state.valid[safe]):
        return dataclasses.replace(state, hnsw_entry=repair_entry(state))
    return state


# --------------------------------------------------------------------------- #
# deterministic re-link: graph compaction (DESIGN.md §11)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class RelinkPolicy:
    """When the serve engine re-links the HNSW graph from its live rows:
    every ``check_every`` ingested commands, once at least ``min_deletes``
    effective deletes have accrued, when deletes reach ``dead_ratio`` of
    the (dead + live) node population."""
    dead_ratio: float = 0.5
    min_deletes: int = 64
    check_every: int = 64

    def __post_init__(self):
        if not 0.0 < self.dead_ratio <= 1.0:
            raise ValueError("dead_ratio must be in (0, 1]")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.min_deletes < 1:
            raise ValueError("min_deletes must be >= 1")


def _relink_order_host(ids: np.ndarray, valid: np.ndarray,
                       max_levels: int) -> np.ndarray:
    cap = len(ids)
    live = np.flatnonzero(valid)
    lv = level_of_id(ids[live], max_levels)
    order = np.full(cap, cap, np.int32)
    order[:len(live)] = live[np.lexsort((ids[live], -lv))]
    return order


def relink_order(state: MemoryState) -> torch.Tensor:
    """Canonical re-insertion order over the live slots: (raw level desc,
    id asc); dead slots at the tail as the ``capacity`` sentinel.
    [capacity] int32; its head is ``repair_entry``'s choice."""
    return torch.from_numpy(_relink_order_host(
        state.ids.cpu().numpy(), state.valid.cpu().numpy(),
        state.hnsw_max_levels)).to(state.device)


def rebuild_plan(state: MemoryState) -> Tuple[MemoryState, np.ndarray, int]:
    """What a re-link links: the state with a blank graph, each lane's live
    slots in ``relink_order`` packed as ``ref.pack_slots`` packs them, and
    the run's length. For a flat or a stacked state."""
    blank = dataclasses.replace(
        state, hnsw_neighbors=torch.full_like(state.hnsw_neighbors, -1),
        hnsw_levels=torch.full_like(state.hnsw_levels, -1),
        hnsw_entry=torch.full_like(state.hnsw_entry, -1))
    orders = []
    for lane in _ref.lanes(state):
        order = _relink_order_host(lane.ids.cpu().numpy(),
                                   lane.valid.cpu().numpy(),
                                   lane.hnsw_max_levels)
        orders.append(order[order < lane.capacity].tolist())
    slots, n_real = _ref.pack_slots(orders, state.vectors.shape[-2])
    return blank, slots, n_real


def rebuild(state: MemoryState, ef_construction: int, fast: bool
            ) -> MemoryState:
    """Each lane's graph rebuilt from its live rows in ``relink_order``, for
    a flat state or a stacked one (``shard_wal.shard_stack``): on the card
    one launch of the insert kernel links every lane's order (one CTA per
    lane), on the host the plain version inserts lane by lane. The arena
    and every scalar are untouched."""
    blank, slots, n_real = rebuild_plan(state)
    return _ops.qhnsw_insert(blank, torch.from_numpy(slots), n_real,
                             ef_construction=ef_construction, fast=fast)


def relink(state: MemoryState, *, ef_construction: int = 32) -> MemoryState:
    """Deterministic graph compaction: rebuild the HNSW arrays from the live
    rows only, in ``relink_order``, through the fast insert path; the arena
    and every scalar are untouched. Equals ``fresh_build`` bit for bit."""
    return rebuild(state, ef_construction, True)


def fresh_build(state: MemoryState, *, ef_construction: int = 32
                ) -> MemoryState:
    """The definitional re-link: the same order, one reference-path insert
    per live row."""
    return rebuild(state, ef_construction, False)


# --------------------------------------------------------------------------- #
# query
# --------------------------------------------------------------------------- #


def hnsw_search(state: MemoryState, q_raw: torch.Tensor, k: int, *,
                ef: int = 64) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ANN search: (ids[k] int64, dists[k] wide int64, slots[k] int32) on
    the state's device; missing results are (-1, INF, -1)."""
    q = torch.as_tensor(q_raw).reshape(1, -1)
    return tuple(a[0] for a in _ops.qhnsw_search(state, q, k, ef))
