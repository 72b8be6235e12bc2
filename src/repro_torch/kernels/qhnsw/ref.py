"""Plain PyTorch versions of qhnsw: the host-driven HNSW beams.

The reference computes F's graph work and the HNSW read in ``jnp`` under
``jit`` (``repro/core/hnsw.py``: ``greedy_step_level``, ``search_layer``,
``hnsw_insert``, ``hnsw_search``). This module is that work written as
Python control flow over a ``WorkingState``, decision for decision: the
adjacency, levels and entry are host mirrors, and the beams ask the
state's device for the distances they need (batched and prefetched, see
below). The reference computes some values it then masks away (distances
of neighbours already seen, search at inactive levels); this version skips
that work, which changes no value that is used.

It is what a CPU state runs, and the oracle the CUDA kernels
(``csrc/qhnsw.cu``) are held against on the card. ``search_ref`` and
``insert_ref`` take the kernels' arguments: a flat state, or a stacked one
(every field with a leading ``[n_shards]`` axis, ``shard_wal.shard_stack``),
whose lanes are independent graphs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.state import FIELDS, MemoryState, WorkingState

INF = 1 << 62
PAD = 2**31 - 1   # slot sentinel of empty beam entries


# --------------------------------------------------------------------------- #
# level assignment: deterministic, data-dependent (paper §7.2)
# --------------------------------------------------------------------------- #


def splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 avalanche of int64 ids (as their uint64 bits, wrapping)."""
    with np.errstate(over="ignore"):
        z = np.asarray(x, np.int64).view(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def level_of_id(ext_ids, max_levels: int) -> np.ndarray:
    """Geometric(1/2) level from each id's hash: trailing ones, capped at
    ``max_levels - 1``. Host arithmetic: levels are bookkeeping of the
    host-driven graph."""
    h = splitmix64(ext_ids)
    tz = np.zeros(h.shape, np.int32)
    done = np.zeros(h.shape, bool)
    for i in range(max_levels - 1):
        one = ((h >> np.uint64(i)) & np.uint64(1)) == 1
        tz += ~done & one
        done |= ~one
    return np.minimum(tz, max_levels - 1)


# --------------------------------------------------------------------------- #
# distances: asked of the state's device, a batch of queries at a time
# --------------------------------------------------------------------------- #
#
# The search routines below are generators. Where they need distances they
# yield the slots whose distance to their query is not cached yet — the
# ones needed now plus a prefetch of the ones the next few expansions will
# most likely need — and receive the exact squared L2 distances. ``_drive``
# answers every pending request of a batch of queries with one device call,
# so B queries walk their beams in lockstep. A distance is a pure function
# of (query, slot), so caching and prefetching change no value.

_PREFETCH_NODES = 4    # beam candidates whose neighbour rows are prefetched
_PREFETCH_ROWS = 256   # cap on prefetched rows per request


def _query(q_raw: torch.Tensor, ws: WorkingState) -> torch.Tensor:
    return torch.as_tensor(q_raw, device=ws.device).to(torch.int64)


def _device_dists(ws: WorkingState, q64s: torch.Tensor, reqs) -> list:
    """Squared L2 distances for [(query index, slots)], one device call."""
    sizes = [len(slots) for _, slots in reqs]
    host = np.empty((2, sum(sizes)), np.int64)
    host[0] = np.concatenate([slots for _, slots in reqs])
    host[1] = np.repeat([b for b, _ in reqs], sizes)
    idx = torch.from_numpy(host).to(ws.device)
    diff = ws.vectors.index_select(0, idx[0]).to(torch.int64)
    if len(q64s) == 1:
        diff -= q64s[0]
    else:
        diff -= q64s.index_select(0, idx[1])
    flat = diff.mul_(diff).sum(-1).cpu().numpy()
    return np.split(flat, np.cumsum(sizes)[:-1]) if len(sizes) > 1 else [flat]


def _drive(ws: WorkingState, q64s: torch.Tensor, gens: list) -> list:
    """Run one search generator per query row of ``q64s`` to completion,
    answering all their pending distance requests together each round."""
    results = [None] * len(gens)
    pending = {}

    def advance(b, value):
        try:
            pending[b] = gens[b].send(value)
        except StopIteration as stop:
            results[b] = stop.value

    for b in range(len(gens)):
        advance(b, None)
    while pending:
        reqs = list(pending.items())
        pending.clear()
        for (b, _), ans in zip(reqs, _device_dists(ws, q64s, reqs)):
            advance(b, ans)
    return results


def _drive1(ws: WorkingState, q64: torch.Tensor, gen):
    return _drive(ws, q64[None], [gen])[0]


def _dists(cache: dict, slots: np.ndarray, ok: np.ndarray, prefetch=None):
    """Generator: distances to ``slots`` (INF where not ``ok``)."""
    need = slots[ok].tolist()
    miss = [x for x in dict.fromkeys(need) if x not in cache]
    if miss:
        if prefetch is not None and len(prefetch):
            extra = [x for x in dict.fromkeys(prefetch.tolist())
                     if x not in cache]
            miss = list(dict.fromkeys(miss + extra[:_PREFETCH_ROWS]))
        req = np.asarray(miss, np.int64)
        got = yield req
        cache.update(zip(miss, got.tolist()))
    out = np.full(len(slots), INF, np.int64)
    out[ok] = [cache[x] for x in need]
    return out


def _wide_l2(ws: WorkingState, cache: dict, slots, prefetch=None):
    """Generator: distances to ``slots``; -1 and invalid rows → INF."""
    slots = np.asarray(slots, np.int64)
    ok = (slots >= 0) & ws.valid[np.clip(slots, 0, ws.capacity - 1)]
    return (yield from _dists(cache, slots, ok, prefetch))


def _wide_l2_traverse(ws: WorkingState, cache: dict, slots, prefetch=None):
    """Generator: traversal distances — tombstoned rows keep their true
    score (the query beam uses dead nodes as waypoints); only -1 → INF."""
    slots = np.asarray(slots, np.int64)
    return (yield from _dists(cache, slots, slots >= 0, prefetch))


def _sort2(d: np.ndarray, s: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    o = np.lexsort((s, d))
    return d[o], s[o]


def _sort_dedup(d: np.ndarray, s: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by (distance, slot), blank duplicate slots to (INF, PAD), re-sort."""
    d, s = _sort2(d, s)
    dup = np.zeros(len(s), bool)
    dup[1:] = (s[1:] == s[:-1]) & (s[1:] != PAD)
    return _sort2(np.where(dup, INF, d), np.where(dup, PAD, s))


# --------------------------------------------------------------------------- #
# greedy descent and beam search (generators; see ``_drive``)
# --------------------------------------------------------------------------- #


def _greedy(ws: WorkingState, cache: dict, level: int, start: int):
    """Walk to the locally nearest node at ``level`` from ``start``."""
    rows = ws.neighbors[level]
    cur = int(start)
    cur_d = int((yield from _wide_l2(ws, cache, [cur]))[0])
    for _ in range(ws.capacity):
        nbrs = rows[cur].astype(np.int64)
        two_hop = rows[nbrs[nbrs >= 0]].ravel()
        nd = yield from _wide_l2(ws, cache, nbrs, two_hop[two_hop >= 0])
        best = int(np.argmin(nd))  # ties → lowest index
        bd, bs = int(nd[best]), int(nbrs[best])
        if bd < cur_d or (bd == cur_d and bs < cur):
            cur, cur_d = bs, bd
        else:
            break
    return cur


def _sort_dedup_entries(entries: list) -> list:
    """``_sort_dedup`` on a list of (distance, slot) tuples."""
    entries = sorted(entries)
    prev = None
    for i, (_, slot) in enumerate(entries):
        if slot == prev and slot != PAD:
            entries[i] = (INF, PAD)
        prev = slot
    return sorted(entries)


def _search_layer(ws: WorkingState, cache: dict, entry_slot: int, level: int,
                  ef: int, max_iters: Optional[int] = None, fast: bool = False,
                  dead_ok: bool = False):
    """Generator: ef-beam search at ``level``, returning (dists[ef],
    slots[ef]) sorted by (distance, slot). ``fast`` is the construction
    path's bookkeeping (expansion flags ride with the beam entries, no
    dedup pass), value-identical to the default; ``dead_ok`` ranks
    tombstones by their stored vectors. The beam is a list of Python
    tuples: at ef + degree entries, sorting tuples beats array calls."""
    cap = ws.capacity
    if max_iters is None:
        max_iters = 2 * ef + 8
    if fast and dead_ok:
        raise ValueError("dead_ok is a query-path knob; the fast "
                         "construction path never traverses tombstones")
    dist_of = _wide_l2_traverse if dead_ok else _wide_l2
    rows = ws.neighbors[level]
    entry_slot = int(entry_slot)
    d0 = int((yield from dist_of(ws, cache, [entry_slot]))[0])
    seen = {entry_slot}

    def clip(x):
        return 0 if x < 0 else (cap - 1 if x >= cap else x)

    def prefetch(slots):
        out = [x for y in slots for x in rows[clip(y)].tolist()
               if x >= 0 and x not in seen]
        return np.asarray(out, np.int64)

    if fast:
        # entries (distance, slot, expanded); sorting by the full tuple is
        # the (distance, slot) order, as the beam never repeats a slot
        beam = [(d0, entry_slot, False)] + [(INF, PAD, False)] * (ef - 1)
        for _ in range(max_iters):
            unexp = [i for i, e in enumerate(beam) if e[0] < INF and not e[2]]
            if not unexp:
                break
            pick = unexp[0]
            d_p, s_p, _ = beam[pick]
            beam[pick] = (d_p, s_p, True)
            nbrs = rows[clip(s_p)].tolist()
            fresh = [x for x in nbrs if x >= 0 and x not in seen]
            if not fresh:
                continue
            seen.update(x for x in nbrs if x >= 0)
            pre = prefetch(beam[i][1] for i in unexp[1:1 + _PREFETCH_NODES])
            nd = iter((yield from _wide_l2(ws, cache, fresh, pre)).tolist())
            new = [(next(nd), x, False) if x >= 0 and x in fresh else
                   (INF, PAD, False) for x in nbrs]
            beam = sorted(beam + new)[:ef]
        return (np.asarray([e[0] for e in beam], np.int64),
                np.asarray([e[1] for e in beam], np.int64))

    beam = [(d0, entry_slot)] + [(INF, PAD)] * (ef - 1)
    expanded = set()
    for _ in range(max_iters):
        unexp = [i for i, (d, sl) in enumerate(beam)
                 if d < INF and clip(sl) not in expanded]
        if not unexp:
            break
        cur = clip(beam[unexp[0]][1])
        expanded.add(cur)
        nbrs = rows[cur].tolist()
        safe = [clip(x) for x in nbrs]
        fresh = [x >= 0 and sf not in seen for x, sf in zip(nbrs, safe)]
        marks = [sf in seen or x >= 0 for x, sf in zip(nbrs, safe)]
        for sf, mark in zip(safe, marks):  # the reference's scatter: last
            if mark:                       # write wins
                seen.add(sf)
            else:
                seen.discard(sf)
        new = [(INF, PAD)] * len(nbrs)
        if any(fresh):
            pre = prefetch(beam[i][1] for i in unexp[1:1 + _PREFETCH_NODES])
            want = [sf for sf, f in zip(safe, fresh) if f]
            nd = iter((yield from dist_of(ws, cache, want, pre)).tolist())
            new = [(next(nd), sf) if f else (INF, PAD)
                   for sf, f in zip(safe, fresh)]
        beam = _sort_dedup_entries(beam + new)[:ef]
    return (np.asarray([e[0] for e in beam], np.int64),
            np.asarray([e[1] for e in beam], np.int64))


# --------------------------------------------------------------------------- #
# insert
# --------------------------------------------------------------------------- #


def _connect(ws: WorkingState, lvl: int, new_slot: int, cand_d: np.ndarray,
             cand_s: np.ndarray, m: int, dedup: bool) -> None:
    """Connect new_slot ↔ its m nearest candidates at ``lvl``, pruning each
    reverse row to the degree by (distance-to-owner, slot).

    ``dedup=True`` is ``_add_bidirectional_edges`` (the reference path's
    sequential per-candidate loop; candidates are distinct, so its
    iterations are independent and run here as one batch), ``dedup=False``
    is ``_add_edges_fast`` (plain sort, no duplicate pass)."""
    degree = ws.degree
    ef = len(cand_s)
    idx = np.arange(degree)
    src = np.clip(idx, 0, ef - 1)
    fwd = np.where((idx < m) & (cand_d[src] < INF), cand_s[src], -1)
    ws.neighbors[lvl, new_slot] = fwd.astype(np.int32)

    mm = min(m, ef)
    c = cand_s[:mm]
    owners = c[(cand_d[:mm] < INF) & (c != new_slot)]
    if len(owners) == 0:
        return
    cur = ws.neighbors[lvl, owners].astype(np.int64)          # [r, degree]
    r = len(owners)
    dev = ws.device
    own_t = torch.from_numpy(owners).to(dev)
    cur_t = torch.from_numpy(np.clip(cur, 0, ws.capacity - 1).reshape(-1)).to(dev)
    own_v = ws.vectors.index_select(0, own_t).to(torch.int64)          # [r, D]
    cur_v = ws.vectors.index_select(0, cur_t).to(torch.int64).view(r, degree, -1)
    new_v = ws.vectors[new_slot].to(torch.int64)
    dd = ((cur_v - own_v[:, None, :]) ** 2).sum(-1)
    d_new = ((new_v[None, :] - own_v) ** 2).sum(-1)
    both = torch.cat([dd.reshape(-1), d_new]).cpu().numpy()
    dd = np.where(cur >= 0, both[:r * degree].reshape(r, degree), INF)
    alld = np.concatenate([dd, both[r * degree:, None]], axis=1)
    alls = np.concatenate([np.where(cur >= 0, cur, PAD),
                           np.full((r, 1), new_slot, np.int64)], axis=1)
    order = _sort_dedup if dedup else _sort2
    for i, owner in enumerate(owners):
        rd, rs = order(alld[i], alls[i])
        ws.neighbors[lvl, owner] = np.where(rd[:degree] < INF, rs[:degree],
                                            -1).astype(np.int32)


def _insert(ws: WorkingState, new_slot: int, ef_construction: int = 32,
            m: Optional[int] = None, fast: bool = False) -> None:
    """Insert the (already stored) row at ``new_slot`` into ws's graph."""
    if m is None:
        m = ws.degree // 2
    if fast and m > ef_construction:
        fast = False  # the reference takes its default path here too
    max_levels = ws.max_levels
    new_slot = int(new_slot)
    q64 = ws.vectors[new_slot].to(torch.int64)
    cache: dict = {}  # this row's distances, shared by every level
    is_first = ws.entry < 0
    raw_level = int(level_of_id(ws.ids[new_slot], max_levels))
    entry = new_slot if is_first else ws.entry
    entry_level = raw_level if is_first else int(
        ws.levels[min(max(entry, 0), ws.capacity - 1)])
    # entry fixed to the first node ⇒ cap levels so all nodes stay reachable
    node_level = min(raw_level, entry_level)
    ws.levels[new_slot] = node_level
    ws.entry = entry
    if is_first:
        return

    cur = entry
    for lvl in range(max_levels - 1, 0, -1):
        if node_level < lvl <= entry_level:
            cur = _drive1(ws, q64, _greedy(ws, cache, lvl, cur))
    for lvl in range(min(node_level, max_levels - 1), -1, -1):
        d, s = _drive1(ws, q64, _search_layer(ws, cache, cur, lvl,
                                              ef_construction, fast=fast))
        self_hit = s == new_slot
        d = np.where(self_hit, INF, d)
        s = np.where(self_hit, PAD, s)
        d, s = _sort2(d, s) if fast else _sort_dedup(d, s)
        _connect(ws, lvl, new_slot, d, s, m, dedup=not fast)
        if d[0] < INF:
            cur = int(s[0])


# --------------------------------------------------------------------------- #
# query
# --------------------------------------------------------------------------- #


def _search_gen(ws: WorkingState, k: int, ef: int):
    """Generator: one query's ANN search → (ids[k], dists[k], slots[k])."""
    cache: dict = {}
    cap = ws.capacity
    entry = ws.entry
    have_graph = entry >= 0
    entry_safe = min(max(entry, 0), cap - 1)
    entry_level = int(ws.levels[entry_safe]) if have_graph else 0
    cur = entry_safe
    for lvl in range(ws.max_levels - 1, 0, -1):
        if lvl <= entry_level and have_graph:
            cur = yield from _greedy(ws, cache, lvl, cur)
    # the level-0 beam traverses tombstones; dead rows leave the answer
    d, s = yield from _search_layer(ws, cache, cur, 0, ef, dead_ok=True)
    live = (d < INF) & ws.valid[np.clip(s, 0, cap - 1)]
    d, s = _sort2(np.where(live, d, INF), np.where(live, s, PAD))
    d, s = d[:k], s[:k]
    ok = (d < INF) & have_graph
    slots = np.where(ok, s, -1).astype(np.int32)
    ids = np.where(ok, ws.ids[np.clip(s, 0, cap - 1)], -1).astype(np.int64)
    return ids, np.where(ok, d, INF), slots


def search_batch(ws: WorkingState, queries_raw: torch.Tensor, k: int, ef: int
                 ) -> list:
    """ANN search of every query row, the beams walked in lockstep (one
    device call answers all queries' distance requests each round)."""
    q64 = _query(queries_raw, ws).reshape(-1, ws.vectors.shape[1])
    return _drive(ws, q64, [_search_gen(ws, k, ef) for _ in range(len(q64))])


# --------------------------------------------------------------------------- #
# the kernels' signatures: flat or stacked states
# --------------------------------------------------------------------------- #


def is_stacked(state: MemoryState) -> bool:
    """A stacked state (``shard_wal.shard_stack``) holds its rows as
    ``[n_shards, cap, dim]``; a flat one as ``[cap, dim]``."""
    return state.vectors.dim() == 3


def lanes(state: MemoryState) -> List[MemoryState]:
    """The per-shard states of a stacked state (views), or [state]."""
    if not is_stacked(state):
        return [state]
    return [dataclasses.replace(state, **{f: getattr(state, f)[s]
                                          for f in FIELDS})
            for s in range(state.hnsw_entry.shape[0])]


def stack_lanes(parts: Sequence[MemoryState]) -> MemoryState:
    """Inverse of ``lanes`` for a stacked state."""
    return dataclasses.replace(parts[0], **{
        f: torch.stack([getattr(p, f) for p in parts]) for f in FIELDS})


def out_width(k: int, ef: int) -> int:
    """Columns of a search answer: the beam holds ef, the answer keeps k."""
    return min(k, ef)


def search_ref(state: MemoryState, queries: torch.Tensor, k: int, ef: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ANN search of each query row in each lane: (ids int64, dists int64,
    slots int32), each [B, min(k, ef)] for a flat state or [n_shards, B,
    min(k, ef)] for a stacked one; slots are lane-local. Missing results
    are (-1, INF, -1)."""
    outs = []
    for lane in lanes(state):
        rows = search_batch(WorkingState(lane, host_graph=True), queries, k,
                            ef)
        kk = out_width(k, ef)
        arrs = []
        for j, dt in enumerate((np.int64, np.int64, np.int32)):
            arr = (np.stack([r[j] for r in rows]) if rows
                   else np.zeros((0, kk), dt))
            arrs.append(torch.from_numpy(arr).to(state.vectors.device))
        outs.append(arrs)
    if not is_stacked(state):
        return tuple(outs[0])
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def insert_ref(state: MemoryState, slots: torch.Tensor, n_real: int,
               ef_construction: int, fast: bool,
               m: Optional[int] = None) -> MemoryState:
    """Link the stored rows ``slots[s, :n_real]`` of each lane, in order,
    into that lane's graph (entries >= capacity are skipped): the state
    with new ``hnsw_neighbors`` / ``hnsw_levels`` / ``hnsw_entry``, in the
    layout it came in (``slots`` is [1, n] for a flat state)."""
    host = slots.cpu().numpy()
    parts = []
    for s, lane in enumerate(lanes(state)):
        ws = WorkingState(lane, host_graph=True)
        for slot in host[s, :n_real].tolist():
            if 0 <= slot < ws.capacity:
                _insert(ws, slot, ef_construction, m, fast)
        dev = lane.vectors.device
        parts.append(dataclasses.replace(
            lane,
            hnsw_neighbors=torch.from_numpy(ws.neighbors.copy()).to(dev),
            hnsw_levels=torch.from_numpy(ws.levels.copy()).to(dev),
            hnsw_entry=torch.tensor(ws.entry, dtype=torch.int32, device=dev)))
    return stack_lanes(parts) if is_stacked(state) else parts[0]


def pack_slots(shares: Sequence[Sequence[int]], capacity: int
               ) -> Tuple[np.ndarray, int]:
    """Each lane's slot list as one int32 [n_lanes, n] array, shorter lists
    padded with the ``capacity`` sentinel (a skipped entry); n is the
    longest list's length (at least 1, so an all-empty run is one column
    of sentinels). Returns (slots, n_real)."""
    n = max([len(s) for s in shares] + [1])
    out = np.full((len(shares), n), capacity, np.int32)
    for i, share in enumerate(shares):
        out[i, :len(share)] = np.asarray(share, np.int64)
    return out, max(len(s) for s in shares) if shares else 0
