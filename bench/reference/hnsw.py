"""F's HNSW graph and its reads, written plainly in NumPy.

A frozen, self-contained copy of the port's host-driven beams
(``src/repro_torch/kernels/qhnsw/ref.py`` as of this benchmark), which
follow the JAX package's ``core/hnsw.py`` decision for decision: levels
from a SplitMix64 of the id, the entry fixed to the first node, integer
(distance, slot) comparisons, ``ef_construction`` beams with the fast
construction bookkeeping, ``m = degree / 2`` forward edges and reverse
rows pruned by (distance to owner, slot). Departures from the port's
copy, none of which changes a value: the distances are computed here on
the host from this module's own rows, one request at a time (no batching
of beams, no prefetch), and each beam counts the distances it needs and
the rows it reads, which the roofline metrics take as the work.

Departure from published HNSW (Malkov and Yashunin): levels are
data-derived and capped at the entry's, and the entry never moves, as
the substrate's determinism requires.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

INF = 1 << 62
PAD = 2**31 - 1


def splitmix64(x) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = np.asarray(x, np.int64).view(np.uint64) + np.uint64(
            0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def level_of_id(ext_ids, max_levels: int) -> np.ndarray:
    """Trailing ones of the id's hash, capped at ``max_levels - 1``."""
    h = splitmix64(ext_ids)
    tz = np.zeros(h.shape, np.int32)
    done = np.zeros(h.shape, bool)
    for i in range(max_levels - 1):
        one = ((h >> np.uint64(i)) & np.uint64(1)) == 1
        tz += ~done & one
        done |= ~one
    return np.minimum(tz, max_levels - 1)


class Graph:
    """The reference's memory: rows (its own), ids, the live mask and the
    adjacency ``neighbors`` [levels, capacity, degree], ``levels`` and the
    entry. ``dists`` and ``rows_read`` count the work of the beams."""

    def __init__(self, rows: np.ndarray, ids: np.ndarray, valid: np.ndarray,
                 neighbors: np.ndarray, levels: np.ndarray, entry: int):
        self.rows = rows
        self.ids = ids
        self.valid = valid
        self.neighbors = neighbors
        self.levels = levels
        self.entry = int(entry)
        self.dists = 0
        self.rows_read: set = set()

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[2]

    @property
    def max_levels(self) -> int:
        return self.neighbors.shape[0]

    def _l2(self, q64: np.ndarray, slots) -> np.ndarray:
        self.dists += len(slots)
        self.rows_read.update(slots)
        diff = self.rows[np.asarray(slots, np.int64)].astype(np.int64) - q64
        return np.einsum("ij,ij->i", diff, diff)


def _dists(g: Graph, q64, cache: dict, slots: np.ndarray, ok: np.ndarray):
    need = slots[ok].tolist()
    miss = [x for x in dict.fromkeys(need) if x not in cache]
    if miss:
        cache.update(zip(miss, g._l2(q64, miss).tolist()))
    out = np.full(len(slots), INF, np.int64)
    out[ok] = [cache[x] for x in need]
    return out


def _wide_l2(g: Graph, q64, cache, slots):
    slots = np.asarray(slots, np.int64)
    ok = (slots >= 0) & g.valid[np.clip(slots, 0, g.capacity - 1)]
    return _dists(g, q64, cache, slots, ok)


def _wide_l2_traverse(g: Graph, q64, cache, slots):
    slots = np.asarray(slots, np.int64)
    return _dists(g, q64, cache, slots, slots >= 0)


def _sort2(d, s):
    o = np.lexsort((s, d))
    return d[o], s[o]


def _sort_dedup(d, s):
    d, s = _sort2(d, s)
    dup = np.zeros(len(s), bool)
    dup[1:] = (s[1:] == s[:-1]) & (s[1:] != PAD)
    return _sort2(np.where(dup, INF, d), np.where(dup, PAD, s))


def _sort_dedup_entries(entries: list) -> list:
    entries = sorted(entries)
    prev = None
    for i, (_, slot) in enumerate(entries):
        if slot == prev and slot != PAD:
            entries[i] = (INF, PAD)
        prev = slot
    return sorted(entries)


def _greedy(g: Graph, q64, cache, level: int, start: int) -> int:
    rows = g.neighbors[level]
    cur = int(start)
    cur_d = int(_wide_l2(g, q64, cache, [cur])[0])
    for _ in range(g.capacity):
        nbrs = rows[cur].astype(np.int64)
        nd = _wide_l2(g, q64, cache, nbrs)
        best = int(np.argmin(nd))
        bd, bs = int(nd[best]), int(nbrs[best])
        if bd < cur_d or (bd == cur_d and bs < cur):
            cur, cur_d = bs, bd
        else:
            break
    return cur


def _search_layer(g: Graph, q64, cache, entry_slot: int, level: int, ef: int,
                  fast: bool = False, dead_ok: bool = False):
    cap = g.capacity
    max_iters = 2 * ef + 8
    dist_of = _wide_l2_traverse if dead_ok else _wide_l2
    rows = g.neighbors[level]
    entry_slot = int(entry_slot)
    d0 = int(dist_of(g, q64, cache, [entry_slot])[0])
    seen = {entry_slot}

    def clip(x):
        return 0 if x < 0 else (cap - 1 if x >= cap else x)

    if fast:
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
            nd = iter(_wide_l2(g, q64, cache, fresh).tolist())
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
        for sf, mark in zip(safe, marks):  # last write wins
            if mark:
                seen.add(sf)
            else:
                seen.discard(sf)
        new = [(INF, PAD)] * len(nbrs)
        if any(fresh):
            want = [sf for sf, f in zip(safe, fresh) if f]
            nd = iter(dist_of(g, q64, cache, want).tolist())
            new = [(next(nd), sf) if f else (INF, PAD)
                   for sf, f in zip(safe, fresh)]
        beam = _sort_dedup_entries(beam + new)[:ef]
    return (np.asarray([e[0] for e in beam], np.int64),
            np.asarray([e[1] for e in beam], np.int64))


def _connect(g: Graph, lvl: int, new_slot: int, cand_d, cand_s, m: int,
             dedup: bool) -> None:
    """new_slot -> its m nearest candidates, and each candidate's row
    pruned back to the degree by (distance to owner, slot)."""
    degree = g.degree
    ef = len(cand_s)
    idx = np.arange(degree)
    src = np.clip(idx, 0, ef - 1)
    fwd = np.where((idx < m) & (cand_d[src] < INF), cand_s[src], -1)
    g.neighbors[lvl, new_slot] = fwd.astype(np.int32)
    mm = min(m, ef)
    c = cand_s[:mm]
    owners = c[(cand_d[:mm] < INF) & (c != new_slot)]
    if len(owners) == 0:
        return
    cur = g.neighbors[lvl, owners].astype(np.int64)
    r = len(owners)
    own_v = g.rows[owners].astype(np.int64)
    cur_v = g.rows[np.clip(cur, 0, g.capacity - 1).reshape(-1)].astype(
        np.int64).reshape(r, degree, -1)
    new_v = g.rows[new_slot].astype(np.int64)
    diff = cur_v - own_v[:, None, :]
    dd = np.einsum("rkd,rkd->rk", diff, diff)
    dn = new_v[None, :] - own_v
    d_new = np.einsum("rd,rd->r", dn, dn)
    dd = np.where(cur >= 0, dd, INF)
    alld = np.concatenate([dd, d_new[:, None]], axis=1)
    alls = np.concatenate([np.where(cur >= 0, cur, PAD),
                           np.full((r, 1), new_slot, np.int64)], axis=1)
    order = _sort_dedup if dedup else _sort2
    for i, owner in enumerate(owners):
        rd, rs = order(alld[i], alls[i])
        g.neighbors[lvl, owner] = np.where(rd[:degree] < INF, rs[:degree],
                                           -1).astype(np.int32)


def insert(g: Graph, new_slot: int, ef_construction: int = 32,
           m: Optional[int] = None, fast: bool = True) -> None:
    """Link the (stored, live) row at ``new_slot`` into the graph."""
    if m is None:
        m = g.degree // 2
    if fast and m > ef_construction:
        fast = False
    max_levels = g.max_levels
    new_slot = int(new_slot)
    q64 = g.rows[new_slot].astype(np.int64)
    cache: dict = {}
    is_first = g.entry < 0
    raw_level = int(level_of_id(g.ids[new_slot], max_levels))
    entry = new_slot if is_first else g.entry
    entry_level = raw_level if is_first else int(
        g.levels[min(max(entry, 0), g.capacity - 1)])
    node_level = min(raw_level, entry_level)
    g.levels[new_slot] = node_level
    g.entry = entry
    if is_first:
        return
    cur = entry
    for lvl in range(max_levels - 1, 0, -1):
        if node_level < lvl <= entry_level:
            cur = _greedy(g, q64, cache, lvl, cur)
    for lvl in range(min(node_level, max_levels - 1), -1, -1):
        d, s = _search_layer(g, q64, cache, cur, lvl, ef_construction,
                             fast=fast)
        self_hit = s == new_slot
        d = np.where(self_hit, INF, d)
        s = np.where(self_hit, PAD, s)
        d, s = _sort2(d, s) if fast else _sort_dedup(d, s)
        _connect(g, lvl, new_slot, d, s, m, dedup=not fast)
        if d[0] < INF:
            cur = int(s[0])


def search(g: Graph, q_raw: np.ndarray, k: int, ef: int):
    """One query's k nearest live rows: (ids[k], squared L2 [k]); missing
    answers are (-1, INF)."""
    q64 = np.asarray(q_raw, np.int64)
    cache: dict = {}
    cap = g.capacity
    entry = g.entry
    have_graph = entry >= 0
    entry_safe = min(max(entry, 0), cap - 1)
    entry_level = int(g.levels[entry_safe]) if have_graph else 0
    cur = entry_safe
    for lvl in range(g.max_levels - 1, 0, -1):
        if lvl <= entry_level and have_graph:
            cur = _greedy(g, q64, cache, lvl, cur)
    d, s = _search_layer(g, q64, cache, cur, 0, ef, dead_ok=True)
    live = (d < INF) & g.valid[np.clip(s, 0, cap - 1)]
    d, s = _sort2(np.where(live, d, INF), np.where(live, s, PAD))
    d, s = d[:k], s[:k]
    ok = (d < INF) & have_graph
    ids = np.where(ok, g.ids[np.clip(s, 0, cap - 1)], -1).astype(np.int64)
    return ids, np.where(ok, d, INF)
