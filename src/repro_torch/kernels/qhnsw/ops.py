"""Wrapper of the qhnsw kernels: dispatch by device, checks, launch counts.

``qhnsw_search`` and ``qhnsw_insert`` take a flat state or a stacked one
(``shard_wal.shard_stack``: every field with a leading ``[n_shards]``
axis; lanes are independent graphs). On CUDA tensors they launch the
kernels of ``csrc/qhnsw.cu`` (one launch answers every query of every
lane, or links every lane's slot list) or raise; on CPU tensors they run
the plain version (``ref``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.state import MemoryState
from repro_torch.kernels.qhnsw import kernel as _kernel
from repro_torch.kernels.qhnsw import ref

DTYPES = (torch.int16, torch.int32, torch.int64)
MAX_LANES = 65535  # the search grid's y dimension


def graph_tensors(state: MemoryState) -> tuple:
    """(vectors, ids, valid, neighbors, levels, entry) with a leading lane
    axis: views of a stacked state's fields, or of a flat state's with an
    axis of one."""
    f = (state.vectors, state.ids, state.valid, state.hnsw_neighbors,
         state.hnsw_levels, state.hnsw_entry)
    if ref.is_stacked(state):
        return f
    return tuple(t[None] for t in f[:5]) + (f[5].reshape(1),)


def _check(graph: tuple) -> None:
    vectors, ids, valid, neighbors, levels, entry = graph
    if vectors.dtype not in DTYPES:
        raise TypeError(f"qhnsw takes int16/int32/int64 rows, got "
                        f"{vectors.dtype}")
    want = ((ids, torch.int64), (valid, torch.bool), (neighbors, torch.int32),
            (levels, torch.int32), (entry, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"qhnsw: expected {dt}, got {t.dtype}")
        if t.device != vectors.device:
            raise ValueError("qhnsw inputs must be on one device")
    ns, cap, dim = vectors.shape
    if ns > MAX_LANES or cap >= 2**31:
        raise ValueError(f"qhnsw takes at most {MAX_LANES} lanes of fewer "
                         f"than 2^31 rows, got {ns} x {cap}")
    if vectors.stride(2) != 1 or vectors.stride(1) != dim:
        raise ValueError("qhnsw needs each lane's rows contiguous")
    for t in (ids, valid, levels):
        if tuple(t.shape) != (ns, cap) or t.stride(1) != 1 \
                or t.stride(0) != ids.stride(0):
            raise ValueError("qhnsw needs ids / valid / levels [lanes, cap] "
                             "with one lane stride")
    if neighbors.shape[0] != ns or neighbors.shape[2] != cap \
            or neighbors.stride(3) != 1 \
            or neighbors.stride(2) != neighbors.shape[3]:
        raise ValueError("qhnsw needs neighbors [lanes, levels, cap, degree] "
                         "with contiguous rows")
    if tuple(entry.shape) != (ns,) or not entry.is_contiguous():
        raise ValueError("qhnsw needs entry [lanes], contiguous")


def qhnsw_search(state: MemoryState, queries: torch.Tensor, k: int, ef: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ANN search of each query row in each lane: (ids int64, dists int64,
    slots int32 lane-local), [B, min(k, ef)] for a flat state, [n_shards,
    B, min(k, ef)] for a stacked one; missing results (-1, INF, -1)."""
    if k < 1 or ef < 1:
        raise ValueError(f"qhnsw_search needs k, ef >= 1, got {k}, {ef}")
    if state.vectors.device.type != "cuda":
        return ref.search_ref(state, queries, k, ef)
    graph = graph_tensors(state)
    _check(graph)
    ns, _, dim = graph[0].shape
    dev = graph[0].device
    queries = torch.as_tensor(queries, device=dev)
    if queries.shape[-1] != dim:
        raise ValueError(f"qhnsw_search: queries of width "
                         f"{queries.shape[-1]} against rows of width {dim}")
    q64 = queries.to(torch.int64).reshape(-1, dim).contiguous()
    b, kk = q64.shape[0], ref.out_width(k, ef)
    out_ids = torch.empty((ns, b, kk), dtype=torch.int64, device=dev)
    out_d = torch.empty((ns, b, kk), dtype=torch.int64, device=dev)
    out_s = torch.empty((ns, b, kk), dtype=torch.int32, device=dev)
    if b:
        _kernel.search(graph, q64, ef, kk, out_ids, out_d, out_s)
        obs.count("launch.qhnsw_search")
    if ref.is_stacked(state):
        return out_ids, out_d, out_s
    return out_ids[0], out_d[0], out_s[0]


def _link_plain(graph: tuple, slots: torch.Tensor, n_real: int,
                ef_construction: int, fast: bool, m: Optional[int]) -> None:
    """``link_`` on CPU tensors: the plain version, written back in place."""
    vectors, ids, valid, neighbors, levels, entry = graph
    ns, cap = ids.shape

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt)

    state = MemoryState(
        vectors=vectors, ids=ids, valid=valid,
        links=zeros((ns, cap, 1), torch.int32),
        meta=zeros((ns, cap, 1), torch.int64), hnsw_neighbors=neighbors,
        hnsw_levels=levels, hnsw_entry=entry, cursor=zeros(ns, torch.int32),
        count=zeros(ns, torch.int32), version=zeros(ns, torch.int64))
    out = ref.insert_ref(state, slots, n_real, ef_construction, fast, m)
    neighbors.copy_(out.hnsw_neighbors)
    levels.copy_(out.hnsw_levels)
    entry.copy_(out.hnsw_entry)


def link_(graph: tuple, slots: torch.Tensor, n_real: int,
          ef_construction: int, fast: bool, m: Optional[int] = None) -> None:
    """The insert kernel, in place on the graph's neighbors, levels and
    entry (``graph_tensors`` order, a lane axis first): lane s links
    ``slots[s, :n_real]`` in order; entries outside [0, cap) are skipped.
    CPU tensors take the plain version."""
    _check(graph)
    if graph[0].device.type != "cuda":
        _link_plain(graph, torch.as_tensor(slots), n_real, ef_construction,
                    fast, m)
        return
    degree = graph[3].shape[3]
    if m is None:
        m = degree // 2
    if fast and m > ef_construction:
        fast = False  # the reference takes its default path here too
    if ef_construction < 1 or m < 0:
        raise ValueError(f"qhnsw_insert needs ef_construction >= 1 and "
                         f"m >= 0, got {ef_construction}, {m}")
    slots = torch.as_tensor(slots, device=graph[0].device).to(torch.int32) \
        .contiguous()
    if slots.dim() != 2 or slots.shape[0] != graph[0].shape[0] \
            or n_real > slots.shape[1]:
        raise ValueError(f"qhnsw_insert takes slots [lanes, n] with n >= "
                         f"n_real, got {tuple(slots.shape)}, n_real={n_real}")
    if n_real > 0:
        _kernel.insert(graph, slots, n_real, ef_construction, m, fast)
        obs.count("launch.qhnsw_insert")


def qhnsw_insert(state: MemoryState, slots: torch.Tensor, n_real: int, *,
                 ef_construction: int = 32, fast: bool = False,
                 m: Optional[int] = None) -> MemoryState:
    """Link the stored rows ``slots[s, :n_real]`` of each lane, in order,
    into its graph: the state with new ``hnsw_neighbors``, ``hnsw_levels``
    and ``hnsw_entry`` (the input is untouched), in the layout it came in.
    ``slots`` is [1, n] for a flat state; entries >= capacity (``ref.
    pack_slots``'s sentinel) are skipped."""
    if state.vectors.device.type != "cuda":
        return ref.insert_ref(state, torch.as_tensor(slots), n_real,
                              ef_construction, fast, m)
    out = dataclasses.replace(
        state, hnsw_neighbors=state.hnsw_neighbors.clone(),
        hnsw_levels=state.hnsw_levels.clone(),
        hnsw_entry=state.hnsw_entry.clone())
    link_(graph_tensors(out), slots, n_real, ef_construction, fast, m)
    return out
