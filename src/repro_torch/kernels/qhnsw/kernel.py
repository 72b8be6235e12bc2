"""Launch of the hand-written qhnsw CUDA kernels (``csrc/qhnsw.cu``).

Replaces no Pallas kernel: the reference runs the HNSW search and insert
in ``jnp`` under ``jit`` (``repro/core/hnsw.py``: ``hnsw_search``,
``search_layer``, ``greedy_step_level``, ``hnsw_insert``;
``repro/core/query.py:52-62`` vmaps the search, ``machine.py:246-308``
and ``hnsw.py:656-688`` scan the insert). A beam whose every step
depends on the distances of the one before runs in no PyTorch call
without a host round trip per step, so the port writes the beams by hand.

What bounds them on the card: the latency of a chain of dependent steps,
not bytes or operations. A search is ~2 ef + 8 expansions, each reading
``degree`` rows; an insert run is a chain of such beams. What the design
does about it: a thread-block cluster runs each beam (one per (query,
shard) or per shard's insert run), its CTAs splitting the dimension and
summing their partial distances through distributed shared memory; each
expansion pulls its fresh rows' slices and their neighbour rows into
shared memory in one step (bulk asynchronous copies); warp 0 picks and
queues each step while every thread places one entry of the beam's
merge; nothing crosses to the host inside a launch. The launch code
picks the cluster size from the shapes (``CLUSTER`` keeps the last
launch's, per op).

Both kernels take one argument array (the ``Arg`` enum of the source,
``ARGS`` here) and a stream; a ``Plan`` places each CTA's workspace in
shared memory up to the block's 227 KB and the rest in a global scratch
that the wrapper allocates (``qhnsw_scratch_bytes``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ARGS = ("op", "elem", "ns", "cap", "dim", "degree", "levels",
        "vec", "vec_ss", "ids", "valid", "lvl", "row_ss",
        "nbr", "nbr_ss", "nbr_ls", "entry",
        "ef", "max_iters",
        "q", "b", "kk", "out_ids", "out_d", "out_s",
        "slots", "slots_stride", "n_real", "m", "fast",
        "scratch")
OP_SEARCH, OP_INSERT = 0, 1
CLUSTER = {"search": 0, "insert": 0}  # CTAs per beam of the last launch


def _array(values: dict):
    arr = (ctypes.c_int64 * len(ARGS))()
    for i, name in enumerate(ARGS):
        arr[i] = int(values.get(name, 0))
    return arr


def _graph_args(vectors, ids, valid, neighbors, levels, entry) -> dict:
    """The stacked graph's pointers and strides: vectors [ns, cap, dim],
    ids / valid / levels [ns, cap], neighbors [ns, levels, cap, degree]
    (any shard and level strides), entry [ns]."""
    ns, cap, dim = vectors.shape
    return dict(
        elem=vectors.element_size(), ns=ns, cap=cap, dim=dim,
        degree=neighbors.shape[3], levels=neighbors.shape[1],
        vec=vectors.data_ptr(), vec_ss=vectors.stride(0),
        ids=ids.data_ptr(), valid=valid.data_ptr(), lvl=levels.data_ptr(),
        row_ss=ids.stride(0), nbr=neighbors.data_ptr(),
        nbr_ss=neighbors.stride(0), nbr_ls=neighbors.stride(1),
        entry=entry.data_ptr())


def _run(values: dict, device) -> None:
    arr = _array(values)
    size = _build.helper("qhnsw", "qhnsw_scratch_bytes", [ctypes.c_void_p],
                         ctypes.c_int64)(ctypes.addressof(arr))
    scratch = None
    if size:
        scratch = torch.empty(size, dtype=torch.uint8, device=device)
        arr[ARGS.index("scratch")] = scratch.data_ptr()
    err = _build.launcher("qhnsw")(
        ctypes.addressof(arr), torch.cuda.current_stream(device).cuda_stream)
    _build.check("qhnsw", err)
    op = "search" if values["op"] == OP_SEARCH else "insert"
    CLUSTER[op] = _build.helper("qhnsw", "qhnsw_cluster", [ctypes.c_void_p])(
        ctypes.addressof(arr))
    # the scratch is freed after the launch was queued: PyTorch's caching
    # allocator hands its block to later work on the same stream only
    del scratch


def search(graph: tuple, queries64: torch.Tensor, ef: int, kk: int,
           out_ids, out_d, out_s) -> None:
    """One cluster per (query, shard): out_* [ns, B, kk]."""
    values = _graph_args(*graph)
    values.update(op=OP_SEARCH, ef=ef, max_iters=2 * ef + 8,
                  q=queries64.data_ptr(), b=queries64.shape[0], kk=kk,
                  out_ids=out_ids.data_ptr(), out_d=out_d.data_ptr(),
                  out_s=out_s.data_ptr())
    _run(values, queries64.device)


def insert(graph: tuple, slots: torch.Tensor, n_real: int,
           ef_construction: int, m: int, fast: bool) -> None:
    """One cluster per shard: links slots[s, :n_real] into shard s's
    graph, writing neighbors, levels and entry in place."""
    values = _graph_args(*graph)
    values.update(op=OP_INSERT, ef=ef_construction,
                  max_iters=2 * ef_construction + 8,
                  slots=slots.data_ptr(), slots_stride=slots.stride(0),
                  n_real=n_real, m=m, fast=int(fast))
    _run(values, slots.device)


def round_trip_ns(device, n_entries: int, steps: int) -> float:
    """One memory round trip on the card, in ns: a single thread follows a
    random cycle over ``n_entries`` int32 indices past L1, each load
    waiting for the one before (``qhnsw_chase``), timed with CUDA events
    over ``steps`` loads. Past the 50 MB L2 (``n_entries`` > 2^24) it is
    device memory's round trip; well inside it, L2's."""
    perm = torch.randperm(n_entries, device=device)
    nxt = torch.empty(n_entries, dtype=torch.int32, device=device)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    sink = torch.empty(1, dtype=torch.int32, device=device)
    chase = _build.helper("qhnsw", "qhnsw_chase",
                          [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_void_p])
    stream = torch.cuda.current_stream(device)

    def run(n):
        _build.check("qhnsw", chase(nxt.data_ptr(), n, sink.data_ptr(),
                                    stream.cuda_stream))

    run(steps // 10 + 1)  # warm: the pages the walk touches are mapped
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    run(steps)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) * 1e6 / steps
