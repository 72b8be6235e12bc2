"""Sharded deterministic memory (DESIGN.md §2): layout, routing, the merged
VLRS manifest and the device-list "mesh" paths.

The port of ``repro.core.distributed``. Every cross-shard combine is the
one integer ``(score, id)`` merge (``search.merge_candidates``), and
integer merges are exact and order-invariant, so a sharded answer equals
the flat one whenever the per-shard candidates cover their slices.

Command routing is deterministic: a command for external id ``i`` belongs
to shard ``splitmix64(i) mod n_shards`` (computed on the host in numpy
uint64, as the reference's owners end up), and each shard replays its own
NOP-padded share, so every shard's cursor moves in lockstep.

Layout: a sharded state is a ``MemoryState`` whose row arrays are
shard-major (global row = shard * cap_per_shard + local; the HNSW
adjacency ``[levels, n_shards * cap, degree]``) and whose per-shard
scalars (``hnsw_entry``, ``cursor``, ``count``, ``version``) are
``[n_shards]`` tensors — each shard is its own little kernel with its own
clock.

PyTorch has no ``shard_map``. The mesh paths (``distributed_replay``,
``distributed_bulk_apply``, ``distributed_search``,
``distributed_coarse_search``, ``distributed_hnsw_search``) take an
explicit list of ``torch.device``s, one per shard: each shard's slice is
placed on its device (a view when it is already there), the per-shard
function runs there, and the results are gathered to the first device and
merged there. The host-side twins of ``shard_wal`` are these paths over
``[state.device] * n_shards``.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import codes as codes_lib
from repro_torch.core import hashing, machine, search, snapshot
from repro_torch.core.commands import FIELDS as LOG_FIELDS
from repro_torch.core.commands import NOP, CommandLog, log_to_numpy
from repro_torch.core.hnsw import splitmix64
from repro_torch.core.state import MemoryState, init_state
from repro_torch.kernels import qhnsw

INF = search.INF

ROW_FIELDS = ("vectors", "ids", "valid", "links", "meta", "hnsw_levels")
SCALAR_FIELDS = ("hnsw_entry", "cursor", "count", "version")


# --------------------------------------------------------------------------- #
# deterministic command routing
# --------------------------------------------------------------------------- #


def shard_of_id(ext_id, n_shards: int) -> np.ndarray:
    """Shard owner of external ids (int32, host numpy) — a pure integer
    hash, the same on every platform."""
    ids = ext_id.cpu().numpy() if isinstance(ext_id, torch.Tensor) else ext_id
    return (splitmix64(np.asarray(ids, np.int64))
            % np.uint64(n_shards)).astype(np.int32)


def route_commands(log: CommandLog, n_shards: int) -> CommandLog:
    """Split a global log into per-shard logs, NOP-padded to equal length:
    fields gain a leading ``[n_shards]`` axis (on the log's device).
    Relative order within a shard is preserved, so per-shard replay equals
    filtering the global replay. An empty log routes to one NOP per shard,
    as in the reference."""
    arrays = log_to_numpy(log)
    owners = shard_of_id(arrays["arg0"], n_shards)
    per_shard = [np.flatnonzero(owners == s) for s in range(n_shards)]
    max_len = max([len(ix) for ix in per_shard] + [1])
    out = {}
    for name in LOG_FIELDS:
        arr = arrays[name]
        buf = np.zeros((n_shards, max_len) + arr.shape[1:], arr.dtype)
        for s, ix in enumerate(per_shard):
            buf[s, :len(ix)] = arr[ix]
        out[name] = buf
    # the pad is all zeros; its opcode is NOP (= 0) by construction
    assert NOP == 0
    return CommandLog(**{f: torch.from_numpy(v).to(log.device)
                         for f, v in out.items()})


def share(routed: CommandLog, s: int) -> CommandLog:
    """Shard ``s``'s share of a routed ``[n_shards, L]`` log, as a plain
    one-dimensional CommandLog (views)."""
    return CommandLog(**{f: getattr(routed, f)[s] for f in LOG_FIELDS})


# --------------------------------------------------------------------------- #
# sharded state construction, slicing and merging
# --------------------------------------------------------------------------- #


def init_sharded_host(n_shards: int, capacity_per_shard: int, dim: int, *,
                      device=None, **kwargs) -> MemoryState:
    """Empty sharded-layout state (shard-major rows, ``[n_shards]``
    per-shard scalars) on ``device`` (``cuda`` when None): the genesis a
    ``shard_wal.ShardedDurableStore`` slices per shard."""
    proto = init_state(capacity_per_shard, dim, device=device, **kwargs)

    def rep(x):  # per-shard scalar → [n_shards]
        return x[None].expand(n_shards).clone()

    return dataclasses.replace(
        proto,
        vectors=proto.vectors.repeat(n_shards, 1),
        ids=proto.ids.repeat(n_shards),
        valid=proto.valid.repeat(n_shards),
        links=proto.links.repeat(n_shards, 1),
        meta=proto.meta.repeat(n_shards, 1),
        hnsw_neighbors=proto.hnsw_neighbors.repeat(1, n_shards, 1),
        hnsw_levels=proto.hnsw_levels.repeat(n_shards),
        hnsw_entry=rep(proto.hnsw_entry), cursor=rep(proto.cursor),
        count=rep(proto.count), version=rep(proto.version))


def init_sharded_state(devices: Sequence, capacity_per_shard: int, dim: int,
                       **kwargs) -> MemoryState:
    """The sharded layout for a device list: held on the first device; the
    mesh paths place each shard's slice on its own device per call."""
    return init_sharded_host(len(devices), capacity_per_shard, dim,
                             device=devices[0], **kwargs)


def shard_live_counts(state: MemoryState, n_shards: int) -> np.ndarray:
    """Per-shard live-row counts from the ``valid`` mask (host numpy)."""
    return state.valid.cpu().numpy().reshape(n_shards, -1).sum(axis=1)


def shard_slice(state: MemoryState, s: int, n_shards: int) -> MemoryState:
    """Shard ``s`` of a shard-major sharded-layout state as a plain
    single-kernel MemoryState of views (inverse of ``merge_shards``)."""
    cap = state.capacity // n_shards
    lo, hi = s * cap, (s + 1) * cap
    return dataclasses.replace(
        state,
        **{f: getattr(state, f)[lo:hi] for f in ROW_FIELDS},
        hnsw_neighbors=state.hnsw_neighbors[:, lo:hi],
        **{f: getattr(state, f)[s] for f in SCALAR_FIELDS})


def merge_shards(shards: Sequence[MemoryState]) -> MemoryState:
    """Reassemble per-shard kernel states into the sharded layout (row
    arrays concatenated shard-major, per-shard scalars stacked), on the
    first shard's device."""
    dev = shards[0].device

    def cat(field, dim=0):
        return torch.cat([getattr(sh, field).to(dev) for sh in shards],
                         dim=dim)

    return dataclasses.replace(
        shards[0],
        **{f: cat(f) for f in ROW_FIELDS},
        hnsw_neighbors=cat("hnsw_neighbors", dim=1),
        **{f: torch.stack([getattr(sh, f).to(dev) for sh in shards])
           for f in SCALAR_FIELDS})


# --------------------------------------------------------------------------- #
# the device-list mesh paths
# --------------------------------------------------------------------------- #


def _placed(devices: Sequence, state: MemoryState) -> List[MemoryState]:
    n = len(devices)
    return [shard_slice(state, s, n).to(torch.device(devices[s]))
            for s in range(n)]


def distributed_replay(devices: Sequence, state: MemoryState,
                       routed_log: CommandLog, *, ef_construction: int = 32
                       ) -> MemoryState:
    """Replay each shard's share on its device (no cross-shard traffic: ids
    are hash-routed, so shards never contend); merged on the first
    device."""
    parts = [machine.replay(local, share(routed_log, s).to(local.device),
                            ef_construction=ef_construction)
             for s, local in enumerate(_placed(devices, state))]
    return merge_shards(parts)


def distributed_bulk_apply(devices: Sequence, state: MemoryState,
                           routed_log: CommandLog, *,
                           ef_construction: int = 32) -> MemoryState:
    """``machine.bulk_apply`` of each shard's share on its device;
    hash-identical to ``distributed_replay`` shard by shard (the NOP
    padding folds into a version bump)."""
    parts = [machine.bulk_apply(local, share(routed_log, s).to(local.device),
                                ef_construction=ef_construction)
             for s, local in enumerate(_placed(devices, state))]
    return merge_shards(parts)


def _gather_merge(devices: Sequence, parts, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather of per-shard (ids, scores) to the first device, then the
    one integer merge. Returns (ids, scores)."""
    dev = torch.device(devices[0])
    flat_ids = torch.cat([i.to(dev) for i, _ in parts], dim=-1)
    flat_scores = torch.cat([s.to(dev) for _, s in parts], dim=-1)
    s_out, i_out = search.merge_candidates(flat_scores, flat_ids, k)
    return i_out, s_out


def distributed_search(devices: Sequence, state: MemoryState,
                       queries_raw: torch.Tensor, k: int, *,
                       metric: str = search.METRIC_L2,
                       use_kernel: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN across all shards: local top-k on each device (qgemm +
    qtopk on a card), gathered to the first device, sort-merged. Results
    (ids, scores, tie order) are independent of the shard count and equal
    to the single-kernel answer."""
    parts = [search.exact_search(local, queries_raw.to(local.device), k,
                                 metric=metric, use_kernel=use_kernel)
             for local in _placed(devices, state)]
    return _gather_merge(devices, parts, k)


def distributed_coarse_search(devices: Sequence, state: MemoryState,
                              queries_raw: torch.Tensor, k: int, *,
                              ef_coarse: int,
                              metric: str = search.METRIC_L2,
                              use_kernel: bool = False,
                              tables: Optional[Sequence] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compressed tier across shards: each shard scans its own int8
    code table on its device (qcoarse + qtopk on a card) and re-ranks
    exactly (qgemm), then the one merge. Whenever every shard's candidates
    cover its slice (``ef_coarse`` >= per-shard live count) the answer
    equals ``distributed_search``'s. ``tables[s]``, when given, must be
    ``codes.build`` of shard s's slice; otherwise each shard builds its
    table on the spot."""
    parts = []
    for s, local in enumerate(_placed(devices, state)):
        if tables is None:
            table = codes_lib.build(local)
        else:
            table = codes_lib.CodeTable(*(
                getattr(tables[s], f.name).to(local.device)
                for f in dataclasses.fields(codes_lib.CodeTable)))
        parts.append(search.coarse_search(
            local, table, queries_raw.to(local.device), k,
            ef_coarse=ef_coarse, metric=metric, use_kernel=use_kernel))
    return _gather_merge(devices, parts, k)


def distributed_hnsw_search(devices: Sequence, state: MemoryState,
                            queries_raw: torch.Tensor, k: int, *,
                            ef: int = 64
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN across shards: each shard's deterministic HNSW beam search on its
    device, candidates merged with the same integer sort as the flat
    path. Where every shard is on one device, one launch of the qhnsw
    search kernel answers every (query, shard) pair of the stacked view
    (``shard_wal.shard_stack``). Returns (ids, dists)."""
    from repro_torch.core import shard_wal  # shard_wal imports us

    devs = [torch.device(d) for d in devices]
    if all(d == devs[0] for d in devs):
        stacked = shard_wal.shard_stack(state, len(devs)).to(devs[0])
        ids, dists, _ = qhnsw.qhnsw_search(stacked, queries_raw.to(devs[0]),
                                           k, ef)
        parts = [(ids[s], dists[s]) for s in range(len(devs))]
    else:
        parts = []
        for local in _placed(devices, state):
            ids, dists, _ = qhnsw.qhnsw_search(
                local, queries_raw.to(local.device), k, ef)
            parts.append((ids, dists))
    return _gather_merge(devices, parts, k)


# --------------------------------------------------------------------------- #
# per-shard snapshots under one merged manifest (DESIGN.md §5)
# --------------------------------------------------------------------------- #

SHARDED_MAGIC = b"VLRS"
SHARDED_FORMAT = 1


def snapshot_sharded(state: MemoryState, n_shards: int, store, *,
                     chunk_size: int | None = None) -> bytes:
    """Write one v2 snapshot per shard into ``store`` (a
    ``snapshot.ChunkStore``) and return a merged manifest whose combined
    hash is the hash of the whole sharded-layout state. Shards share the
    chunk store, so identical chunks are stored once across shards. The
    bytes are the reference's."""
    chunk_size = chunk_size or snapshot.DEFAULT_CHUNK_SIZE
    parts = [snapshot.snapshot_v2(shard_slice(state, s, n_shards), store,
                                  chunk_size=chunk_size)[0]
             for s in range(n_shards)]
    combined = hashing.hash_state_device(state)
    out = [SHARDED_MAGIC, struct.pack("<II", SHARDED_FORMAT, n_shards),
           struct.pack("<Q", combined)]
    for m in parts:
        out.append(struct.pack("<Q", len(m)))
        out.append(m)
    return b"".join(out)


def restore_sharded(data: bytes, store, *, device=None
                    ) -> Tuple[MemoryState, int]:
    """Restore a merged manifest onto ``device``: per-shard v2 restores,
    reassembled with ``merge_shards``; verifies the combined hash. Returns
    (state, hash)."""
    if data[:4] != SHARDED_MAGIC:
        raise ValueError("not a sharded Valori snapshot manifest")
    fmt, n_shards = struct.unpack_from("<II", data, 4)
    if fmt != SHARDED_FORMAT:
        raise ValueError(f"unsupported sharded manifest format {fmt}")
    (stored,) = struct.unpack_from("<Q", data, 12)
    off = 20
    shards = []
    for _ in range(n_shards):
        (n,) = struct.unpack_from("<Q", data, off)
        off += 8
        shard, _ = snapshot.restore_v2(data[off:off + n], store,
                                       device=device)
        off += n
        shards.append(shard)
    state = merge_shards(shards)
    actual = hashing.hash_state_device(state)
    if actual != stored:
        raise ValueError(
            f"sharded snapshot combined-hash mismatch: stored {stored:#x}, "
            f"got {actual:#x}")
    return state, actual
