"""MemoryState: the substrate's kernel state as a frozen dataclass of tensors.

The same arena as the reference (``repro.core.state``), field for field
and dtype for dtype:

* ``vectors``   int{16,32,64}[capacity, dim]  raw Q-format rows
* ``ids``       int64[capacity]               external ids (-1 = empty)
* ``valid``     bool[capacity]                live mask
* ``links``     int32[capacity, max_links]    typed user edges
* ``meta``      int64[capacity, meta_slots]   per-row metadata words
* ``hnsw_*``    deterministic HNSW adjacency (see hnsw.py)
* scalars ``cursor``/``count`` int32 and ``version`` int64 (0-dim tensors).

All tensors of a state live on one device, named explicitly at
``init_state``; ``state_from_numpy``/``state_to_numpy`` carry a state
(the reference's, as numpy arrays) in and out of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.contracts import (DEFAULT_CONTRACT, PrecisionContract,
                                        get_contract)

FIELDS = ("vectors", "ids", "valid", "links", "meta", "hnsw_neighbors",
          "hnsw_levels", "hnsw_entry", "cursor", "count", "version")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class MemoryState:
    vectors: torch.Tensor
    ids: torch.Tensor
    valid: torch.Tensor
    links: torch.Tensor
    meta: torch.Tensor
    hnsw_neighbors: torch.Tensor  # [levels, capacity, degree] int32
    hnsw_levels: torch.Tensor     # [capacity] int32, -1 empty
    hnsw_entry: torch.Tensor      # [] int32
    cursor: torch.Tensor          # [] int32
    count: torch.Tensor           # [] int32
    version: torch.Tensor         # [] int64 — logical time t
    contract_name: str = DEFAULT_CONTRACT.name

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def contract(self) -> PrecisionContract:
        return get_contract(self.contract_name)

    @property
    def max_links(self) -> int:
        return self.links.shape[1]

    @property
    def hnsw_degree(self) -> int:
        return self.hnsw_neighbors.shape[2]

    @property
    def hnsw_max_levels(self) -> int:
        return self.hnsw_neighbors.shape[0]

    @property
    def t(self) -> torch.Tensor:
        return self.version

    def leaves(self):
        """(field name, tensor) in field order — the hashed leaves."""
        return [(f, getattr(self, f)) for f in FIELDS]

    def to(self, device) -> "MemoryState":
        return dataclasses.replace(
            self, **{f: t.to(device) for f, t in self.leaves()})


def init_state(capacity: int, dim: int, *,
               contract: PrecisionContract = DEFAULT_CONTRACT,
               max_links: int = 4, meta_slots: int = 2, hnsw_levels: int = 4,
               hnsw_degree: int = 16, device=None) -> MemoryState:
    """A fresh, empty state S_0 on ``device`` (``cuda`` when None)."""
    dev = resolve_device(device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return MemoryState(
        vectors=full((capacity, dim), 0, contract.storage_dtype),
        ids=full((capacity,), -1, torch.int64),
        valid=full((capacity,), False, torch.bool),
        links=full((capacity, max_links), -1, torch.int32),
        meta=full((capacity, meta_slots), 0, torch.int64),
        hnsw_neighbors=full((hnsw_levels, capacity, hnsw_degree), -1,
                            torch.int32),
        hnsw_levels=full((capacity,), -1, torch.int32),
        hnsw_entry=full((), -1, torch.int32),
        cursor=full((), 0, torch.int32),
        count=full((), 0, torch.int32),
        version=full((), 0, torch.int64),
        contract_name=contract.name,
    )


def live_mask(state: MemoryState) -> torch.Tensor:
    return state.valid


def slot_of_id(state: MemoryState, ext_id) -> torch.Tensor:
    """Slot holding ``ext_id`` among valid rows, or -1 (int32 0-dim). The
    first match, as the reference's ``argmax`` over the bool mask (taken
    over uint8: first occurrence of the maximum)."""
    match = (state.ids == ext_id) & state.valid
    slot = torch.argmax(match.to(torch.uint8)).to(torch.int32)
    return torch.where(match.any(), slot, torch.full_like(slot, -1))


_DTYPES = {"vectors": None, "ids": torch.int64, "valid": torch.bool,
           "links": torch.int32, "meta": torch.int64,
           "hnsw_neighbors": torch.int32, "hnsw_levels": torch.int32,
           "hnsw_entry": torch.int32, "cursor": torch.int32,
           "count": torch.int32, "version": torch.int64}


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     contract_name: str = DEFAULT_CONTRACT.name,
                     device=None) -> MemoryState:
    """A state from numpy arrays keyed by field name (e.g. a reference
    state's leaves). Dtypes are checked, never converted."""
    dev = resolve_device(device)
    contract = get_contract(contract_name)
    fields = {}
    for f in FIELDS:
        arr = np.asarray(arrays[f])
        want = _DTYPES[f] or contract.storage_dtype
        t = torch.from_numpy(np.array(arr, copy=True))
        if t.dtype != want:
            raise TypeError(f"{f}: expected {want}, got {arr.dtype}")
        fields[f] = t.to(dev)
    return MemoryState(**fields, contract_name=contract_name)


def state_to_numpy(state: MemoryState) -> Dict[str, np.ndarray]:
    return {f: t.detach().cpu().numpy() for f, t in state.leaves()}


def graph_on_host(device: torch.device) -> bool:
    """Where a working state keeps the HNSW graph: on the host (the plain
    version's numpy mirrors) for a CPU state, on the card otherwise."""
    return torch.device(device).type != "cuda"


@dataclasses.dataclass
class DeviceGraph:
    """The arena and graph of ``n`` lanes (shards) on the card, stacked, for
    the qhnsw insert kernel: ``vectors`` [n, cap, dim] (the lanes' working
    rows), ``ids`` / ``valid`` [n, cap] (the card's copies of the lanes'
    host mirrors, brought up to date before each launch), ``neighbors``
    [n, levels, cap, degree], ``levels`` [n, cap] and ``entry`` [n]. Every
    tensor is the working state's own (a clone of the input's)."""
    vectors: torch.Tensor
    ids: torch.Tensor
    valid: torch.Tensor
    neighbors: torch.Tensor
    levels: torch.Tensor
    entry: torch.Tensor

    @classmethod
    def of(cls, state: MemoryState) -> "DeviceGraph":
        """A clone of a stacked state's arena and graph (a flat state is
        one lane)."""
        f = [state.vectors, state.ids, state.valid, state.hnsw_neighbors,
             state.hnsw_levels, state.hnsw_entry]
        if state.vectors.dim() == 2:
            f = [t[None] for t in f[:5]] + [f[5].reshape(1)]
        return cls(*(t.clone() for t in f))

    def tensors(self) -> tuple:
        return (self.vectors, self.ids, self.valid, self.neighbors,
                self.levels, self.entry)


class WorkingState:
    """A mutable working copy of a MemoryState, for the loops of the
    transition function F and the HNSW construction and search.

    The arena's vectors stay on the state's device. The small integer
    bookkeeping — ids, the valid mask, links, meta, the HNSW entry and the
    scalars — is mirrored on the host (numpy / Python ints) for the
    duration of one call, so that each data-dependent decision of F costs
    no device round trip. ``to_state`` writes everything back as tensors
    on the device. ``vectors`` is a private clone only when the caller will
    write rows (``writable=True``).

    The graph lives where ``host_graph`` says (default: on the host for a
    CPU state, on the card for a CUDA one). On the host, ``neighbors`` and
    ``levels`` are numpy mirrors and the plain version's beams
    (``kernels/qhnsw/ref.py``) work on them. On the card they stay in
    ``graph`` (a ``DeviceGraph``, of which this working state is lane
    ``lane``): inserts queue on ``pending`` and ``hnsw.link_pending`` links
    a run of them with one launch of the insert kernel; the host keeps
    only ``in_graph`` (which slots hold a graph node, what slot reuse needs)
    and the entry, and notes in ``dirty`` the slots whose ids / valid the
    card's copies must take before the next launch."""

    def __init__(self, state: MemoryState, writable: bool = False,
                 host_graph: bool | None = None,
                 graph: "DeviceGraph | None" = None, lane: int = 0):
        self.device = state.device
        self.contract_name = state.contract_name
        self.host_graph = (graph_on_host(self.device) if host_graph is None
                           else host_graph)
        self.ids = obs.host(state.ids).numpy().copy()
        self.valid = obs.host(state.valid).numpy().copy()
        self.links = obs.host(state.links).numpy().copy()
        self.meta = obs.host(state.meta).numpy().copy()
        self.entry = int(obs.host_item(state.hnsw_entry))
        self.cursor = int(obs.host_item(state.cursor))
        self.count = int(obs.host_item(state.count))
        self.version = int(obs.host_item(state.version))
        self.pending: list = []  # slots queued for the next insert launch
        if self.host_graph:
            self.vectors = state.vectors.clone() if writable else state.vectors
            self.neighbors = obs.host(state.hnsw_neighbors).numpy().copy()
            self.levels = obs.host(state.hnsw_levels).numpy().copy()
            return
        self.graph = DeviceGraph.of(state) if graph is None else graph
        self.lane = lane
        self.vectors = self.graph.vectors[lane]
        self._degree = state.hnsw_neighbors.shape[2]
        self._max_levels = state.hnsw_neighbors.shape[0]
        self.in_graph = obs.host(state.hnsw_levels).numpy() >= 0
        self.pending_key = None  # (ef_construction, fast) of that run
        self.run_entry = -1      # the entry as the run's first insert saw it
        self.dirty: list = []    # slots whose ids / valid changed

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def max_levels(self) -> int:
        return self.neighbors.shape[0] if self.host_graph else self._max_levels

    @property
    def degree(self) -> int:
        return self.neighbors.shape[2] if self.host_graph else self._degree

    def graph_nodes(self) -> np.ndarray:
        """Which slots hold a graph node (a stored level >= 0)."""
        return self.levels >= 0 if self.host_graph else self.in_graph.copy()

    def touch(self, slots) -> None:
        """Note host changes of these slots' ids / valid for the card."""
        if not self.host_graph:
            self.dirty.extend(np.asarray(slots, np.int64).reshape(-1).tolist())

    def to_state(self) -> MemoryState:
        dev = self.device

        def t(a):
            return torch.from_numpy(np.array(a, copy=True)).to(dev)

        def s(v, dt):
            return torch.tensor(v, dtype=dt, device=dev)

        if self.host_graph:
            neighbors, levels = t(self.neighbors), t(self.levels)
        else:
            if self.pending:
                raise RuntimeError("link the pending inserts first")
            neighbors = self.graph.neighbors[self.lane]
            levels = self.graph.levels[self.lane]
        return MemoryState(
            vectors=self.vectors, ids=t(self.ids), valid=t(self.valid),
            links=t(self.links), meta=t(self.meta),
            hnsw_neighbors=neighbors, hnsw_levels=levels,
            hnsw_entry=s(self.entry, torch.int32),
            cursor=s(self.cursor, torch.int32),
            count=s(self.count, torch.int32),
            version=s(self.version, torch.int64),
            contract_name=self.contract_name)
