"""Batched deterministic query engine: planner, routes, retrieval hash.

``plan_query`` and ``QueryPlan`` are the reference's host logic, verbatim,
so the port's plans compare equal to the reference's. ``execute_plan``
runs the exact route (``search.exact_search``: qgemm + qtopk on the card),
the HNSW route (``batched_hnsw_search``: qhnsw on the card) or the
compressed tier's coarse route (``search.coarse_search``: qcoarse + qtopk
+ qgemm on the card).
``sharded_query`` fans the planned route out over a sharded-layout state
on a device list (``distributed``), ending in the one order-invariant
``(score, id)`` merge; ``sharded_host_query`` is that fan-out with every
shard on the state's device (the sharded engine's read path).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import codes as codes_lib
from repro_torch.core import hashing
from repro_torch.core import search
from repro_torch.core.state import MemoryState
from repro_torch.kernels import qhnsw

INF = search.INF

ROUTE_EXACT = "exact"
ROUTE_HNSW = "hnsw"
ROUTE_COARSE = "coarse"


def batched_hnsw_search(state: MemoryState, queries_raw: torch.Tensor, k: int,
                        *, ef: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ANN for B queries: (ids [B,k], dists [B,k], slots [B,k]) on the
    state's device, each row exactly ``hnsw.hnsw_search`` of that query:
    one launch of the qhnsw search kernel on the card (one CTA per query),
    the plain version's lockstep beams on the CPU."""
    return qhnsw.qhnsw_search(state, queries_raw, k, ef)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A replayable routing decision: pure data, equal for equal facts."""
    route: str               # ROUTE_EXACT | ROUTE_HNSW | ROUTE_COARSE
    k: int
    ef: int
    use_kernel: bool         # kept so plans equal the reference's plans
    live_count: int          # the fact the decision was made from
    reason: str
    served_by: str = "primary"
    ef_coarse: int = 0
    dim: int = 0
    graph_gen: int = 0


def plan_query(live_count: int, k: int, ef: int, *,
               use_kernel: bool = False, exact_threshold: int = 1024,
               route: str = "auto", ef_coarse: int = 0,
               dim: int = 0, graph_gen: int = 0) -> QueryPlan:
    """Pick exact-scan vs HNSW vs the coarse tier from static host facts.

    Rules, first match wins: 1. a forced route (hnsw with k > ef, or coarse
    with k > ef_coarse, raises); 2. k > ef → exact; 3. live_count <=
    exact_threshold → exact; 4. ef >= live_count → exact; 5. 0 < k <=
    ef_coarse, 4*ef_coarse <= 3*live_count and dim <= 8192 → coarse;
    6. otherwise HNSW."""
    def mk(r, why):
        return QueryPlan(route=r, k=k, ef=ef, use_kernel=use_kernel,
                         live_count=live_count, reason=why,
                         ef_coarse=ef_coarse, dim=dim, graph_gen=graph_gen)

    if route != "auto":
        if route not in (ROUTE_EXACT, ROUTE_HNSW, ROUTE_COARSE):
            raise ValueError(f"unknown route {route!r}")
        if route == ROUTE_HNSW and k > ef:
            raise ValueError(f"route='hnsw' needs k <= ef, got k={k} ef={ef}")
        if route == ROUTE_COARSE and k > ef_coarse:
            raise ValueError(f"route='coarse' needs k <= ef_coarse, "
                             f"got k={k} ef_coarse={ef_coarse}")
        return mk(route, "forced")
    if k > ef:
        return mk(ROUTE_EXACT, f"k={k} > ef={ef}")
    if live_count <= exact_threshold:
        return mk(ROUTE_EXACT, f"live={live_count} <= {exact_threshold}")
    if ef >= live_count:
        return mk(ROUTE_EXACT, f"ef={ef} >= live={live_count}")
    if (0 < k <= ef_coarse and 4 * ef_coarse <= 3 * live_count
            and dim <= 8192):
        return mk(ROUTE_COARSE,
                  f"int8 scan + {ef_coarse}-rerank beats exact bytes at "
                  f"live={live_count}, dim={dim}")
    return mk(ROUTE_HNSW, f"live={live_count}, k={k}, ef={ef}")


def execute_plan(state: MemoryState, queries_raw: torch.Tensor, k: int,
                 plan: QueryPlan, *, metric: str = search.METRIC_L2,
                 codes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the planned route: (ids [B,k] int64, wide scores [B,k] int64).

    The coarse route takes the caller's maintained ``codes.CodeTable`` when
    given and otherwise builds it from the state on the spot; the table is
    a pure function of the live rows, so both give the same bits."""
    if plan.route == ROUTE_EXACT:
        return search.exact_search(state, queries_raw, k, metric=metric,
                                   use_kernel=plan.use_kernel)
    if plan.route == ROUTE_COARSE:
        table = codes if codes is not None else codes_lib.build(state)
        return search.coarse_search(state, table, queries_raw, k,
                                    ef_coarse=plan.ef_coarse, metric=metric,
                                    use_kernel=plan.use_kernel)
    ids, dists, _ = batched_hnsw_search(state, queries_raw, k, ef=plan.ef)
    return ids, dists


# --------------------------------------------------------------------------- #
# shard fan-out
# --------------------------------------------------------------------------- #


def sharded_query(devices, state: MemoryState, queries_raw: torch.Tensor,
                  k: int, plan: QueryPlan, *, metric: str = search.METRIC_L2,
                  tables=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The planned route fanned out across a device list, one shard per
    device (``distributed``), ending in the one merge.

    Exact route: bit-identical to the single-kernel scan on the same live
    content. HNSW route: deterministic for a fixed shard count; equal to
    the flat graph whenever every beam is exhaustive over its slice.
    Coarse route: equal to flat exact whenever every shard's candidates
    cover its slice; ``tables`` carries per-shard code tables, absent,
    each shard builds its table from its slice. (The reference's mesh
    fan-out has no coarse path and runs a coarse plan as HNSW; its host
    fan-out, ``sharded_host_query``, runs it as here.)"""
    from repro_torch.core import distributed  # distributed imports us lazily

    if plan.route == ROUTE_EXACT:
        return distributed.distributed_search(
            devices, state, queries_raw, k, metric=metric,
            use_kernel=plan.use_kernel)
    if plan.route == ROUTE_COARSE:
        return distributed.distributed_coarse_search(
            devices, state, queries_raw, k, ef_coarse=plan.ef_coarse,
            metric=metric, use_kernel=plan.use_kernel, tables=tables)
    return distributed.distributed_hnsw_search(devices, state, queries_raw,
                                               k, ef=plan.ef)


def sharded_host_query(state: MemoryState, n_shards: int,
                       queries_raw: torch.Tensor, k: int, plan: QueryPlan, *,
                       metric: str = search.METRIC_L2, tables=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sharded_query`` with every shard on the state's own device: the
    sharded engine's read path."""
    return sharded_query([state.device] * n_shards, state, queries_raw, k,
                         plan, metric=metric, tables=tables)


def retrieval_hash(ids, scores) -> int:
    """Platform-invariant hash of a retrieval set: two runs agree iff every
    (id, score) bit agrees."""
    return hashing.hash_pytree((torch.as_tensor(ids).to(torch.int64),
                                torch.as_tensor(scores).to(torch.int64)))
