"""Exact deterministic k-NN over the fixed-point arena, and the
compressed tier's coarse route.

Scoring is a wide integer matmul and selection a (score, id)
lexicographic top-k, so results — tie order included — are bit-identical
everywhere. Scores are wide (unshifted Q(2f)) int64 values, lower is
better for both metrics (dot scores are negated). ``coarse_search`` scans
the int8 code table (qcoarse) and re-ranks its candidates exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import codes as codes_lib
from repro_torch.core.sorting import sort2
from repro_torch.core.state import MemoryState
from repro_torch.kernels.qcoarse import ops as qcoarse_ops
from repro_torch.kernels.qgemm import ops as qgemm_ops
from repro_torch.kernels.qtopk import ops as qtopk_ops

INF = 1 << 62
TOMBSTONE_ID = 1 << 62  # the id dead rows sort under (last among ties)

METRIC_L2 = "l2"
METRIC_DOT = "dot"


def _kernel_route(x: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel or x.device.type == "cuda"


def _wide_dot_kernel(queries_raw: torch.Tensor, db_raw: torch.Tensor
                     ) -> torch.Tensor:
    """The int64 product of the rows through qgemm, equal to the plain
    int64 matmul bit for bit (modulo 2^64) for every storage type.

    Mixed operand types are promoted to the wider one first. Depths above
    qgemm's ``MAX_DIM`` are cut into chunks of at most ``MAX_DIM`` (each
    a contiguous copy of its columns) whose int64 products are summed:
    integer sums are exact and order-invariant, and wrap the same way."""
    dtype = torch.promote_types(queries_raw.dtype, db_raw.dtype)
    q, db = queries_raw.to(dtype), db_raw.to(dtype)
    d = q.shape[-1]
    if d <= qgemm_ops.MAX_DIM:
        return qgemm_ops.qgemm(q.contiguous(), db.contiguous())
    out = None
    for k0 in range(0, d, qgemm_ops.MAX_DIM):
        k1 = min(d, k0 + qgemm_ops.MAX_DIM)
        part = qgemm_ops.qgemm(q[:, k0:k1].contiguous(),
                               db[:, k0:k1].contiguous())
        out = part if out is None else out + part
    return out


def score_block(queries_raw: torch.Tensor, db_raw: torch.Tensor,
                metric: str = METRIC_L2, use_kernel: bool = False
                ) -> torch.Tensor:
    """Wide integer scores [nq, nd] int64; lower = better.

    Kernel dispatch goes by device, not by ``use_kernel``: a CUDA tensor
    always scores through the qgemm CUDA kernel (``_wide_dot_kernel``:
    every storage type and depth), a CPU tensor through the plain int64
    product. The reference's flag chose between two bit-identical
    implementations; on the card there is only one, and the flag stays on
    the plans only so that they compare equal."""
    if _kernel_route(queries_raw, use_kernel):
        wide_dot = _wide_dot_kernel(queries_raw, db_raw)
    else:
        wide_dot = torch.matmul(queries_raw.to(torch.int64),
                                db_raw.to(torch.int64).T)
    if metric == METRIC_DOT:
        return -wide_dot
    if metric == METRIC_L2:
        qq = torch.sum(queries_raw.to(torch.int64) ** 2, dim=-1)
        nn = torch.sum(db_raw.to(torch.int64) ** 2, dim=-1)
        return qq[:, None] - 2 * wide_dot + nn[None, :]
    raise ValueError(f"unknown metric {metric!r}")


def topk_by_score(scores: torch.Tensor, ids: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest scores with (score, id) tie-break (full sort)."""
    nq, n = scores.shape
    s, i = sort2(scores, ids[None, :].expand(nq, n))
    return s[:, :k], i[:, :k]


def _topk_by_score_kernel(scores: torch.Tensor, ids: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qtopk-backed top-k, bit-identical to :func:`topk_by_score`,
    min(k, n) columns wide as it is.

    The kernel tie-breaks on int32 keys; ids are int64, so each id is
    replaced by its rank among the sorted ids (strictly monotone for the
    unique live ids; dead rows share id 2^62 and score INF, and every INF
    result is normalized to (-1, INF) by the caller). qtopk is asked for
    min(k, n): at k > n its own width (the reference kernel's) can exceed
    n with pad columns, where the full sort gives n."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    ranks = torch.empty((n,), dtype=torch.int32, device=ids.device)
    ranks[order] = torch.arange(n, dtype=torch.int32, device=ids.device)
    sorted_ids = ids[order]
    s, r = qtopk_ops.qtopk(scores.contiguous(), ranks, min(k, n))
    return s, sorted_ids[torch.clamp(r, 0, n - 1).to(torch.int64)]


def exact_search(state: MemoryState, queries_raw: torch.Tensor, k: int, *,
                 metric: str = METRIC_L2, use_kernel: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN over all live rows: (ids [nq, k] int64, scores [nq, k] int64).
    Missing results (fewer than k live rows) are (-1, INF). On the card the
    scan is qgemm + qtopk (see ``score_block`` for the dispatch rule)."""
    scores = score_block(queries_raw, state.vectors, metric, use_kernel)
    scores = torch.where(state.valid[None, :], scores, INF)
    ids = torch.where(state.valid, state.ids, TOMBSTONE_ID)
    if _kernel_route(queries_raw, use_kernel):
        s, i = _topk_by_score_kernel(scores, ids, k)
    else:
        s, i = topk_by_score(scores, ids, k)
    found = s < INF
    return torch.where(found, i, -1), torch.where(found, s, INF)


def merge_candidates(scores: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a [..., m] candidate pool by (score, id): the one combine
    every fan-in path shares; invariant to any permutation of the pool."""
    i_key = torch.where(scores < INF, ids, TOMBSTONE_ID)
    s_sorted, i_sorted = sort2(scores, i_key)
    s_out = s_sorted[..., :k]
    i_out = i_sorted[..., :k]
    return s_out, torch.where(s_out < INF, i_out, -1)


def coarse_search(state: MemoryState, table: codes_lib.CodeTable,
                  queries_raw: torch.Tensor, k: int, *, ef_coarse: int,
                  metric: str = METRIC_L2, use_kernel: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed-tier k-NN: int8 coarse scan, exact Q16.16 re-rank.

    1. Coarse scan: integer scores of the query weights against the code
       table (qcoarse on the card), ``norms - 2*S`` for L2 and ``-S`` for
       dot, dead rows at INF; candidates are the ``ef = min(ef_coarse,
       capacity)`` best by (approx score, slot) (qtopk on the card).
    2. Re-rank: the candidates' exact wide scores, merged by
       ``merge_candidates`` with the (score, id) tie-break of every read
       path. The exact scores come from one ``score_block`` of the queries
       against the union of the candidate slots (qgemm on the card),
       gathered per query: integer sums are order-invariant, so they equal
       the full scan's scores without a [nq, ef, d] gather.

    Whenever the candidates cover every live row (``ef_coarse >=
    live_count``) the result equals ``exact_search``'s bit for bit.
    Returns (ids [nq, k] int64, scores [nq, k] int64), missing results
    (-1, INF). Dispatch goes by device, as in ``score_block``."""
    n = state.capacity
    ef = min(ef_coarse, n)
    if ef < k:
        raise ValueError(
            f"coarse route needs ef_coarse >= k (got ef_coarse={ef_coarse}, "
            f"k={k}, capacity={n}): a candidate set of {ef} cannot "
            f"yield {k} results")

    w = codes_lib.query_weights(queries_raw, table, metric)
    s = qcoarse_ops.qcoarse(w, table.codes)
    if metric == METRIC_L2:
        approx = table.norms[None, :] - 2 * s
    else:
        approx = -s
    approx = torch.where(state.valid[None, :], approx, INF)

    # candidates by (approx score, slot): slots are unique, so the set is
    # deterministic; INF candidates may differ between the kernel and the
    # full sort, but every slot is in range and INF ones are masked below
    slots = torch.arange(n, dtype=torch.int64, device=approx.device)
    if _kernel_route(queries_raw, use_kernel):
        s_c, slot_c = _topk_by_score_kernel(approx, slots, ef)
    else:
        s_c, slot_c = topk_by_score(approx, slots, ef)

    uniq, col = torch.unique(slot_c, return_inverse=True)
    exact = torch.gather(score_block(queries_raw, state.vectors[uniq], metric,
                                     use_kernel), 1, col)       # [nq, ef]
    live = state.valid[slot_c] & (s_c < INF)
    exact = torch.where(live, exact, INF)
    cand_ids = torch.where(live, state.ids[slot_c], TOMBSTONE_ID)
    s_out, i_out = merge_candidates(exact, cand_ids, k)
    return i_out, s_out


def merge_topk(scores_a: torch.Tensor, ids_a: torch.Tensor,
               scores_b: torch.Tensor, ids_b: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted top-k lists into one (associative, commutative)."""
    return merge_candidates(torch.cat([scores_a, scores_b], dim=-1),
                            torch.cat([ids_a, ids_b], dim=-1), k)
