"""The comparison that decides ``correct`` for the memory cells.

Every number here is a count of disagreements with the plain reference,
and every limit is 0: past the float -> fixed boundary the configuration
states bit-exactness. The reference gets the inputs the benchmark drew
(the documents' and queries' float32 values), never anything the port
made, except where it must follow the port's own graph: the HNSW graph
after tens of thousands of inserts is too long a chain to replay in every
run. So the first run of the fill is replayed from an empty graph, one
more run drawn from the seed is replayed from the port's graph before it
and compared with the port's graph after it, and the sampled reads are
searched over the port's final graph.

* ``rows``: stored Q16.16 words that differ from ``boundary.normalize``
  of the documents (every row written, fill and window).
* ``state``: F's bookkeeping that differs: acknowledged ids, ids, the
  live mask, links, meta, count, cursor, version, every row's level and
  the entry.
* ``graph``: adjacency, level and entry words that differ after those
  two replays.
* ``answers``: ids and scores that differ from the reference's HNSW
  search, for the sampled reads made after the last insert.
* ``scores``: answers of the sampled reads whose score is not the exact
  squared distance of the query to that id's row, whose id is not live,
  or that are out of (score, id) order.

The LM memory (``compare_lm``) cannot be exact before the boundary: the
port's LM computes in bfloat16, the reference in float32. There the
embedding gaps replace ``rows``: the median, the 90th and the 99th
percentile over one ingest call's documents of the distance between the
stored unit-norm row and the reference's normalised embedding, each with
the limit the configuration states (``check_limits``); past the boundary
the reference follows the port's rows.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import boundary, hnsw

# the limits of the exact comparisons; the embedding gaps' are the
# configuration's (``check_limits``)
MEMORY_LIMITS = {"rows": 0, "state": 0, "graph": 0}
READ_LIMITS = {"answers": 0, "scores": 0}
GAP_QUANTILES = (50, 90, 99)


def _mismatch(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))


def _expected_levels(n: int, max_levels: int, capacity: int) -> np.ndarray:
    raw = hnsw.level_of_id(np.arange(n, dtype=np.int64), max_levels)
    out = np.full(capacity, -1, np.int32)
    if n:
        out[:n] = np.minimum(raw, raw[0])   # the entry is the first row
    return out


def _graph(rows, n_valid: int, snap: Optional[dict], max_levels: int,
           degree: int) -> hnsw.Graph:
    """The reference's graph over ``rows`` with the first ``n_valid`` rows
    live, starting from ``snap`` (or empty)."""
    n = rows.shape[0]
    nb = np.full((max_levels, n, degree), -1, np.int32)
    lv = np.full(n, -1, np.int32)
    entry = -1
    if snap is not None:
        m = snap["n"]
        nb[:, :m] = snap["neighbors"]
        lv[:m] = snap["levels"]
        entry = snap["entry"]
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    return hnsw.Graph(rows, np.arange(n, dtype=np.int64), valid, nb, lv,
                      entry)


def _replay(g: hnsw.Graph, slots, ef_construction: int) -> dict:
    g.dists, g.rows_read = 0, set()
    for s in slots:
        hnsw.insert(g, s, ef_construction)
    return {"inserts": len(slots), "dists": g.dists,
            "rows": len(g.rows_read)}


def _graph_diff(g: hnsw.Graph, n: int, neighbors, levels, entry) -> int:
    return (_mismatch(g.neighbors[:, :n], neighbors[:, :n])
            + _mismatch(g.levels[:n], levels[:n]) + int(g.entry != entry))


def check_state(acked: List[int], state: dict, n: int) -> int:
    """F's bookkeeping against n documents inserted into a fresh memory."""
    cap = state["ids"].shape[0]
    exp_ids = np.full(cap, -1, np.int64)
    exp_ids[:n] = np.arange(n)
    bad = _mismatch(np.asarray(acked, np.int64), np.arange(n))
    bad += _mismatch(state["ids"], exp_ids)
    bad += _mismatch(state["valid"], exp_ids >= 0)
    bad += int(np.count_nonzero(state["links"] != -1))
    bad += int(np.count_nonzero(state["meta"] != 0))
    bad += sum(int(state[f] != n) for f in ("count", "cursor", "version"))
    bad += _mismatch(state["levels"],
                     _expected_levels(n, state["max_levels"], cap))
    bad += int(state["entry"] != (0 if n else -1))
    return bad


def check_graph(rows: np.ndarray, state: dict, first: dict,
                sampled: Optional[dict], ef_construction: int = 32) -> tuple:
    """Replays the fill's first run from an empty graph, and the ``sampled``
    run (``workload.Workload.sampled_run``) from the port's graph before
    it, over ``rows``. Returns (words that differ, the sampled run's
    work)."""
    L, deg = state["max_levels"], state["degree"]
    fs = range(first["n"])
    g0 = _graph(rows[:fs.stop], fs.stop, None, L, deg)
    _replay(g0, fs, ef_construction)
    bad = _graph_diff(g0, fs.stop, first["neighbors"], first["levels"],
                      first["entry"])
    if sampled is None:
        return bad, {"inserts": 0, "dists": 0, "rows": 0, "span": None}
    slots = sampled["slots"]
    after = sampled["after"] or state
    g = _graph(rows[:slots.stop], slots.stop, sampled["before"], L, deg)
    work = _replay(g, slots, ef_construction)
    bad += _graph_diff(g, slots.stop, after["neighbors"], after["levels"],
                       after["entry"])
    work.update(call=sampled["call"], span=sampled["span"])
    return bad, work


def _final_graph(rows: np.ndarray, state: dict) -> hnsw.Graph:
    """The port's graph after the window, over the reference's rows, every
    row live (no cell deletes)."""
    n, m = rows.shape[0], min(rows.shape[0], state["cursor"])
    nb = np.full((state["max_levels"], n, state["degree"]), -1, np.int32)
    nb[:, :m] = state["neighbors"][:, :m]
    lv = np.full(n, -1, np.int32)
    lv[:m] = state["levels"][:m]
    return hnsw.Graph(rows, np.arange(n, dtype=np.int64), np.ones(n, bool),
                      nb, lv, state["entry"])


def data_stats(r64: np.ndarray, r_sq: np.ndarray, q: np.ndarray,
               k: int) -> tuple:
    """The exact k nearest of each query, and two measures of how hard the
    data is to search: the local intrinsic dimension (the maximum-likelihood
    estimate over the k nearest distances) and the relative contrast (the
    mean distance over the nearest), each a mean over the queries."""
    qf = q.astype(np.float64)
    d = np.maximum((qf * qf).sum(1)[:, None] + r_sq[None, :]
                   - 2.0 * qf @ r64.T, 0.0)
    part = np.argpartition(d, k, axis=1)[:, :k]
    dd = np.take_along_axis(d, part, 1)
    o = np.lexsort((part, dd), axis=1)
    top, dd = np.take_along_axis(part, o, 1), np.take_along_axis(dd, o, 1)
    r = np.sqrt(dd)
    ok = r[:, 0] > 0
    lid = -1.0 / np.log(r[ok, :-1] / r[ok, -1:]).mean(1)
    contrast = np.sqrt(d[ok]).mean(1) / r[ok, 0]
    return top, float(lid.mean()), float(contrast.mean())


def check_reads(rows: np.ndarray, state: dict, ef: int, beam_reads: list,
                score_reads: list) -> tuple:
    """(answers that differ from the reference's search over the port's
    final graph, answers whose score is not exact or out of order, the
    searches' work, statistics of the beam-checked reads: recall@k against
    the exact k nearest, local intrinsic dimension, relative contrast)."""
    contract = state["contract"]
    n = rows.shape[0]
    answers_bad, searches, stats = 0, [], {}
    if beam_reads:
        g = _final_graph(rows, state)
        r64 = rows.astype(np.float64)
        r_sq = (r64 * r64).sum(1)
        hits = total = 0
        lids, contrasts = [], []
        for q_f32, k, ids, scores in beam_reads:
            q = boundary.normalize(q_f32, contract)
            g.dists, g.rows_read = 0, set()
            want = [hnsw.search(g, q[i], k, ef) for i in range(len(q))]
            answers_bad += _mismatch(np.stack([w[0] for w in want]), ids)
            answers_bad += _mismatch(np.stack([w[1] for w in want]), scores)
            searches.append({"queries": len(q), "dists": g.dists,
                             "rows": len(g.rows_read)})
            top, lid, contrast = data_stats(r64, r_sq, q, k)
            hits += sum(len(set(a.tolist()) & set(b.tolist()))
                        for a, b in zip(top, ids))
            total += top.size
            lids.append(lid)
            contrasts.append(contrast)
        stats = {"recall_at_k": hits / total, "lid": float(np.mean(lids)),
                 "relative_contrast": float(np.mean(contrasts))}
    score_bad = 0
    for q_f32, k, ids, scores in score_reads:
        q = boundary.normalize(q_f32, contract).astype(np.int64)
        ok = (ids >= 0) & (ids < n)
        safe = np.where(ok, ids, 0)
        diff = rows[safe].astype(np.int64) - q[:, None, :]
        exact = np.einsum("bkd,bkd->bk", diff, diff)
        score_bad += int(np.count_nonzero(~ok | (exact != scores)))
        order = (scores[:, 1:] > scores[:, :-1]) | (
            (scores[:, 1:] == scores[:, :-1]) & (ids[:, 1:] > ids[:, :-1]))
        score_bad += int(np.count_nonzero(~order))
    return answers_bad, score_bad, searches, stats


def compare(docs: np.ndarray, acked: List[int], state: dict, first: dict,
            sampled: Optional[dict], ef_construction: int = 32) -> tuple:
    """The embedding memory: ``docs`` float32 [N, d] in ingest order;
    ``state`` the port's memory after the window
    (``engines.embedding.System.state``); ``first`` its graph after the
    fill's first run; ``sampled`` the run drawn for the graph's check.
    Returns ({name: count}, work, the reference's rows)."""
    rows = boundary.normalize(docs, state["contract"])
    checks = {"rows": _mismatch(state["vectors"], rows),
              "state": check_state(acked, state, docs.shape[0])}
    checks["graph"], w_insert = check_graph(rows, state, first, sampled,
                                            ef_construction)
    return checks, {"hnsw_insert": w_insert}, rows


def embed_gaps(rows: np.ndarray, ref: np.ndarray, frac_bits: int
               ) -> np.ndarray:
    """Per document, the distance between its stored row (the port's
    unit-norm embedding in fixed point) and the reference's embedding,
    normalised: || row / 2^frac - e / |e| ||; a document with no row
    counts 2, the widest distance of two unit vectors."""
    e = ref.astype(np.float64)
    b = e / np.linalg.norm(e, axis=1, keepdims=True)
    m = min(len(rows), len(b))
    a = rows[:m].astype(np.float64) / float(1 << frac_bits)
    gaps = np.full(len(b), 2.0)
    gaps[:m] = np.linalg.norm(a - b[:m], axis=1)
    return gaps


def compare_lm(ref_embeddings: np.ndarray, checked: range, n_docs: int,
               acked: List[int], state: dict, first: dict,
               sampled: Optional[dict], ef_construction: int = 32,
               control_rows=None) -> tuple:
    """The LM memory: ``ref_embeddings`` float32 [m, d], the reference's
    pooled embeddings of the documents stored at ``checked``, of
    ``n_docs`` sent. Past the boundary the reference follows the port's
    rows (the LM's bfloat16 embeddings cannot equal float32 ones bit for
    bit): the graph replays run over ``state["vectors"]``.
    ``control_rows`` stand in for the port's rows at ``checked`` in a
    control run. Returns ({name: number}, work)."""
    rows = state["vectors"]
    frac = int(state["contract"].split(".")[1])
    mine = rows[checked.start:checked.stop] if control_rows is None \
        else control_rows
    gaps = embed_gaps(mine, ref_embeddings, frac)
    checks = {f"embed_gap_p{q}": float(np.quantile(gaps, q / 100.0))
              for q in GAP_QUANTILES}
    checks["state"] = check_state(acked, state, n_docs)
    work = {"hnsw_insert": {"inserts": 0, "dists": 0, "rows": 0},
            "gap_max": float(gaps.max())}
    if rows.shape[0] != n_docs:
        checks["graph"] = abs(n_docs - rows.shape[0]) + 1
        return checks, work
    checks["graph"], work["hnsw_insert"] = check_graph(
        rows, state, first, sampled, ef_construction)
    return checks, work
