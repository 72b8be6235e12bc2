"""The golden check: the port reproduces, on any device, hashes that the
reference package wrote at the real width (``scripts/gen_golden_torch_port.py``
→ ``tests/fixtures/torch_port_golden.json``). Used by
``tests/test_torch_golden.py`` and, loaded by path, by ``chip_smoke.py``;
it imports ``torch`` and ``repro_torch`` only.

The recipe: ``n_insert`` float32 embeddings and ``n_query`` queries drawn
from ``numpy.random.default_rng(seed)`` (normal, unit scale, in that
order), then ``n_delete`` distinct ids to delete; INSERT ids 0..n-1 as one
canonical batch through ``bulk_apply``, the deletes as one batch, then
k-NN on the exact route, the HNSW route and the coarse route (the code
table of the final state, at ``ef_coarse`` and at ``ef_coarse_cover``).
The sharded check (``check_sharded``) routes the same batches to
``n_shards`` shards (``scripts/gen_golden_torch_sharded.py`` →
``tests/fixtures/torch_port_sharded/expected.json``, key ``golden``) and
reads through the sharded twins, with per-shard code tables.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict

import numpy as np
import torch

from repro_torch.core import (boundary, codes, commands, distributed,
                              hashing, machine, query, search, shard_wal)
from repro_torch.core.state import init_state

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_port_golden.json")
SHARDED_FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
                   / "torch_port_sharded" / "expected.json")


def make_inputs(seed: int, n_insert: int, dim: int, n_query: int,
                n_delete: int):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n_insert, dim)).astype(np.float32)
    queries = rng.normal(size=(n_query, dim)).astype(np.float32)
    dead = np.sort(rng.choice(n_insert, size=n_delete, replace=False))
    return emb, queries, dead.astype(np.int64)


def load_spec(path=FIXTURE) -> Dict:
    return json.loads(pathlib.Path(path).read_text())


def run(spec: Dict, device) -> Dict:
    """The port's hashes for ``spec`` on ``device``."""
    emb, queries, dead = make_inputs(spec["seed"], spec["n_insert"],
                                     spec["dim"], spec["n_query"],
                                     spec["n_delete"])
    dev = torch.device(device)
    st = init_state(spec["capacity"], spec["dim"], device=dev)
    raw = boundary.normalize_embedding(torch.from_numpy(emb).to(dev))
    ids = torch.arange(spec["n_insert"], dtype=torch.int64, device=dev)
    st = machine.bulk_apply(st, commands.insert_batch(ids, raw))
    st = machine.bulk_apply(st, commands.delete_batch(
        torch.from_numpy(dead).to(dev), spec["dim"]))
    q = boundary.admit_query(torch.from_numpy(queries).to(dev))
    k = spec["k"]
    ex_ids, ex_s = search.exact_search(st, q, k)
    hn_ids, hn_s, _ = query.batched_hnsw_search(st, q, k, ef=spec["ef"])
    table = codes.build(st)
    coarse = {name: query.retrieval_hash(*search.coarse_search(
        st, table, q, k, ef_coarse=spec[key]))
        for name, key in (("coarse", "ef_coarse"),
                          ("coarse_cover", "ef_coarse_cover"))}
    return {"hash_pytree": hashing.hash_state_device(st),
            "content_hash": hashing.content_hash(st),
            "table_hash": codes.table_hash(table),
            "retrieval_hash": {"exact": query.retrieval_hash(ex_ids, ex_s),
                               "hnsw": query.retrieval_hash(hn_ids, hn_s),
                               **coarse}}


def check(device, path=FIXTURE) -> Dict:
    """Run the recipe and raise unless every hash equals the fixture's."""
    spec = load_spec(path)
    got = run(spec, device)
    want = {key: spec[key] for key in got}
    if got != want:
        raise AssertionError(f"golden mismatch on {device}: got {got}, "
                             f"fixture {want}")
    return got


def run_sharded(spec: Dict, device) -> Dict:
    """The port's sharded hashes for ``spec`` on ``device``: the recipe's
    batches routed to ``spec["n_shards"]`` shards."""
    emb, queries, dead = make_inputs(spec["seed"], spec["n_insert"],
                                     spec["dim"], spec["n_query"],
                                     spec["n_delete"])
    dev = torch.device(device)
    ns = spec["n_shards"]
    st = distributed.init_sharded_host(ns, spec["capacity"] // ns,
                                       spec["dim"], device=dev)
    raw = boundary.normalize_embedding(torch.from_numpy(emb).to(dev))
    ids = torch.arange(spec["n_insert"], dtype=torch.int64, device=dev)
    st = shard_wal.bulk_apply_sharded(st, commands.insert_batch(ids, raw), ns)
    st = shard_wal.bulk_apply_sharded(st, commands.delete_batch(
        torch.from_numpy(dead).to(dev), spec["dim"]), ns)
    q = boundary.admit_query(torch.from_numpy(queries).to(dev))
    k = spec["k"]
    routes = {
        "exact": shard_wal.exact_search_sharded(st, ns, q, k),
        "hnsw": shard_wal.hnsw_search_sharded(st, ns, q, k, ef=spec["ef"]),
        "coarse": shard_wal.coarse_search_sharded(
            st, ns, q, k, ef_coarse=spec["ef_coarse"])}
    return {"hash_pytree": hashing.hash_state_device(st),
            "content_hash": hashing.content_hash(st),
            "retrieval_hash": {name: query.retrieval_hash(*ans)
                               for name, ans in routes.items()}}


def check_sharded(device, path=SHARDED_FIXTURE) -> Dict:
    """Run the sharded recipe and raise unless every hash equals the
    fixture's."""
    spec = json.loads(pathlib.Path(path).read_text())["golden"]
    got = run_sharded(spec, device)
    want = {key: spec[key] for key in got}
    if got != want:
        raise AssertionError(f"sharded golden mismatch on {device}: got "
                             f"{got}, fixture {want}")
    return got
