"""Write the port's golden fixture from the JAX package, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/gen_golden_torch_port.py

A seeded log at the real width: 512 INSERTs of d = 2304 (gemma2-2b's
d_model) into capacity 4096 through ``bulk_apply``, then 8 DELETEs, then
64 queries with k = 10 on the exact, the HNSW (ef = 64) and the coarse
routes. The fixture holds the seed, the sizes, ``hash_pytree``,
``content_hash``, the code table's ``table_hash`` and one
``retrieval_hash`` per route: the coarse route at ``ef_coarse = 64``
(partial coverage, so the candidate set depends on every code bit) and at
``ef_coarse = 4096`` (full coverage); ``tests/test_torch_golden.py`` and
``chip_smoke.py`` hold the PyTorch port to it. The input recipe is the
one in ``tests/_torch_golden.py`` (restated here so that this script runs
the JAX package alone).
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np

import repro  # noqa: F401  (enables x64)
from repro.core import (boundary, codes, commands, hashing, machine, query,
                        search)
from repro.core.state import init_state

SPEC = dict(seed=20251222, n_insert=512, dim=2304, capacity=4096,
            n_delete=8, n_query=64, k=10, ef=64, ef_coarse=64,
            ef_coarse_cover=4096)
OUT = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures" / \
    "torch_port_golden.json"


def main():
    rng = np.random.default_rng(SPEC["seed"])
    emb = rng.normal(size=(SPEC["n_insert"], SPEC["dim"])).astype(np.float32)
    queries = rng.normal(size=(SPEC["n_query"], SPEC["dim"])).astype(np.float32)
    dead = np.sort(rng.choice(SPEC["n_insert"], size=SPEC["n_delete"],
                              replace=False)).astype(np.int64)
    st = init_state(SPEC["capacity"], SPEC["dim"])
    raw = boundary.normalize_embedding(jnp.asarray(emb))
    st = machine.bulk_apply(st, commands.insert_batch(
        jnp.arange(SPEC["n_insert"], dtype=jnp.int64), raw))
    st = machine.bulk_apply(st, commands.delete_batch(jnp.asarray(dead),
                                                      SPEC["dim"]))
    q = boundary.admit_query(jnp.asarray(queries))
    ex = search.exact_search(st, q, SPEC["k"])
    hn = query.batched_hnsw_search(st, q, SPEC["k"], ef=SPEC["ef"])
    table = codes.build(st)
    co, cc = (search.coarse_search(st, table, q, SPEC["k"], ef_coarse=ef)
              for ef in (SPEC["ef_coarse"], SPEC["ef_coarse_cover"]))
    out = dict(SPEC)
    out.update(hash_pytree=hashing.hash_pytree(st),
               content_hash=hashing.content_hash(st),
               table_hash=codes.table_hash(table),
               retrieval_hash={"exact": query.retrieval_hash(*ex),
                               "hnsw": query.retrieval_hash(hn[0], hn[1]),
                               "coarse": query.retrieval_hash(*co),
                               "coarse_cover": query.retrieval_hash(*cc)})
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
