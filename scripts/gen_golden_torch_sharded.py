"""Write the sharding interop fixture from the JAX package, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/gen_golden_torch_sharded.py

``tests/fixtures/torch_port_sharded/`` receives:

* ``store/``: a small ``ShardedDurableStore`` (2 shards, d = 16, 64 rows per
  shard, Q16.16, 32 records per WAL segment, the default 8192-byte chunks):
  a seeded log that uses every opcode plus NOP runs, routed and appended
  in pieces (one of them as a group commit), with a checkpoint and a WAL
  tail past it;
* ``vlrs_manifest.bin`` + ``vlrs_chunks/``: the final state as one merged
  ``VLRS`` manifest over a shared chunk store;
* ``expected.json``: the store's ``recover()`` ``(t, merged hash,
  shard_ts)``, ``restore_at`` hashes at several offsets, the manifest's
  hash, and the sharded hashes of the flat golden recipe
  (``scripts/gen_golden_torch_port.py``: 512 inserts and 8 deletes at
  d = 2304 in capacity 4096) routed to 4 shards: merged ``hash_pytree``,
  ``content_hash`` and the exact / HNSW / coarse ``retrieval_hash``.

``tests/test_torch_shard_wal.py``, ``tests/test_torch_golden.py`` and
``chip_smoke.py`` copy the directories to a temporary place (opening a
store may truncate a torn tail) and hold the PyTorch port to them.
Deterministic: the same files on every run.
"""
import json
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np

import repro  # noqa: F401  (enables x64)
from repro.core import (boundary, commands, distributed, hashing, machine,
                        query, shard_wal, snapshot, wal)

SEED = 20261018
N_SHARDS, DIM, CAP_PER_SHARD, SEGMENT_RECORDS = 2, 16, 64, 32
GOLDEN = dict(seed=20251222, n_insert=512, dim=2304, capacity=4096,
              n_delete=8, n_query=64, k=10, ef=64, ef_coarse=64, n_shards=4)
OUT = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures" / \
    "torch_port_sharded"


def build_batches(rng):
    """Batches of a seeded history: every opcode, upserts, NOP runs."""
    emb = rng.normal(size=(70, DIM)).astype(np.float32)
    raw = boundary.normalize_embedding(jnp.asarray(emb))
    b = [commands.insert_batch(jnp.arange(40, dtype=jnp.int64), raw[:40])]
    log = commands.link_cmd(0, 5, DIM)
    for cmd in (commands.link_cmd(1, 5, DIM), commands.link_cmd(3, 4, DIM),
                commands.set_meta_cmd(2, 0, 1234, DIM),
                commands.unlink_cmd(0, 5, DIM)):
        log = log.concat(cmd)
    b.append(log.concat(machine._pad_log(commands.empty_log(DIM), 6)))
    b.append(commands.delete_batch(jnp.asarray([4, 9, 31, 99]), DIM))
    b.append(commands.insert_batch(jnp.arange(40, 60, dtype=jnp.int64),
                                   raw[40:60]))
    b.append(commands.insert_cmd(5, raw[60]).concat(
        commands.set_meta_cmd(2, 1, -77, DIM)))
    b.append(commands.insert_batch(jnp.asarray([9, 4, 61, 62], jnp.int64),
                                   raw[61:65]))
    b.append(commands.delete_batch(jnp.asarray([0, 1, 2, 3, 50]), DIM))
    return b


def golden_sharded():
    """The flat golden recipe, routed to ``GOLDEN["n_shards"]`` shards."""
    g, ns = GOLDEN, GOLDEN["n_shards"]
    rng = np.random.default_rng(g["seed"])
    emb = rng.normal(size=(g["n_insert"], g["dim"])).astype(np.float32)
    queries = rng.normal(size=(g["n_query"], g["dim"])).astype(np.float32)
    dead = np.sort(rng.choice(g["n_insert"], size=g["n_delete"],
                              replace=False)).astype(np.int64)
    st = distributed.init_sharded_host(ns, g["capacity"] // ns, g["dim"])
    raw = boundary.normalize_embedding(jnp.asarray(emb))
    st = shard_wal.bulk_apply_sharded(st, commands.insert_batch(
        jnp.arange(g["n_insert"], dtype=jnp.int64), raw), ns)
    st = shard_wal.bulk_apply_sharded(st, commands.delete_batch(
        jnp.asarray(dead), g["dim"]), ns)
    q = boundary.admit_query(jnp.asarray(queries))
    k = g["k"]
    ex = shard_wal.exact_search_sharded(st, ns, q, k)
    hn = shard_wal.hnsw_search_sharded(st, ns, q, k, ef=g["ef"])
    co = shard_wal.coarse_search_sharded(st, ns, q, k,
                                         ef_coarse=g["ef_coarse"])
    return dict(g, hash_pytree=hashing.hash_pytree(st),
                content_hash=hashing.content_hash(st),
                retrieval_hash={"exact": query.retrieval_hash(*ex),
                                "hnsw": query.retrieval_hash(*hn),
                                "coarse": query.retrieval_hash(*co)})


def main():
    rng = np.random.default_rng(SEED)
    batches = build_batches(rng)
    if OUT.exists():
        shutil.rmtree(OUT)
    genesis = distributed.init_sharded_host(N_SHARDS, CAP_PER_SHARD, DIM)
    store = shard_wal.ShardedDurableStore(OUT / "store", genesis,
                                          n_shards=N_SHARDS,
                                          segment_records=SEGMENT_RECORDS)
    state, marks = genesis, [0]
    for i, b in enumerate(batches):
        if i == 3:  # two batches as one group commit
            continue
        group = [b] if i != 2 else [b, batches[3]]
        if len(group) == 1:
            store.append(b)
        else:
            writer = wal.GroupCommitWriter(store, wal.GroupCommitPolicy(
                max_batch=1 << 20, max_delay_s=3600))
            for g in group:
                writer.submit(g)
            writer.flush()
        for g in group:
            state = shard_wal.bulk_apply_sharded(state, g, N_SHARDS)
            marks.append(int(np.asarray(state.version)[0]))
        if i == 4:
            store.checkpoint(state)
    reopened = shard_wal.ShardedDurableStore(OUT / "store")
    _, h, t = reopened.recover()
    assert h == hashing.hash_pytree(state)
    chunks = snapshot.ChunkStore(OUT / "vlrs_chunks")
    manifest = distributed.snapshot_sharded(state, N_SHARDS, chunks)
    (OUT / "vlrs_manifest.bin").write_bytes(manifest)
    offsets = sorted(set(marks) | {1, marks[2] + 1, t - 1})
    expected = dict(
        seed=SEED, n_shards=N_SHARDS, dim=DIM,
        capacity_per_shard=CAP_PER_SHARD, contract="Q16.16",
        segment_records=SEGMENT_RECORDS, batch_cursors=marks,
        merged_records=reopened.merged_records(),
        recover={"t": t, "hash": f"{h:#018x}",
                 "shard_ts": reopened.shard_ts()},
        restore_at={str(off): f"{reopened.restore_at(off)[1]:#018x}"
                    for off in offsets},
        vlrs_hash=f"{hashing.hash_pytree(state):#018x}",
        golden=golden_sharded())
    (OUT / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(json.dumps(expected["recover"]), f"{size} bytes")


if __name__ == "__main__":
    main()
