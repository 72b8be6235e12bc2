"""Write the durability interop fixture from the JAX package, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/gen_golden_torch_durable.py

A small ``DurableStore`` (d = 16, capacity 64, Q16.16, 32 records per WAL
segment, the default 8192-byte chunks) in
``tests/fixtures/torch_port_durable/store/``: a seeded log that uses every
opcode (INSERT, DELETE, LINK, UNLINK, SET_META, an upsert, an absent-id
DELETE) plus zero-argument NOP runs, appended in pieces, with two
checkpoints and a WAL that rolls over into a second segment.
``expected.json`` beside it records the store's shape, its snapshots and
segments, ``recover()``'s ``(t, hash)`` and ``restore_at`` hashes at
several offsets. ``tests/test_torch_durability.py`` and ``chip_smoke.py``
copy the store to a temporary directory (opening a store may truncate a
torn tail) and recover it through the PyTorch port.
"""
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np

import repro  # noqa: F401  (enables x64)
from repro.core import boundary, commands, durability, machine
from repro.core.state import init_state

SEED = 20261017
DIM, CAPACITY, SEGMENT_RECORDS = 16, 64, 32
OUT = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures" / \
    "torch_port_durable"


def build_log(rng) -> commands.CommandLog:
    emb = rng.normal(size=(30, DIM)).astype(np.float32)
    raw = boundary.normalize_embedding(jnp.asarray(emb))
    log = commands.insert_batch(jnp.arange(24, dtype=jnp.int64), raw[:24])
    for src, dst in [(0, 5), (1, 5), (0, 7), (3, 4)]:
        log = log.concat(commands.link_cmd(src, dst, DIM))
    log = log.concat(commands.unlink_cmd(0, 7, DIM))
    log = log.concat(commands.set_meta_cmd(2, 0, 1234, DIM))
    log = log.concat(commands.set_meta_cmd(2, 1, -77, DIM))
    log = log.concat(machine._pad_log(commands.empty_log(DIM), 10))  # NOP run
    log = log.concat(commands.delete_batch(jnp.asarray([4, 9, 99]), DIM))
    log = log.concat(commands.insert_cmd(5, raw[24]))          # upsert
    log = log.concat(commands.insert_batch(
        jnp.arange(24, 28, dtype=jnp.int64), raw[25:29]))
    log = log.concat(machine._pad_log(commands.empty_log(DIM), 3))
    log = log.concat(commands.set_meta_cmd(2, 0, 4321, DIM))   # overwrite
    log = log.concat(commands.delete_cmd(9, DIM))              # absent id
    log = log.concat(commands.insert_cmd(9, raw[29]))          # id reuse
    log = log.concat(commands.link_cmd(9, 0, DIM))
    log = log.concat(commands.unlink_cmd(3, 4, DIM))
    return log


def main():
    rng = np.random.default_rng(SEED)
    log = build_log(rng)
    n = len(log)
    checkpoints = (30, 51)
    if OUT.exists():
        shutil.rmtree(OUT)
    genesis = init_state(CAPACITY, DIM)
    store = durability.DurableStore(OUT / "store", genesis,
                                    segment_records=SEGMENT_RECORDS)
    pieces = (0, 13, *checkpoints, n)
    state = genesis
    for a, b in zip(pieces, pieces[1:]):
        piece = log.slice(a, b)
        store.append(piece)
        state = machine.bulk_apply(state, piece)
        if b in checkpoints:
            store.checkpoint(jax.tree.map(np.asarray, state))
    state, h, t = durability.DurableStore(OUT / "store").recover()
    offsets = sorted({0, 7, 13, 24, 29, 30, 31, 32, 40, 51, 52, n - 1, n})
    expected = dict(
        seed=SEED, dim=DIM, capacity=CAPACITY, contract="Q16.16",
        segment_records=SEGMENT_RECORDS, n_commands=n,
        snapshots=store.snapshots(), segments=store.wal.segments(),
        recover={"t": t, "state_hash": f"{h:#018x}"},
        restore_at={str(off): f"{store.restore_at(off)[1]:#018x}"
                    for off in offsets})
    (OUT / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(json.dumps(expected["recover"]), f"{size} bytes")


if __name__ == "__main__":
    main()
