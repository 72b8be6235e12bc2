#!/usr/bin/env python3
"""Build the qhnsw kernels and hold them bit for bit against their plain
versions on one NVIDIA GPU, at small shapes.

    python3 scripts/probe_qhnsw.py

The short first call after an edit of ``csrc/qhnsw.cu``: it prints the
card, the compiler's register and spill report per kernel instance, then
runs each case on the card (kernel) and on the CPU (plain version) and
compares every output array: the insert kernel on a run of stored rows
(fast and default variants, and the default one that m > ef_construction
forces), the re-link (blank graph plus one run) and the batched search
(k below and above ef), on every storage type (Q8.8 int16, Q16.16 int32,
Q32.32 int64), with tombstones, on rows whose sums of squares wrap, on an
empty graph, over 3 shards in one launch and with workspaces past a
block's shared memory (a 2^21-row arena's bitmaps, a d = 30000 query
row); then ``machine.replay``,
``machine.bulk_apply`` and ``shard_wal.apply_routed_device`` on random
logs of inserts, upserts, deletes, links and meta, card against CPU, hash
for hash. Each case prints the cluster size (CTAs per beam) its launches
took. Before the cases it measures one memory round trip
(``kernel.round_trip_ns``: one thread's dependent loads over a random
cycle of 256 MB, past L2, and of 1 MB, inside it), the link of the chain
bound in ``PERF.md``. Exits non-zero on any mismatch. ``chip_smoke.py``
holds the kernels again at phase 3's width (phase 2) and times them; the
cluster design's edge cases (dimensions no cluster size divides, repeated
slots, a sentinel lane) are the ``cuda`` tests of
``tests/test_torch_qhnsw_cluster.py``.
"""
import sys
import time
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BAD = []


def same(torch, name, got, want) -> None:
    if isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            same(torch, f"{name}[{i}]", g, w)
        return
    g, w = got.cpu(), want.cpu()
    if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
        diff = "shape" if g.shape != w.shape else int((g != w).sum())
        BAD.append(name)
        print(f"[probe] MISMATCH {name}: {diff}", flush=True)


def graph_of(st):
    return (st.hnsw_neighbors, st.hnsw_levels, st.hnsw_entry)


def stored_state(torch, contract, cap, d, n_linked, n_stored, n_dead, degree,
                 levels, rng, lo, hi):
    """On the CPU: n_linked rows inserted and linked, n_dead of them
    deleted, then n_stored more rows stored (vectors, ids, valid) but not
    linked. Returns (state, the stored slots)."""
    import dataclasses
    from repro_torch.core import commands, machine
    from repro_torch.core.state import init_state
    st = init_state(cap, d, contract=contract, device="cpu",
                    hnsw_degree=degree, hnsw_levels=levels)
    vecs = torch.from_numpy(rng.integers(lo, hi, (n_linked + n_stored, d)))
    st = machine.bulk_apply(st, commands.insert_batch(
        torch.arange(n_linked), vecs[:n_linked], contract))
    if n_dead:
        dead = rng.choice(n_linked, n_dead, replace=False)
        st = machine.bulk_apply(st, commands.delete_batch(
            torch.from_numpy(dead), d, contract, device="cpu"))
    free = torch.nonzero(~st.valid).reshape(-1)[:n_stored]
    vectors, ids, valid = st.vectors.clone(), st.ids.clone(), st.valid.clone()
    vectors[free] = vecs[n_linked:].to(vectors.dtype)
    ids[free] = torch.arange(10**6, 10**6 + n_stored)
    valid[free] = True
    return dataclasses.replace(st, vectors=vectors, ids=ids, valid=valid), free


def flat_cases(torch, dev, rng) -> None:
    from repro_torch.core import contracts, hnsw
    from repro_torch.kernels.qhnsw import kernel, ops, ref
    cases = [("Q16.16", contracts.Q16_16, -2**16, 2**16),
             ("Q8.8", contracts.Q8_8, -2**14, 2**14),
             ("Q32.32", contracts.Q32_32, -2**33, 2**33),
             ("Q16.16 wrapping", contracts.Q16_16, -2**31, 2**31 - 1)]
    for name, contract, lo, hi in cases:
        for degree, levels, ef_c in ((16, 4, 32), (8, 3, 3)):
            st, slots = stored_state(torch, contract, 512, 40, 200, 150, 12,
                                     degree, levels, rng, lo, hi)
            tag = f"{name} degree={degree} ef_c={ef_c}"
            for fast in (True, False):
                t0 = time.perf_counter()
                want = ref.insert_ref(st, slots[None], len(slots), ef_c, fast)
                t1 = time.perf_counter()
                got = ops.qhnsw_insert(st.to(dev), slots[None], len(slots),
                                       ef_construction=ef_c, fast=fast)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                same(torch, f"insert {tag} fast={fast}", graph_of(got),
                     graph_of(want))
                print(f"[probe] insert {tag} fast={fast}: plain "
                      f"{t1 - t0:.2f} s, kernel {t2 - t1:.3f} s, cluster "
                      f"{kernel.CLUSTER['insert']}", flush=True)
                for f2 in (True, False):
                    same(torch, f"rebuild {tag} {fast}/{f2}",
                         graph_of(hnsw.rebuild(got, ef_c, f2)),
                         graph_of(hnsw.rebuild(want, ef_c, f2)))
                q = torch.from_numpy(rng.integers(lo, hi, (9, 40))).to(
                    st.vectors.dtype)
                for k, ef in ((5, 16), (10, 64), (70, 32)):
                    same(torch, f"search {tag} {fast} k={k} ef={ef}",
                         ops.qhnsw_search(got, q.to(dev), k, ef),
                         ref.search_ref(want, q, k, ef))
    print("[probe] flat cases done", flush=True)


def spill_cases(torch, dev, rng) -> None:
    """Workspaces past a block's shared memory: a 2^21-row arena (its seen
    and expanded bitmaps, 256 KB each, go to the global scratch) and
    d = 30000 (the query row, 240 KB as int64, goes there)."""
    from repro_torch.core import contracts, hnsw
    from repro_torch.kernels.qhnsw import kernel, ops, ref
    for cap, d, ef in ((1 << 21, 16, 64), (1024, 30000, 64)):
        st, slots = stored_state(torch, contracts.Q16_16, cap, d, 200, 60,
                                 10, 16, 4, rng, -2**16, 2**16)
        tag = f"cap={cap} d={d}"
        t0 = time.perf_counter()
        for fast in (True, False):
            want = ref.insert_ref(st, slots[None], len(slots), 32, fast)
            got = ops.qhnsw_insert(st.to(dev), slots[None], len(slots),
                                   ef_construction=32, fast=fast)
            same(torch, f"insert {tag} fast={fast}", graph_of(got),
                 graph_of(want))
        same(torch, f"rebuild {tag}", graph_of(hnsw.rebuild(got, 32, True)),
             graph_of(hnsw.rebuild(want, 32, True)))
        q = torch.from_numpy(rng.integers(-2**16, 2**16, (4, d))).to(
            torch.int32)
        same(torch, f"search {tag} ef={ef}",
             ops.qhnsw_search(got, q.to(dev), 10, ef),
             ref.search_ref(want, q, 10, ef))
        print(f"[probe] spill case {tag} ef={ef}: "
              f"{time.perf_counter() - t0:.1f} s, clusters "
              f"{kernel.CLUSTER}", flush=True)


def empty_and_sharded(torch, dev, rng) -> None:
    from repro_torch.core import commands, distributed, hnsw, shard_wal
    from repro_torch.core.state import init_state
    from repro_torch.kernels.qhnsw import ops, ref
    g = init_state(64, 16, device="cpu")
    q = torch.from_numpy(rng.integers(-2**16, 2**16, (3, 16))).to(torch.int32)
    same(torch, "search of an empty graph",
         ops.qhnsw_search(g.to(dev), q.to(dev), 4, 8),
         ref.search_ref(g, q, 4, 8))
    ns, d = 3, 32
    sh = distributed.init_sharded_host(ns, 256, d, device="cpu")
    vecs = torch.from_numpy(rng.integers(-2**16, 2**16, (500, d)))
    log = commands.insert_batch(torch.arange(500), vecs)
    sh = shard_wal.bulk_apply_sharded(sh, log, ns, device=False)
    dead = commands.delete_batch(torch.from_numpy(
        rng.choice(500, 25, replace=False)), d, device="cpu")
    sh = shard_wal.bulk_apply_sharded(sh, dead, ns, device=False)
    stacked = shard_wal.shard_stack(sh, ns)
    q = torch.from_numpy(rng.integers(-2**16, 2**16, (7, d))).to(torch.int32)
    same(torch, "sharded search (3 lanes, one launch)",
         ops.qhnsw_search(shard_wal.shard_stack(sh.to(dev), ns), q.to(dev),
                          10, 32),
         ref.search_ref(stacked, q, 10, 32))
    for fast in (True, False):
        same(torch, f"sharded rebuild fast={fast}",
             graph_of(shard_wal.shard_unstack(hnsw.rebuild(
                 shard_wal.shard_stack(sh.to(dev), ns), 32, fast), ns)),
             graph_of(shard_wal.shard_unstack(hnsw.rebuild(
                 stacked, 32, fast), ns)))
    print("[probe] empty graph and sharded cases done", flush=True)


def rand_log(torch, rng, n, d, idspace):
    from repro_torch.core import commands as C
    op = rng.choice([C.INSERT] * 6 + [C.DELETE] * 2 + [C.LINK, C.SET_META,
                                                       C.NOP], size=n)
    return C.CommandLog(
        opcode=torch.from_numpy(op.astype(np.int32)),
        arg0=torch.from_numpy(rng.integers(0, idspace, n)),
        arg1=torch.from_numpy(rng.integers(0, idspace, n)),
        arg2=torch.from_numpy(rng.integers(-5, 5, n)),
        vec=torch.from_numpy(rng.integers(-3000, 3000, (n, 24)).astype(
            np.int32)))


def machine_cases(torch, dev, rng) -> None:
    from repro_torch.core import distributed, hashing, machine, shard_wal
    from repro_torch.core.state import init_state
    for trial in range(4):
        log = rand_log(torch, rng, 300, 24, 150)
        g = init_state(160, 24, device="cpu", hnsw_degree=8)
        for fn_name in ("replay", "bulk_apply"):
            fn = getattr(machine, fn_name)
            want = hashing.hash_pytree(fn(g, log))
            got = hashing.hash_pytree(fn(g.to(dev), log.to(dev)))
            if want != got:
                BAD.append(f"{fn_name} trial {trial}")
                print(f"[probe] MISMATCH machine.{fn_name} trial {trial}")
        sh = distributed.init_sharded_host(2, 96, 24, device="cpu",
                                           hnsw_degree=8)
        routed = distributed.route_commands(log, 2)
        want = hashing.hash_pytree(
            shard_wal.apply_routed_device(sh, routed, 2))
        got = hashing.hash_pytree(shard_wal.apply_routed_device(
            sh.to(dev), routed.to(dev), 2))
        if want != got:
            BAD.append(f"apply_routed_device trial {trial}")
            print(f"[probe] MISMATCH apply_routed_device trial {trial}")
    print("[probe] machine cases done", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_qhnsw: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build_all(["qhnsw"])
    print(f"[probe] built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.PTXAS_LOG.get("qhnsw", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("[ptxas]", line.strip(), flush=True)
    dev = torch.device("cuda")
    from repro_torch.kernels.qhnsw import kernel
    for name, n in (("device memory, 256 MB", 1 << 26), ("L2, 1 MB", 1 << 18)):
        ns = kernel.round_trip_ns(dev, n, 200_000)
        print(f"[probe] one round trip ({name} walked by one thread): "
              f"{ns:.1f} ns", flush=True)
    rng = np.random.default_rng(0)
    flat_cases(torch, dev, rng)
    spill_cases(torch, dev, rng)
    empty_and_sharded(torch, dev, rng)
    machine_cases(torch, dev, rng)
    from repro_torch import kernels
    print(f"[probe] launches {kernels.graph_launch_counts()}", flush=True)
    print(f"[probe] {'FAIL ' + str(BAD) if BAD else 'all equal'}", flush=True)
    return 1 if BAD else 0


if __name__ == "__main__":
    sys.exit(main())
