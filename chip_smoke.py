#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--docs 8192] [--seed 0]

Phases (any failure raises and exits non-zero):

1. build — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
2. kernels — each kernel (qboundary, qgemm, qtopk, qcoarse) against its
   plain PyTorch version on the card, bitwise, at the main path's shapes
   and at edge shapes; then timed with CUDA events beside its plain
   version, the one PyTorch call that computes the same function where
   there is one, and its bound (qtopk also at k = ef_coarse = 256);
3. engine — the flat engine at full width (d = 2304, gemma2-2b's d_model;
   131072-row arena; Q16.16; ef_coarse = 256): ingest seeded float32
   embeddings in batches of 512, delete 1 % and re-link, retrieve batches
   of 64 queries (k = 10) on the forced exact route (qgemm + qtopk; one
   cold batch timed apart, then 50), the forced HNSW route (ef = 64; one
   cold, then 10) and the forced coarse route (qcoarse scan + qtopk at
   k = 256 + qgemm re-rank; one cold batch that builds the code table,
   then 50); then the coarse route at full coverage (ef_coarse >= live
   rows) must equal the exact route's ``retrieval_hash``, and one more
   insert batch refreshes the table before a last coarse read. Launch
   counts are zeroed just before and read just after. Then the refreshed
   table equals ``codes.build`` of the state, ``replay_log_fresh() ==
   state_hash()``, and the card's retrievals (all three routes) and code
   table equal the same state's on the CPU through the plain versions;
4. golden — the hashes the JAX reference wrote at d = 2304
   (``tests/fixtures/torch_port_golden.json``, code table and coarse
   routes included) reproduce on the card; the reference's golden v1 and
   v2 snapshots restore onto the card with their recorded hash; the
   engine's full-width state survives a v1 round trip in memory and a v2
   round trip through a chunk store (1 MiB chunks, temporary directory),
   and its code table a VLRQ round trip, with unchanged hashes.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Needs the repository's ``src/``
beside it and a CUDA device; it does not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_TC_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# The main path's shapes: gemma2-2b's d_model, a 131072-row Q16.16 arena,
# ingest batches of 512, retrieve batches of 64 queries, k = 10, ef = 64,
# ef_coarse = 256 (ef_coarse >= EF_COVER covers the live rows).
DIM = 2304
CAPACITY = 131072
BATCH = 512
QUERIES = 64
K = 10
EF = 64
EF_COARSE = 256
EF_COVER = 8192
EXACT_BATCHES = 50
HNSW_BATCHES = 10
COARSE_BATCHES = 50
CHUNK_SIZE = 1 << 20  # v2 snapshot chunks at full width

REPLACES = {
    "qboundary": "src/repro/kernels/qboundary/kernel.py:29",
    "qgemm": "src/repro/kernels/qgemm/kernel.py:39",
    "qtopk": "src/repro/kernels/qtopk/kernel.py:30",
    "qcoarse": "src/repro/kernels/qcoarse/kernel.py:41",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, got, want, acc: dict) -> None:
    """Fold |got - want| of integer tensors (or tuples of them) into
    ``acc``: the largest difference and the count of differing values."""
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            compare(torch, g, w, acc)
        return
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs()
    if diff.numel():
        acc["max_abs_err"] = max(acc["max_abs_err"], int(diff.max()))
        acc["mismatches"] += int((diff != 0).sum())


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------- #


def check_qboundary(torch, dev, rng):
    from repro_torch.core.contracts import Q16_16
    from repro_torch.kernels.qboundary import ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    for n, d in [(1, 8), (4, 16), (257, 768), (100, 64), (3, 8192), (64, 2304),
                 (BATCH, DIM)]:
        x = (rng.normal(size=(n, d)) * 2).astype(np.float32)
        if n >= 4:
            x[1] = 0.0
            x[2] *= 1e-7
            x[3, ::2], x[3, 1::2] = 40000.0, -40000.0
        x[0, 0] = np.nan
        xt = torch.from_numpy(x).to(dev)
        for unit_norm in (True, False):
            compare(torch, ops.qboundary(xt, Q16_16, unit_norm=unit_norm),
                    ref.qboundary_ref(xt, Q16_16, unit_norm), acc)
    n, d = BATCH, DIM  # one ingest batch
    xt = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    ms = cuda_ms(torch, lambda: ops.qboundary(xt, Q16_16), 50)
    plain = cuda_ms(torch, lambda: ref.qboundary_ref(xt, Q16_16), 5)
    b, by = bound_ms(n * d * 8, n * d * 4, F32_OPS_PER_S)
    return dict(acc, ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=b, bound_by=by, shape=f"[{n}, {d}] f32 -> i32")


def check_qgemm(torch, dev, rng):
    from repro_torch.kernels.qgemm import ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    cases = [(1, 1, 8), (4, 16, 32), (7, 100, 384), (130, 257, 640),
             (16, 1000, 768), (3, 33, 8192), (64, 4099, 2304)]
    for nq, m, dd in cases:
        q = torch.from_numpy(rng.integers(-65536, 65537, (nq, dd)).astype(np.int32))
        db = torch.from_numpy(rng.integers(-65536, 65537, (m, dd)).astype(np.int32))
        q, db = q.to(dev), db.to(dev)
        compare(torch, ops.qgemm(q, db), ref.qgemm_ref(q, db), acc)
    ext = torch.full((2, 8192), 65536, dtype=torch.int32, device=dev)
    ext[1] = -65536
    got = ops.qgemm(ext, ext)
    compare(torch, got, ref.qgemm_ref(ext, ext), acc)
    if int(got[0, 0]) != 8192 * 65536 * 65536:
        raise AssertionError("qgemm extreme value wrong")
    # the main path's scan: 64 queries against the whole arena
    nq, nn, d = QUERIES, CAPACITY, DIM
    q = torch.from_numpy(rng.integers(-65536, 65537, (nq, d)).astype(np.int32)).to(dev)
    db = torch.randint(-65536, 65537, (nn, d), dtype=torch.int32, device=dev)
    compare(torch, ops.qgemm(q, db), ref.qgemm_ref(q, db), acc)
    ms = cuda_ms(torch, lambda: ops.qgemm(q, db), 10)
    plain = cuda_ms(torch, lambda: ref.qgemm_ref(q, db), 3)
    qf, dbf = q.to(torch.float64), db.to(torch.float64)
    lib = cuda_ms(torch, lambda: torch.matmul(qf, dbf.T), 3)
    del qf, dbf, db
    b, by = bound_ms((nq + nn) * d * 4 + nq * nn * 8, 2.0 * nq * nn * d,
                     INT8_TC_OPS_PER_S)
    return dict(acc, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by,
                shape=f"[{nq}, {d}] x [{nn}, {d}] i32 -> i64")


def check_qtopk(torch, dev, rng):
    from repro_torch.kernels.qtopk import ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    cases = [(1, 4, 1), (3, 17, 5), (6, 200, 16), (2, 127, 16), (5, 128, 9),
             (4, 1000, 12), (4, 1030, 10), (4, 5000, 16), (2, 1030, 40),
             (3, 50, 80), (QUERIES, CAPACITY, K)]
    for nq, m, kk in cases:
        s = torch.from_numpy(rng.integers(-2**45, 2**45, (nq, m))).to(dev)
        s[:, ::5] = 0  # ties
        keys = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(dev)
        compare(torch, ops.qtopk(s, keys, kk),
                ref.qtopk_blocked(s, keys, kk, ops.block_n(m)), acc)
    ties = torch.zeros((1, 64), dtype=torch.int64, device=dev)
    rev = torch.arange(63, -1, -1, dtype=torch.int32, device=dev)
    if ops.qtopk(ties, rev, 5)[1][0].tolist() != [0, 1, 2, 3, 4]:
        raise AssertionError("qtopk all-ties order wrong")
    nq, n, k = QUERIES, CAPACITY, K
    s = torch.from_numpy(rng.integers(-2**45, 2**45, (nq, n))).to(dev)
    keys = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    ms = cuda_ms(torch, lambda: ops.qtopk(s, keys, k), 20)
    plain = cuda_ms(torch, lambda: ref.qtopk_blocked(s, keys, k,
                                                     ops.block_n(n)), 3)
    b, by = bound_ms(nq * n * 8 + n * 4 + nq * k * 12, 2.0 * nq * n,
                     INT8_TC_OPS_PER_S)
    # the coarse route's candidate selection: k = ef_coarse
    ke = EF_COARSE
    compare(torch, ops.qtopk(s, keys, ke),
            ref.qtopk_blocked(s, keys, ke, ops.block_n(n)), acc)
    ms_ef = cuda_ms(torch, lambda: ops.qtopk(s, keys, ke), 10)
    plain_ef = cuda_ms(torch, lambda: ref.qtopk_blocked(s, keys, ke,
                                                        ops.block_n(n)), 2)
    b_ef, _ = bound_ms(nq * n * 8 + n * 4 + nq * ke * 12, 2.0 * nq * n,
                       INT8_TC_OPS_PER_S)
    return dict(acc, ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=b, bound_by=by, shape=f"[{nq}, {n}] i64, k={k}",
                ms_at_ef_coarse=ms_ef, plain_ms_at_ef_coarse=plain_ef,
                bound_ms_at_ef_coarse=b_ef)


def check_qcoarse(torch, dev, rng):
    from repro_torch.kernels.qcoarse import ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    wb = ops.W_BOUND

    def inputs(nq, nn, d):
        w = rng.integers(-wb, wb + 1, (nq, d)).astype(np.int32)
        c = rng.integers(-127, 128, (nn, d)).astype(np.int8)
        return torch.from_numpy(w).to(dev), torch.from_numpy(c).to(dev)

    for nq, nn, d in [(1, 1, 8), (4, 16, 32), (8, 128, 64), (128, 256, 512),
                      (7, 100, 384), (130, 257, 640), (3, 33, 8192),
                      (5, 77, 7), (3, 9, 101), (64, 4099, 2304)]:
        w, c = inputs(nq, nn, d)
        compare(torch, ops.qcoarse(w, c), ref.qcoarse_ref(w, c), acc)
    # codes whose rows are not 4-byte aligned take the kernel's byte loads
    w, c = inputs(3, 34, 64)
    for off, d in ((1, 64), (2, 62)):
        cv = c.reshape(-1)[off:off + 33 * d].reshape(33, d)
        wv = w[:, :d].contiguous()
        compare(torch, ops.qcoarse(wv, cv), ref.qcoarse_ref(wv, cv), acc)
    ext_w = torch.full((2, 8192), wb, dtype=torch.int32, device=dev)
    ext_w[1] = -wb
    ext_c = torch.full((2, 8192), 127, dtype=torch.int8, device=dev)
    ext_c[1] = -127
    got = ops.qcoarse(ext_w, ext_c)
    compare(torch, got, ref.qcoarse_ref(ext_w, ext_c), acc)
    if int(got[0, 0]) != 8192 * wb * 127:
        raise AssertionError("qcoarse extreme value wrong")
    try:
        ops.qcoarse(torch.zeros((2, 8193), dtype=torch.int32, device=dev),
                    torch.zeros((2, 8193), dtype=torch.int8, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("qcoarse accepted d > 8192")
    # the main path's scan: 64 query weights against the whole code table
    nq, nn, d = QUERIES, CAPACITY, DIM
    w, _ = inputs(nq, 1, d)
    c = torch.randint(-127, 128, (nn, d), dtype=torch.int8, device=dev)
    compare(torch, ops.qcoarse(w, c), ref.qcoarse_ref(w, c), acc)
    ms = cuda_ms(torch, lambda: ops.qcoarse(w, c), 20)
    plain = cuda_ms(torch, lambda: ref.qcoarse_ref(w, c), 3)
    wf, cf = w.to(torch.float64), c.to(torch.float64)
    lib = cuda_ms(torch, lambda: torch.matmul(wf, cf.T), 3)
    del wf, cf, c
    b, by = bound_ms(nn * d + nq * d * 4 + nq * nn * 8, 2.0 * nq * nn * d,
                     INT8_TC_OPS_PER_S)
    return dict(acc, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by,
                shape=f"[{nq}, {d}] i32 x [{nn}, {d}] i8 -> i64")


# --------------------------------------------------------------------------- #
# phase 3: the engine at full width
# --------------------------------------------------------------------------- #


def run_engine(torch, dev, n_docs: int, seed: int):
    from repro_torch import kernels
    from repro_torch.core import boundary, codes, query, search
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    rng = np.random.default_rng(seed)
    eng = MemoryAugmentedEngine(DIM, ServeConfig(
        capacity=CAPACITY, retrieve_k=K, ef=EF, ef_coarse=EF_COARSE),
        device=dev)
    batches = [rng.normal(size=(BATCH, DIM)).astype(np.float32)
               for _ in range(n_docs // BATCH)]
    queries = [rng.normal(size=(QUERIES, DIM)).astype(np.float32)
               for _ in range(1 + max(EXACT_BATCHES, COARSE_BATCHES))]
    routes = ("exact", "hnsw", "coarse")
    n_batches = {"exact": EXACT_BATCHES, "hnsw": HNSW_BATCHES,
                 "coarse": COARSE_BATCHES}
    torch.cuda.synchronize()

    kernels.reset_launch_counts()  # ---- the main path starts here ----
    t0 = time.perf_counter()
    for emb in batches:
        eng.insert_documents(emb)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    n_docs = eng.live_count()
    dead = rng.choice(n_docs, size=n_docs // 100, replace=False)
    t0 = time.perf_counter()
    removed = eng.delete_documents(dead.tolist())
    delete_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.relink_now()
    torch.cuda.synchronize()
    relink_s = time.perf_counter() - t0
    answers, times = {}, {}
    for route in routes:
        eng.sc.route = route
        times[route], answers[route] = [], []
        # queries[0] is the cold batch (on the coarse route it builds the
        # code table); it is answered and timed apart
        for q in queries[:1 + n_batches[route]]:
            t0 = time.perf_counter()
            ids, scores = eng.retrieve(q)
            times[route].append((time.perf_counter() - t0) * 1e3)
            answers[route].append((ids, scores))
    # full coverage: ef_coarse >= live rows
    live = eng.live_count()
    eng.sc.ef_coarse = max(EF_COVER, live)
    t0 = time.perf_counter()
    cover = eng.retrieve(queries[0])
    cover_ms = (time.perf_counter() - t0) * 1e3
    eng.sc.ef_coarse = EF_COARSE
    # one more insert batch refreshes the maintained table
    extra = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    t0 = time.perf_counter()
    eng.insert_documents(extra)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refreshed = eng.retrieve(queries[0])
    refreshed_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()  # ---- the main path ends here ----

    log(f"[engine] ingested {n_docs} docs in {ingest_s:.3f} s = "
        f"{n_docs / ingest_s:.1f} docs/s (batches of {BATCH}, "
        f"d={DIM}, capacity={CAPACITY})")
    log(f"[engine] deleted {removed} in {delete_s:.3f} s; relink of "
        f"{live} live rows in {relink_s:.3f} s")
    for route in routes:
        warm = times[route][1:]
        extra_note = f", ef_coarse={EF_COARSE}" if route == "coarse" else ""
        log(f"[engine] retrieve route={route}: {QUERIES} queries x k={K}"
            f"{extra_note}, cold batch {times[route][0]:.3f} ms, then "
            f"{len(warm)} batches: p50 {statistics.median(warm):.3f} "
            f"ms/batch, min {min(warm):.3f}, max {max(warm):.3f}")
    log(f"[engine] kernel launches on the main path: {counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    for route in ("hnsw", "coarse"):
        overlap = np.mean([len(set(a[0][i]) & set(b[0][i])) / K
                           for a, b in zip(answers["exact"], answers[route])
                           for i in range(QUERIES)])
        log(f"[engine] {route} recall@{K} against the exact route on the "
            f"card: {overlap:.4f} over {len(answers[route])} batches")
    for route in routes:
        for ids, scores in answers[route] + [cover, refreshed]:
            if ids.shape != (QUERIES, K) or (ids < 0).any() \
                    or (scores >= search.INF).any():
                raise AssertionError(f"route {route}: malformed answer")

    h_cover = query.retrieval_hash(*cover)
    if h_cover != query.retrieval_hash(*answers["exact"][0]):
        raise AssertionError("coarse route at full coverage != exact route")
    log(f"[engine] coarse route at ef_coarse={max(EF_COVER, live)} >= "
        f"{live} live rows: retrieval_hash {h_cover:#018x} equals the exact "
        f"route's ({cover_ms:.3f} ms)")
    h_table = codes.table_hash(eng._code_table)
    t0 = time.perf_counter()
    h_build = codes.table_hash(codes.build(eng.memory))
    build_ms = (time.perf_counter() - t0) * 1e3
    if h_table != h_build:
        raise AssertionError("refreshed code table != codes.build(state)")
    log(f"[engine] insert of {BATCH} more in {refresh_s:.3f} s, then a "
        f"coarse read in {refreshed_ms:.3f} ms: refreshed table_hash "
        f"{h_table:#018x} equals codes.build's ({build_ms:.1f} ms)")

    t0 = time.perf_counter()
    h_state = eng.state_hash()
    h_replay = eng.replay_log_fresh()
    log(f"[engine] state_hash {h_state:#018x}, replay_log_fresh "
        f"{h_replay:#018x} ({time.perf_counter() - t0:.1f} s)")
    if h_state != h_replay:
        raise AssertionError("replay_log_fresh() != state_hash()")

    # the same state on the CPU, through the plain versions
    card = {}
    for route in routes:
        eng.sc.route = route
        card[route] = query.retrieval_hash(*eng.retrieve(queries[0]))
    if card["coarse"] != query.retrieval_hash(*refreshed):
        raise AssertionError("coarse route: two reads of one state differ")
    t0 = time.perf_counter()
    cpu_state = eng.memory.to("cpu")
    q_cpu = boundary.admit_query(torch.from_numpy(queries[0]))
    cpu_table = codes.build(cpu_state)
    if codes.table_hash(cpu_table) != h_table:
        raise AssertionError("code table: card and CPU differ")
    cpu = {"exact": search.exact_search(cpu_state, q_cpu, K),
           "hnsw": query.batched_hnsw_search(cpu_state, q_cpu, K,
                                             ef=EF)[:2],
           "coarse": search.coarse_search(cpu_state, cpu_table, q_cpu, K,
                                          ef_coarse=EF_COARSE)}
    for route in routes:
        if query.retrieval_hash(*cpu[route]) != card[route]:
            raise AssertionError(f"route {route}: card and CPU answers differ")
        log(f"[engine] route={route} retrieval_hash {card[route]:#018x} "
            f"equals the CPU plain path's")
    log(f"[engine] CPU cross-check {time.perf_counter() - t0:.1f} s "
        f"(code table included); memory_hash {eng.memory_hash():#018x}")
    return counts, eng


# --------------------------------------------------------------------------- #
# phase 4: snapshots
# --------------------------------------------------------------------------- #


def check_snapshots(torch, dev, eng) -> None:
    """The reference's golden snapshots restore onto the card with their
    recorded hash; the engine's full-width state and code table survive
    their round trips with unchanged hashes."""
    from repro_torch.core import codes, hashing, snapshot
    fx = ROOT / "tests" / "fixtures"
    want = int(json.loads((fx / "golden.json").read_text())["state_hash"], 16)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        shutil.copytree(fx / "golden_v2_chunks", tmp / "golden")
        s1, h1 = snapshot.restore_bytes((fx / "golden_v1.bin").read_bytes(),
                                        device=dev)
        s2, h2 = snapshot.restore_v2(
            (fx / "golden_v2_manifest.bin").read_bytes(),
            snapshot.ChunkStore(tmp / "golden"), device=dev)
        for s in (s1, s2):
            if s.device.type != "cuda" or hashing.hash_state_device(s) != want:
                raise AssertionError("golden snapshot restore on the card")
        log(f"[snapshot] golden v1 and v2 restore on the card with "
            f"state_hash {want:#018x} (h1 {h1:#018x}, h2 {h2:#018x})")

        h = eng.state_hash()
        t0 = time.perf_counter()
        blob = snapshot.snapshot_bytes(eng.memory)
        t1 = time.perf_counter()
        st, hr = snapshot.restore_bytes(blob, device=dev)
        t2 = time.perf_counter()
        if hr != h or hashing.hash_state_device(st) != h:
            raise AssertionError("v1 round trip changed the state hash")
        log(f"[snapshot] v1 in memory: {len(blob)} bytes, write "
            f"{t1 - t0:.3f} s, restore onto the card {t2 - t1:.3f} s, "
            f"hash {h:#018x} unchanged")
        del st, blob

        store = snapshot.ChunkStore(tmp / "engine")
        t0 = time.perf_counter()
        manifest, stats = snapshot.snapshot_v2(eng.memory, store,
                                               chunk_size=CHUNK_SIZE)
        t1 = time.perf_counter()
        st, hr = snapshot.restore_v2(manifest, store, device=dev)
        t2 = time.perf_counter()
        if hr != h or hashing.hash_state_device(st) != h:
            raise AssertionError("v2 round trip changed the state hash")
        log(f"[snapshot] v2 ({CHUNK_SIZE}-byte chunks, temporary directory): "
            f"{stats['chunks_written']} distinct of {stats['chunks']} chunks "
            f"written ({stats['bytes_written']} of {stats['bytes_total']} "
            f"bytes), manifest {stats['manifest_bytes']} bytes, write "
            f"{t1 - t0:.3f} s, restore onto the card {t2 - t1:.3f} s, hash "
            f"unchanged")
        del st

        h_tab = codes.table_hash(eng._code_table)
        t0 = time.perf_counter()
        tblob, tstats = codes.snapshot_table_v2(
            eng._code_table, eng.flush(), store, chunk_size=CHUNK_SIZE)
        t1 = time.perf_counter()
        tab, cursor = codes.restore_table_v2(tblob, store, device=dev)
        t2 = time.perf_counter()
        if codes.table_hash(tab) != h_tab or cursor != eng.flush() \
                or tab.codes.device.type != "cuda":
            raise AssertionError("code-table round trip changed the table")
        log(f"[snapshot] code table (VLRQ): {tstats['chunks_written']} new "
            f"of {tstats['chunks']} chunks, write {t1 - t0:.3f} s, restore "
            f"onto the card {t2 - t1:.3f} s, table_hash {h_tab:#018x} "
            f"unchanged")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=8192,
                    help="documents to ingest (a multiple of 512)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.docs < BATCH or args.docs % BATCH:
        ap.error(f"--docs must be a positive multiple of {BATCH}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        "_torch_golden", ROOT / "tests" / "_torch_golden.py")
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(f"[device] {smi.stdout.strip() or smi.stderr.strip()}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per kernel "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name, text in _build.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed + 1)
    results = {
        "qboundary": check_qboundary(torch, dev, rng),
        "qgemm": check_qgemm(torch, dev, rng),
        "qtopk": check_qtopk(torch, dev, rng),
        "qcoarse": check_qcoarse(torch, dev, rng),
    }
    for name, r in results.items():
        log(f"[kernel] {name} {r['shape']}: max_abs_err {r['max_abs_err']}, "
            f"mismatches {r['mismatches']}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
        if r["max_abs_err"] != 0 or r["mismatches"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    r = results["qtopk"]
    log(f"[kernel] qtopk at k={EF_COARSE} (the coarse route's candidates): "
        f"{r['ms_at_ef_coarse']:.4f} ms (plain "
        f"{r['plain_ms_at_ef_coarse']:.4f} ms, bound "
        f"{r['bound_ms_at_ef_coarse']:.4f} ms)")

    counts, eng = run_engine(torch, dev, args.docs, args.seed)

    t0 = time.perf_counter()
    got = golden.check(dev)
    log(f"[golden] reference hashes reproduced on the card "
        f"({time.perf_counter() - t0:.1f} s): {got}")
    check_snapshots(torch, dev, eng)
    del eng

    kern = [dict(name=name, route="cuda",
                 source=f"src/repro_torch/kernels/csrc/{name}.cu",
                 replaces=REPLACES[name], launches=counts[name],
                 max_abs_err=r["max_abs_err"], mismatches=r["mismatches"],
                 ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 **{key: v for key, v in r.items()
                    if key.endswith("_at_ef_coarse")})
            for name, r in results.items()]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
