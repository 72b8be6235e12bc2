#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--docs 8192] [--seed 0]

Phases (any failure raises and exits non-zero):

1. build — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
2. kernels — each kernel against its plain PyTorch version on the card,
   bitwise, at the main path's shapes and at edge shapes; then timed with
   CUDA events beside its plain version, the one PyTorch call that
   computes the same function where there is one, and its bound;
3. engine — the flat engine at full width (d = 2304, gemma2-2b's d_model;
   131072-row arena; Q16.16): ingest seeded float32 embeddings in batches
   of 512, delete 1 % and re-link, retrieve batches of 64 queries (k = 10)
   on the forced exact route (qgemm + qtopk; one cold batch timed apart,
   then 50) and the forced HNSW route (ef = 64; one cold, then 10).
   Launch counts are zeroed just before and read just after;
   then ``replay_log_fresh() == state_hash()`` and the card's retrievals
   equal the same state's retrievals on the CPU through the plain versions;
4. golden — the hashes the JAX reference wrote at d = 2304
   (``tests/fixtures/torch_port_golden.json``) reproduce on the card.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Needs the repository's ``src/``
beside it and a CUDA device; it does not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_TC_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# The main path's shapes: gemma2-2b's d_model, a 131072-row Q16.16 arena,
# ingest batches of 512, retrieve batches of 64 queries, k = 10, ef = 64.
DIM = 2304
CAPACITY = 131072
BATCH = 512
QUERIES = 64
K = 10
EF = 64
EXACT_BATCHES = 50
HNSW_BATCHES = 10

REPLACES = {
    "qboundary": "src/repro/kernels/qboundary/kernel.py:29",
    "qgemm": "src/repro/kernels/qgemm/kernel.py:39",
    "qtopk": "src/repro/kernels/qtopk/kernel.py:30",
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
    return dict(acc, ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=b, bound_by=by, shape=f"[{nq}, {n}] i64, k={k}")


# --------------------------------------------------------------------------- #
# phase 3: the engine at full width
# --------------------------------------------------------------------------- #


def run_engine(torch, dev, n_docs: int, seed: int):
    from repro_torch import kernels
    from repro_torch.core import boundary, query, search
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    rng = np.random.default_rng(seed)
    eng = MemoryAugmentedEngine(DIM, ServeConfig(
        capacity=CAPACITY, retrieve_k=K, ef=EF), device=dev)
    batches = [rng.normal(size=(BATCH, DIM)).astype(np.float32)
               for _ in range(n_docs // BATCH)]
    queries = [rng.normal(size=(QUERIES, DIM)).astype(np.float32)
               for _ in range(1 + EXACT_BATCHES)]
    n_batches = {"exact": EXACT_BATCHES, "hnsw": HNSW_BATCHES}
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
    for route in ("exact", "hnsw"):
        eng.sc.route = route
        times[route], answers[route] = [], []
        # queries[0] is the cold batch; it is answered and timed apart
        for q in queries[:1 + n_batches[route]]:
            t0 = time.perf_counter()
            ids, scores = eng.retrieve(q)
            times[route].append((time.perf_counter() - t0) * 1e3)
            answers[route].append((ids, scores))
    counts = kernels.launch_counts()  # ---- the main path ends here ----

    log(f"[engine] ingested {n_docs} docs in {ingest_s:.3f} s = "
        f"{n_docs / ingest_s:.1f} docs/s (batches of {BATCH}, "
        f"d={DIM}, capacity={CAPACITY})")
    log(f"[engine] deleted {removed} in {delete_s:.3f} s; relink of "
        f"{eng.live_count()} live rows in {relink_s:.3f} s")
    for route in ("exact", "hnsw"):
        warm = times[route][1:]
        log(f"[engine] retrieve route={route}: {QUERIES} queries x k={K}, "
            f"cold batch {times[route][0]:.3f} ms, then {len(warm)} batches: "
            f"p50 {statistics.median(warm):.3f} ms/batch, min "
            f"{min(warm):.3f}, max {max(warm):.3f}")
    log(f"[engine] kernel launches on the main path: {counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    overlap = np.mean([len(set(a[0][i]) & set(b[0][i])) / K
                       for a, b in zip(answers["exact"], answers["hnsw"])
                       for i in range(QUERIES)])
    log(f"[engine] HNSW recall@{K} against the exact route on the card: "
        f"{overlap:.4f}")
    for route in ("exact", "hnsw"):
        for ids, scores in answers[route]:
            if ids.shape != (QUERIES, K) or (ids < 0).any() \
                    or (scores >= search.INF).any():
                raise AssertionError(f"route {route}: malformed answer")

    t0 = time.perf_counter()
    h_state = eng.state_hash()
    h_replay = eng.replay_log_fresh()
    log(f"[engine] state_hash {h_state:#018x}, replay_log_fresh "
        f"{h_replay:#018x} ({time.perf_counter() - t0:.1f} s)")
    if h_state != h_replay:
        raise AssertionError("replay_log_fresh() != state_hash()")

    # the same state on the CPU, through the plain versions
    t0 = time.perf_counter()
    cpu_state = eng.memory.to("cpu")
    q_cpu = boundary.admit_query(torch.from_numpy(queries[0]))
    cpu = {"exact": search.exact_search(cpu_state, q_cpu, K),
           "hnsw": query.batched_hnsw_search(cpu_state, q_cpu, K,
                                             ef=EF)[:2]}
    for route in ("exact", "hnsw"):
        card = query.retrieval_hash(*answers[route][0])
        if query.retrieval_hash(*cpu[route]) != card:
            raise AssertionError(f"route {route}: card and CPU answers differ")
        log(f"[engine] route={route} retrieval_hash {card:#018x} equals the "
            f"CPU plain path's")
    log(f"[engine] CPU cross-check {time.perf_counter() - t0:.1f} s; "
        f"memory_hash {eng.memory_hash():#018x}")
    return counts


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
    }
    for name, r in results.items():
        log(f"[kernel] {name} {r['shape']}: max_abs_err {r['max_abs_err']}, "
            f"mismatches {r['mismatches']}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
        if r["max_abs_err"] != 0 or r["mismatches"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    counts = run_engine(torch, dev, args.docs, args.seed)

    t0 = time.perf_counter()
    got = golden.check(dev)
    log(f"[golden] reference hashes reproduced on the card "
        f"({time.perf_counter() - t0:.1f} s): {got}")

    kern = [dict(name=name, route="cuda",
                 source=f"src/repro_torch/kernels/csrc/{name}.cu",
                 replaces=REPLACES[name], launches=counts[name],
                 max_abs_err=r["max_abs_err"], mismatches=r["mismatches"],
                 ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"])
            for name, r in results.items()]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
