#!/usr/bin/env python3
"""Build kernels, check them against their plain versions and time them
at the main path's shapes, on one NVIDIA GPU.

    python3 scripts/probe_qcoarse.py [qgemm] [qcoarse] [qtopk] [qboundary]

The short first call after an edit of ``csrc/qgemm.cu``,
``csrc/qcoarse.cu``, ``csrc/imma.cuh``, ``csrc/qtopk.cu`` or
``csrc/qboundary.cu`` (no argument: qgemm and qcoarse): it prints the
card, the compiler's register and spill report per kernel, the SASS counts of integer tensor-core and ``dp4a``
instructions, and the result of ``chip_smoke.check_qgemm`` /
``check_qcoarse`` (bitwise checks at odd, prime, padded, unaligned,
wide-valued and extreme shapes, each with the load path it took, then the
kernel's, the plain version's and the float64 ``torch.matmul``'s time at
the main path's shape) or ``check_qtopk`` (every case against the blocked
plain version, then the call, kernels-alone and merge times at k = 10,
256 and 8192), and for qtopk each phase's launch alone at [64, 131072]
on rows of several kinds; or ``check_qboundary`` (every case with its
path, then the whole call and the kernel alone at [64, 2304] and
[512, 2304]), each launch shape (groups of four values per thread)
checked and timed alone, and the host's time to enqueue one call. Exits
non-zero on any mismatch.
``chip_smoke.py`` runs the same checks as part of the port's full check.
"""
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts the repository's src/ on sys.path)

CHECKS = {"qgemm": chip_smoke.check_qgemm, "qcoarse": chip_smoke.check_qcoarse,
          "qtopk": chip_smoke.check_qtopk,
          "qboundary": chip_smoke.check_qboundary}


def qtopk_phases(torch, dev) -> None:
    """CUDA-event times of qtopk's two launches, each alone, at the main
    path's shape [64, 131072] on rows of several kinds: phase 1 (a
    256-thread block per 4096-column tile) and phase 2 (a 1024-thread
    block per row over the tiles' candidates, sorting them)."""
    from repro_torch.kernels.qtopk import kernel, ref
    rng = np.random.default_rng(1)
    nq, n = chip_smoke.QUERIES, chip_smoke.CAPACITY
    keys = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    inf = torch.full((nq, n), 1 << 62, dtype=torch.int64)
    live = torch.from_numpy(np.stack([rng.choice(n, 100, replace=False)
                                      for _ in range(nq)]))
    rows = {
        "uniform in [-2^45, 2^45)": rng.integers(-2**45, 2**45, (nq, n)),
        "uniform in [0, 2^35)": rng.integers(0, 2**35, (nq, n)),
        "8192 live in [0, 2^35), then INF": np.concatenate(
            [rng.integers(0, 2**35, (nq, 8192)),
             np.full((nq, n - 8192), 1 << 62)], axis=1),
        "all equal": np.zeros((nq, n), np.int64),
        "INF but 100 per row": inf.scatter_(
            1, live, torch.from_numpy(rng.integers(0, 2**40, (nq, 100)))
        ).numpy(),
    }
    for name, s in rows.items():
        s = torch.from_numpy(np.asarray(s, dtype=np.int64)).to(dev)
        for k in (chip_smoke.K, chip_smoke.EF_COARSE):
            _, c = ref.select_plan(n, k, kernel.TILE)
            cand = (torch.empty((nq, c), dtype=torch.int64, device=dev),
                    torch.empty((nq, c), dtype=torch.int32, device=dev))
            out = (torch.empty((nq, k), dtype=torch.int64, device=dev),
                   torch.empty((nq, k), dtype=torch.int32, device=dev))
            p1 = chip_smoke.cuda_ms(torch, lambda: kernel._launch(
                s, keys, n, 0, nq, n, kernel.TILE, k, *cand, c, k, True,
                False), 20)
            p2 = chip_smoke.cuda_ms(torch, lambda: kernel._launch(
                *cand, c, c, nq, c, c, k, *out, k, 0, False, True), 20)
            print(f"qtopk phases [{nq}, {n}] k={k}, {name}: phase 1 "
                  f"{p1:.4f} ms, phase 2 {p2:.4f} ms")


def qboundary_configs(torch, dev) -> None:
    """qboundary's launch shapes, each checked bitwise and timed alone (a
    CUDA graph of launches) at the main path's shapes: groups of four
    values per thread (1, 2, 4, 8: threads per row shrink as they grow);
    then the host's time to enqueue one call."""
    import time
    from repro_torch.core.contracts import Q16_16
    from repro_torch.kernels import _build
    from repro_torch.kernels.qboundary import kernel, ops, ref
    rng = np.random.default_rng(2)
    xs = {(n, d): torch.from_numpy(chip_smoke.qboundary_rows(rng, n, d)).to(dev)
          for n, d in [(chip_smoke.QUERIES, chip_smoke.DIM),
                       (chip_smoke.BATCH, chip_smoke.DIM), (6, 77), (5, 2303),
                       (5, 4097)]}
    want = {key: ref.qboundary_ref(x, Q16_16) for key, x in xs.items()}
    for per in (1, 2, 4, 8):
        bad = 0
        for key, x in xs.items():
            out = torch.empty_like(x, dtype=torch.int32)
            kernel.launch(x, out, Q16_16, True, per)
            bad += int((out != want[key]).sum())
        times = []
        for n in (chip_smoke.QUERIES, chip_smoke.BATCH):
            x = xs[(n, chip_smoke.DIM)]
            out = torch.empty_like(x, dtype=torch.int32)
            times.append(chip_smoke.graph_ms(torch, lambda: kernel.launch(
                x, out, Q16_16, True, per), 50))
        _, _, threads = kernel.plan(x, out, kernel.params(Q16_16, True, per)[0])
        print(f"qboundary {per} group(s) x {threads} threads per row: "
              f"mismatches {bad}; kernel alone {times[0]:.5f} ms at [64, "
              f"2304], {times[1]:.5f} ms at [512, 2304]")

    def host_ms(fn, iters=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return t

    plan_fn = _build.helper("qboundary", "qboundary_plan",
                            [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                            + [ctypes.c_void_p] * 2)
    res, addr = (ctypes.c_int * 3)(), kernel.params(Q16_16, True)[1]
    for n in (chip_smoke.QUERIES, chip_smoke.BATCH):
        x = xs[(n, chip_smoke.DIM)]
        out = torch.empty_like(x, dtype=torch.int32)
        call = host_ms(lambda: ops.qboundary(x))
        launch = host_ms(lambda: kernel.launch(x, out, Q16_16, True))
        alloc = host_ms(lambda: torch.empty_like(x, dtype=torch.int32))
        bare = host_ms(lambda: plan_fn(x.data_ptr(), out.data_ptr(),
                                       chip_smoke.DIM, addr, res))
        print(f"qboundary [{n}, 2304]: host clock per call, unsynchronized "
              f"(the enqueue rate): whole call {call:.4f} ms, of which the "
              f"launch {launch:.4f} ms (a ctypes call of a C function that "
              f"launches nothing: {bare:.4f} ms) and the output's "
              f"allocation {alloc:.4f} ms")


def main() -> int:
    names = sys.argv[1:] or ["qgemm", "qcoarse"]
    import torch
    if not torch.cuda.is_available():
        print("probe_qcoarse: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"build {_build.build_all(names)}")
    for name in names:
        for entry, line in chip_smoke.ptxas_report(name):
            print(f"{name} {entry}: {line}")
    print(f"SASS {chip_smoke.sass_counts(names)}")
    bad = 0
    for name in names:
        r = CHECKS[name](torch, torch.device("cuda"), np.random.default_rng(0))
        if name == "qtopk":
            chip_smoke.report_qtopk(r)
            qtopk_phases(torch, torch.device("cuda"))
        if name == "qboundary":
            chip_smoke.report_qboundary(r)
            qboundary_configs(torch, torch.device("cuda"))
        r = {key: v for key, v in r.items() if key != "cases"}
        print(f"{name} {json.dumps(r, indent=1)}")
        bad |= bool(r["mismatches"] or r["max_abs_err"])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
