"""The cost of the port's tracer (``repro_torch.obs``) on this host.

    PYTHONPATH=src python3 scripts/probe_obs.py [--n 200000]

Times, per call, one ``obs.span`` entered and left, one ``obs.count`` and
one ``obs.host`` of a 10-element CPU tensor beside a bare ``t.cpu()``,
each with spans off (no profiler) and on (a CPU-only ``torch.profiler``
recording); the least of five rounds of ``--n`` calls, less an empty
loop's time. Prints one JSON line, with the card's name and power limit
where ``nvidia-smi`` reads them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch import obs


def _per_call_ns(fn, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        obs.reset()
        t = time.perf_counter_ns()
        fn(n)
        best = min(best, time.perf_counter_ns() - t)
    return best / n


def _empty(n):
    for _ in range(n):
        pass


def _spans(n):
    for _ in range(n):
        with obs.span("probe"):
            pass


def _counts(n):
    for _ in range(n):
        obs.count("probe")


def _make_host(t):
    def run(n):
        for _ in range(n):
            obs.host(t)
    return run


def _make_cpu(t):
    def run(n):
        for _ in range(n):
            t.cpu()
    return run


def measure(n: int) -> dict:
    t = torch.arange(10)
    cases = {"span": _spans, "count": _counts, "host": _make_host(t),
             "cpu": _make_cpu(t)}
    out = {}
    for mode in ("off", "on"):
        prof = None
        if mode == "on":
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            prof.start()
        base = _per_call_ns(_empty, n)
        for name, fn in cases.items():
            out[f"{name}_{mode}_ns"] = round(_per_call_ns(fn, n) - base, 1)
        if prof is not None:
            prof.stop()
    obs.reset()
    return out


def card() -> str | None:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        and res.stdout.strip() else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args()
    print(json.dumps({"card": card(), "n": args.n, **measure(args.n)}),
          flush=True)


if __name__ == "__main__":
    main()
