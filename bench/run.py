"""Run one cell of the benchmark of the PyTorch and CUDA port, ``repro_torch``.

    python3 bench/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for. The run builds the system from the cell's configuration, draws its
inputs from ``--seed`` on the card, fills and warms up (``setup_s``),
measures the closed loop for ``--seconds``, checks what the window
produced against the plain reference (``bench/reference``) and prints one
JSON line last on stdout: ``--trace 0`` the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace of
the window. Each number compared, with its limit, is printed last on
stderr and last in the line, under ``checks``.

``--control 1`` runs the control instead, which the check must find
incorrect: the engine kind's ``control`` (``engines/<kind>.py``). It is
for measuring the control, never part of a benchmark run.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``), or the
    time this module was first imported where that cannot be read."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        ticks = int(fields.split()[19])
        btime = next(int(line.split()[1]) for line in
                     pathlib.Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def _environment() -> None:
    """Kernel caches inside the checkout, at fixed paths; the port's own
    CUDA libraries build into ``src/repro_torch/kernels/_build``."""
    cache = BENCH_DIR / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_speed() -> float:
    """Milliseconds of a fixed pure-Python loop, the least of three: the
    speed of the host's core this process runs on, read after the
    window, to tell a slow host from a slow program."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc = (acc * 31 + i) & 0xFFFFFFFF
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             started: float, control: bool = False, log=sys.stderr) -> dict:
    """One run of ``cell`` (a ``harness.Cell``) on ``device``: the result
    line as a dict."""
    from bench import harness
    engine = harness.part("engines", cell.config["engine"])
    with engine.control() if control else contextlib.nullcontext():
        return _run_cell(engine, cell, seed, seconds, trace, device, started,
                         control, log)


def _run_cell(engine, cell, seed, seconds, trace, device, started, control,
              log):
    import torch
    from bench import generator, harness, workload

    system = engine.build(cell.config, device, seed)
    gen = generator.make(cell.mix["data"], system.d_model, seed, device)
    rec = harness.Recorder(profiled=trace)
    wl = workload.Workload(system, cell.mix, gen, seed, rec)
    wl.setup()
    _sync(device)
    setup_s = time.time() - started

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    wl.window(seconds)
    _sync(device)
    if prof is not None:
        prof.stop()
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    w0, w1 = harness.window_bounds(rec.spans)
    window_s = w1 - w0

    # the program's outputs, then its state freed before the reference runs
    state = system.state()
    facts = system.facts(cell.mix)
    wl.release()
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    out_ = harness.Outputs(cell, wl, gen, state, seed, device, control)
    checks, work = engine.check(out_)
    for op in wl.ops.values():
        c, w = op.check(out_)
        checks.update(c)
        work.update(w)
    ref_s = time.perf_counter() - t_ref
    limits = dict(engine.LIMITS)
    for name in wl.ops:
        limits.update(harness.part("ops", name).LIMITS)
    limits.update(cell.config.get("check_limits", {}))

    out = {"correct": None, "attempted": len(rec.spans), "failed": 0}
    if not trace:
        out["metrics"] = {}
        for m in cell.end_to_end:
            v = harness.end_to_end(m["name"], rec.spans, window_s, setup_s)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if on_card:
        device_info["power_limit"] = power_limit()
    if trace:
        t_trace = time.perf_counter()
        dev_events, host_events = harness.profiler_events(prof)
        tr = harness.reduce_trace(dev_events, host_events, rec.spans)
        ctx = harness.Context(cell, rec.spans, tr, work, facts)
        out["metrics"] = harness.per_layer(cell, ctx)
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
        print(f"trace: {len(dev_events)} device events, "
              f"{len(host_events)} host events, read in "
              f"{time.perf_counter() - t_trace:.1f} s", file=log)
    out["device"] = device_info

    host_ms = host_speed()
    print(f"cell {cell.name} seed {seed}: {len(wl.docs)} ingest calls "
          f"({len(wl.acked)} documents), window {window_s:.3f} s, "
          f"set-up {setup_s:.3f} s, reference {ref_s:.3f} s, "
          f"host loop {host_ms:.2f} ms, "
          f"work {json.dumps(work)}", file=log)
    out["correct"] = all(checks[n] <= limits[n] for n in checks)
    out["checks"] = {n: {"value": checks[n], "limit": limits[n]}
                     for n in checks}
    for n in checks:
        print(f"check {n}: {checks[n]} (limit {limits[n]})", file=log)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    _environment()
    from bench import harness
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no CUDA device for {cell.name} (needs {cell.chips}, "
              f"found {torch.cuda.device_count()}): nothing is measured "
              "off the card", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), started, control=bool(args.control))
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
