#!/usr/bin/env python3
"""Build the qcoarse CUDA kernel, check it against its plain version and
time it at the coarse route's scan shape, on one NVIDIA GPU.

    python3 scripts/probe_qcoarse.py

The short first call after an edit of ``csrc/qcoarse.cu``: it prints the
card, the compiler's register and spill report, and the result of
``chip_smoke.check_qcoarse`` (bitwise checks at odd, prime, padded,
unaligned and extreme shapes and at 64 x 131072 rows of d = 2304, then
the kernel's, the plain version's and the float64 ``torch.matmul``'s time
at that shape). Exits non-zero on any mismatch. ``chip_smoke.py`` runs the
same check as part of the port's full check.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts the repository's src/ on sys.path)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_qcoarse: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    secs = _build.build_all(["qcoarse"])
    print(f"build {secs}")
    print(_build.PTXAS_LOG.get("qcoarse", ""))
    r = chip_smoke.check_qcoarse(torch, torch.device("cuda"),
                                 np.random.default_rng(0))
    print(json.dumps(r))
    return 1 if r["mismatches"] or r["max_abs_err"] else 0


if __name__ == "__main__":
    sys.exit(main())
