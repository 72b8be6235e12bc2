#!/usr/bin/env python3
"""Build the tensor-core kernels (qgemm, qcoarse), check them against
their plain versions and time them at the main path's shapes, on one
NVIDIA GPU.

    python3 scripts/probe_qcoarse.py [qgemm] [qcoarse]

The short first call after an edit of ``csrc/qgemm.cu``,
``csrc/qcoarse.cu`` or ``csrc/imma.cuh``: it prints the card, the
compiler's register and spill report per kernel, the SASS counts of
integer tensor-core and ``dp4a`` instructions, and the result of
``chip_smoke.check_qgemm`` / ``check_qcoarse`` (bitwise checks at odd,
prime, padded, unaligned, wide-valued and extreme shapes, each with the
load path it took, then the kernel's, the plain version's and the float64
``torch.matmul``'s time at the main path's shape). Exits non-zero on any
mismatch. ``chip_smoke.py`` runs the same checks as part of the port's
full check.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts the repository's src/ on sys.path)

CHECKS = {"qgemm": chip_smoke.check_qgemm, "qcoarse": chip_smoke.check_qcoarse}


def main() -> int:
    names = sys.argv[1:] or list(CHECKS)
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
        print(f"{name} {json.dumps(r, indent=1)}")
        bad |= bool(r["mismatches"] or r["max_abs_err"])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
