"""Hand-written CUDA kernels of the port: one package per TPU kernel, and
one for device programs that the reference writes in ``jnp``.

Each package keeps the reference's three parts: ``kernel.py`` (the launch
of the CUDA C++ kernel in ``csrc/``, with a note on what bounds it),
``ops.py`` (the wrapper: contract checks, dispatch by device, a launch
counter) and ``ref.py`` (the plain PyTorch version, which CPU tensors take
and the card's checks compare against).

  qboundary — fused float→Q-encode→integer L2-normalize (the boundary)
  qgemm     — exact int64 scoring matmul of raw fixed-point rows
  qtopk     — deterministic k smallest (score, key) per row
  qcoarse   — exact int64 weighted dot of int32 weights and int8 codes
  qhnsw     — the deterministic HNSW graph's batched search and its insert
              (no Pallas kernel: the reference's jitted beams)

``launch_counts`` reads the four TPU kernels' counts, ``graph_launch_counts``
qhnsw's two (``qhnsw_search``, ``qhnsw_insert``); ``reset_launch_counts``
zeroes all of them. The counts are the tracer's ``launch.<kernel>``
counters (``repro_torch.obs``), raised by each wrapper: a launch of the
kernel, or for qtopk a call that launched it (one or two launches).
"""
from __future__ import annotations

from typing import Dict

from repro_torch import obs

_TPU_KERNELS = ("qboundary", "qgemm", "qtopk", "qcoarse")
_GRAPH_KERNELS = ("qhnsw_search", "qhnsw_insert")


def _counts(names) -> Dict[str, int]:
    totals = obs.counters()
    return {name: totals.get(f"launch.{name}", 0) for name in names}


def launch_counts() -> Dict[str, int]:
    return _counts(_TPU_KERNELS)


def graph_launch_counts() -> Dict[str, int]:
    return _counts(_GRAPH_KERNELS)


def reset_launch_counts() -> None:
    obs.reset("launch.")
