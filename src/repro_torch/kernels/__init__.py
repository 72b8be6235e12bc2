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
zeroes all of them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.qboundary import ops as _qboundary_ops
from repro_torch.kernels.qcoarse import ops as _qcoarse_ops
from repro_torch.kernels.qgemm import ops as _qgemm_ops
from repro_torch.kernels.qhnsw import ops as _qhnsw_ops
from repro_torch.kernels.qtopk import ops as _qtopk_ops

_OPS = {"qboundary": _qboundary_ops, "qgemm": _qgemm_ops, "qtopk": _qtopk_ops,
        "qcoarse": _qcoarse_ops}


def launch_counts() -> Dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in _OPS.items()}


def graph_launch_counts() -> Dict[str, int]:
    return dict(_qhnsw_ops.LAUNCHES)


def reset_launch_counts() -> None:
    for mod in _OPS.values():
        mod.LAUNCHES = 0
    for name in _qhnsw_ops.LAUNCHES:
        _qhnsw_ops.LAUNCHES[name] = 0
