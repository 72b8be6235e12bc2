"""Wrapper of the fused boundary kernel: contract plumbing and dispatch.

On a CUDA tensor with an int32-storage contract it launches the CUDA
kernel (or raises); on a CPU tensor, and for every other contract, it
computes the plain version — the same rule as the reference wrapper,
which kernelizes int32 storage only.
"""
from __future__ import annotations

import torch

from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract
from repro_torch.kernels.qboundary import kernel as _kernel
from repro_torch.kernels.qboundary import ref

LAUNCHES = 0  # kernel launches since the last reset


def qboundary(x: torch.Tensor, contract: PrecisionContract = DEFAULT_CONTRACT,
              *, unit_norm: bool = True) -> torch.Tensor:
    """float32 [n, d] → raw fixed-point (unit) vectors [n, d].

    Bit-identical to ``boundary.normalize_embedding`` on the same input."""
    global LAUNCHES
    if x.device.type != "cuda" or contract.storage_dtype != torch.int32:
        return ref.qboundary_ref(x, contract, unit_norm)
    if x.dim() != 2:
        raise ValueError(f"qboundary takes [n, d], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"qboundary takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("qboundary needs a contiguous input")
    out = torch.empty_like(x, dtype=torch.int32)
    _kernel.launch(x, out, contract, unit_norm)
    LAUNCHES += 1
    return out
