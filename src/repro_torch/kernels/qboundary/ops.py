"""Wrapper of the fused boundary kernel: contract plumbing and dispatch.

On a CUDA tensor it launches the CUDA kernel (or raises) for every int32
contract, and computes the plain version for the rest; on a CPU tensor it
always computes the plain version. The rule is static, keyed on the
contract's storage type, never a fallback on failure: storage other than
int32 takes the plain version, the reference wrapper's own rule, which
kernelizes int32 storage only. Within int32 the kernel picks its division
from the contract: one reciprocal per row while ``int_bits + 2 *
frac_bits <= kernel.DIV_BITS`` (51; Q16.16 is 47), an exact 64-bit divide
per element beyond it (e.g. Q4.27 at 58, Q1.30 at 61).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract
from repro_torch.kernels.qboundary import kernel as _kernel
from repro_torch.kernels.qboundary import ref


def uses_kernel(contract: PrecisionContract) -> bool:
    """Whether a CUDA tensor under ``contract`` goes through the kernel."""
    return contract.storage_dtype == torch.int32


def qboundary(x: torch.Tensor, contract: PrecisionContract = DEFAULT_CONTRACT,
              *, unit_norm: bool = True) -> torch.Tensor:
    """float32 [n, d] → raw fixed-point (unit) vectors [n, d].

    Bit-identical to ``boundary.normalize_embedding`` on the same input."""
    if x.device.type != "cuda" or not uses_kernel(contract):
        return ref.qboundary_ref(x, contract, unit_norm)
    if x.dim() != 2:
        raise ValueError(f"qboundary takes [n, d], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"qboundary takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("qboundary needs a contiguous input")
    out = torch.empty_like(x, dtype=torch.int32)
    _kernel.launch(x, out, contract, unit_norm)
    obs.count("launch.qboundary")
    return out
