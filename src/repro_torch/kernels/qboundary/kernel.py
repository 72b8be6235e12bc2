"""Launch of the hand-written qboundary CUDA kernel (``csrc/qboundary.cu``).

Replaces ``_qboundary_kernel`` / ``qboundary_pallas`` of
``repro/kernels/qboundary/kernel.py`` (the Pallas TPU kernel).

What bounds it on the card: bytes. It reads 4 bytes and writes 4 bytes
per element and does a handful of float and integer operations on each,
far below the card's compute rate; a 512 x 2304 ingest batch moves 9.4 MB.
At such sizes the launch itself and the per-row isqrt (32 dependent steps
on one thread) are what remain.

What the design does about it: one block per row, so the row's sum of
squares reduces in shared memory and the row is read from device memory
once; the second pass (the division) re-reads the row's encoded values
from the output, which the same thread wrote and which sits in L1/L2.
Float steps are separate correctly rounded intrinsics so the encode is
bit-identical to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.contracts import PrecisionContract
from repro_torch.core.fixedpoint import _f32_safe_bounds
from repro_torch.kernels import _build


def launch(x: torch.Tensor, out: torch.Tensor, contract: PrecisionContract,
           unit_norm: bool) -> None:
    """x float32 [n, d] and out int32 [n, d], both contiguous on one card."""
    n, d = x.shape
    lo, hi = _f32_safe_bounds(contract)
    fn = _build.launcher("qboundary")
    err = fn(x.data_ptr(), out.data_ptr(), n, d, float(contract.one), lo, hi,
             contract.min_raw, contract.max_raw, contract.frac_bits,
             int(unit_norm), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("qboundary", err)
