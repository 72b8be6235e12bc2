"""Wrapper of the qcoarse kernel: the reference's range contract and dispatch.

``qcoarse`` returns the exact int64 weighted-dot scores of int32 query
weights against int8 code rows. On a CUDA tensor it launches the CUDA
kernel (or raises); on a CPU tensor it computes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.qcoarse import kernel as _kernel
from repro_torch.kernels.qcoarse import ref

# |w| <= W_BOUND (codes.query_weights clips) keeps all four int32 planes
# overflow-free up to MAX_DIM: 255 * 127 * 2^13 < 2^31.
W_BOUND = 1 << 28
MAX_DIM = 1 << 13


def _check_dim(weights: torch.Tensor) -> None:
    if weights.shape[-1] > MAX_DIM:
        raise ValueError(
            f"qcoarse exactness bound needs dim ≤ {MAX_DIM}, "
            f"got {weights.shape[-1]}")


def qcoarse_planes(weights: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The reference's four int32 limb planes [nq, nn, 4] (plain version;
    the kernel combines them before they leave the chip)."""
    _check_dim(weights)
    return ref.qcoarse_planes_ref(weights, codes)


def qcoarse(weights: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact weighted-dot scores S [nq, nn] int64 of int32 weights [nq, d]
    against int8 codes [nn, d]."""
    _check_dim(weights)
    if weights.device.type != "cuda":
        return ref.qcoarse_ref(weights, codes)
    if weights.dim() != 2 or codes.dim() != 2 \
            or weights.shape[1] != codes.shape[1]:
        raise ValueError(f"qcoarse takes [nq, d] x [nn, d], got "
                         f"{tuple(weights.shape)} x {tuple(codes.shape)}")
    if weights.dtype != torch.int32 or codes.dtype != torch.int8:
        raise TypeError(f"qcoarse takes int32 weights and int8 codes, got "
                        f"{weights.dtype}, {codes.dtype}")
    if codes.device != weights.device:
        raise ValueError("qcoarse inputs must be on one device")
    if not (weights.is_contiguous() and codes.is_contiguous()):
        raise ValueError("qcoarse needs contiguous inputs")
    nq, d = weights.shape
    limbs = torch.empty((_kernel.scratch_bytes(nq, d),), dtype=torch.uint8,
                        device=weights.device)
    out = torch.empty((nq, codes.shape[0]), dtype=torch.int64,
                      device=weights.device)
    _kernel.launch(weights, codes, limbs, out)
    obs.count("launch.qcoarse")
    return out
