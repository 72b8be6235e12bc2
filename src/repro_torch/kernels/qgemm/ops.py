"""Wrapper of the qgemm kernel: the reference's range contract and dispatch.

``qgemm`` returns the exact int64 dot scores. On a CUDA tensor it launches
the CUDA kernel (or raises); on a CPU tensor it computes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qgemm import kernel as _kernel
from repro_torch.kernels.qgemm import ref

# the reference's exactness contract: |raw| <= RAW_BOUND and dim <= MAX_DIM
RAW_BOUND = 1 << 16
MAX_DIM = 1 << 13

LAUNCHES = 0  # kernel launches since the last reset


def _check_dim(queries: torch.Tensor) -> None:
    if queries.shape[-1] > MAX_DIM:
        raise ValueError(
            f"qgemm exactness bound needs dim ≤ {MAX_DIM}, got {queries.shape[-1]}")


def qgemm_planes(queries: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """The reference's three int32 limb planes [nq, nn, 3] (plain version;
    the kernel computes the combined int64 scores directly)."""
    _check_dim(queries)
    return ref.qgemm_planes_ref(queries, database)


def qgemm(queries: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """Exact wide int64 dot scores [nq, nn] of raw fixed-point rows."""
    global LAUNCHES
    _check_dim(queries)
    if queries.device.type != "cuda":
        return ref.qgemm_ref(queries, database)
    if queries.dim() != 2 or database.dim() != 2 \
            or queries.shape[1] != database.shape[1]:
        raise ValueError(f"qgemm takes [nq, d] x [nn, d], got "
                         f"{tuple(queries.shape)} x {tuple(database.shape)}")
    if queries.dtype != torch.int32 or database.dtype != torch.int32:
        raise TypeError(f"qgemm takes int32, got {queries.dtype}, {database.dtype}")
    if database.device != queries.device:
        raise ValueError("qgemm inputs must be on one device")
    if not (queries.is_contiguous() and database.is_contiguous()):
        raise ValueError("qgemm needs contiguous inputs")
    out = torch.empty((queries.shape[0], database.shape[0]), dtype=torch.int64,
                      device=queries.device)
    _kernel.launch(queries, database, out)
    LAUNCHES += 1
    return out
