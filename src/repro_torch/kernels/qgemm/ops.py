"""Wrapper of the qgemm kernel: the reference's range contract and dispatch.

``qgemm`` returns the exact int64 dot scores. On a CUDA tensor it launches
the CUDA kernel (or raises); on a CPU tensor it computes the plain version.

Dispatch on the card is by element type, inside one kernel library:
int16 and int32 rows run on the int8 tensor cores (limb split, exact for
every value), int64 rows (Q32.32) on the CUDA cores with wrapping 64-bit
multiply-adds. Both equal the reference's plain int64 matmul bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.qgemm import kernel as _kernel
from repro_torch.kernels.qgemm import ref

# the reference's exactness contract: |raw| <= RAW_BOUND and dim <= MAX_DIM
# (the card's kernel is exact for every int16/int32/int64 value; MAX_DIM
# bounds its s32 limb groups, and callers split deeper products)
RAW_BOUND = 1 << 16
MAX_DIM = 1 << 13
DTYPES = (torch.int16, torch.int32, torch.int64)


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
    _check_dim(queries)
    if queries.device.type != "cuda":
        return ref.qgemm_ref(queries, database)
    if queries.dim() != 2 or database.dim() != 2 \
            or queries.shape[1] != database.shape[1]:
        raise ValueError(f"qgemm takes [nq, d] x [nn, d], got "
                         f"{tuple(queries.shape)} x {tuple(database.shape)}")
    if queries.dtype not in DTYPES or database.dtype != queries.dtype:
        raise TypeError(f"qgemm takes two int16, int32 or int64 operands, "
                        f"got {queries.dtype}, {database.dtype}")
    if database.device != queries.device:
        raise ValueError("qgemm inputs must be on one device")
    if not (queries.is_contiguous() and database.is_contiguous()):
        raise ValueError("qgemm needs contiguous inputs")
    out = torch.empty((queries.shape[0], database.shape[0]), dtype=torch.int64,
                      device=queries.device)
    _kernel.launch(queries, database, out)
    obs.count("launch.qgemm")
    return out
