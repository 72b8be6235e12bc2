"""Plain PyTorch versions of qgemm: direct wide dot products.

PyTorch has no int64 matmul on CUDA, so on the card the plain version
multiplies the raw values in float64. That is exact: with |raw| <= 2^16
and d <= 8192 every product is at most 2^32 and every partial sum at most
2^45 in magnitude, an integer below 2^53, whatever the summation order.
On the CPU the int64 matmul computes the same values directly.
"""
from __future__ import annotations

import torch


def qgemm_ref(queries: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """Exact wide dot scores [nq, nn] int64."""
    if queries.device.type == "cuda":
        return torch.matmul(queries.to(torch.float64),
                            database.to(torch.float64).T).to(torch.int64)
    return torch.matmul(queries.to(torch.int64), database.to(torch.int64).T)


def qgemm_planes_ref(queries: torch.Tensor, database: torch.Tensor
                     ) -> torch.Tensor:
    """The reference's three int32 limb planes [nq, nn, 3]:
    (sum h*h', sum h*l' + l*h', sum l*l') with h = raw >> 8, l = raw & 0xFF."""
    qh, ql = queries >> 8, queries & 0xFF
    dh, dl = database >> 8, database & 0xFF

    def dot(a, b):
        return qgemm_ref(a, b).to(torch.int32)

    s_hh = dot(qh, dh)
    s_hl = dot(qh, dl) + dot(ql, dh)
    s_ll = dot(ql, dl)
    return torch.stack([s_hh, s_hl, s_ll], dim=-1)


def combine_planes_ref(planes: torch.Tensor) -> torch.Tensor:
    p = planes.to(torch.int64)
    return (p[..., 0] << 16) + (p[..., 1] << 8) + p[..., 2]
