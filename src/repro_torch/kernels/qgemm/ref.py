"""Plain PyTorch versions of qgemm: direct wide dot products.

PyTorch has no int64 matmul on CUDA, so on the card the plain version
multiplies the raw values in float64. That is exact: with |raw| <= 2^16
and d <= 8192 every product is at most 2^32 and every partial sum at most
2^45 in magnitude, an integer below 2^53, whatever the summation order.
Outside that range (wider int32 values, int64 rows) it is not exact, and
the card's kernel is held against the CPU's int64 product instead. On the
CPU the int64 matmul computes the same values directly, for every value
(wrapping modulo 2^64 as the reference's does).

``qgemm_limbs_ref`` models the card kernel's limb split and s32 groups.
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


# --------------------------------------------------------------------------- #
# CPU model of the card kernel's limb arithmetic (a test aid: nothing on the
# main path calls it)
# --------------------------------------------------------------------------- #

STAGE = 64       # depth per pipeline stage of csrc/qgemm.cu
TILE_ROWS = 64   # queries per block, database rows per warpgroup
NARROW = 1 << 23  # the 3-limb split holds [-NARROW, NARROW)
_I32 = (-(1 << 31), (1 << 31) - 1)


def _wide_tiles(x: torch.Tensor) -> torch.Tensor:
    """[rows] bool: the row's 64-row tile holds a value outside the
    3-limb range in this stage (the tile-uniform decision)."""
    out_row = ((x < -NARROW) | (x >= NARROW)).any(dim=1)
    n = out_row.shape[0]
    tiles = torch.zeros(-(-n // TILE_ROWS) * TILE_ROWS, dtype=torch.bool)
    tiles[:n] = out_row
    return tiles.reshape(-1, TILE_ROWS).any(dim=1).repeat_interleave(
        TILE_ROWS)[:n]


def qgemm_limbs_ref(queries: torch.Tensor, database: torch.Tensor
                    ) -> torch.Tensor:
    """The kernel's arithmetic step for step on the CPU: per stage of 64
    values and per (64-query, 64-row) tile pair, the 3-limb split
    v = t * 2^16 + m * 2^8 + l (t = byte 2 as s8, m, l unsigned) with its
    nine products accumulated into five shift groups (0, 8, .., 32) that
    must stay inside int32 (asserted); or, where either tile holds a value
    outside [-2^23, 2^23), the stage's exact products summed in int64
    (wrapping), as the kernel's CUDA-core stages add them to the output.
    The groups combine into int64, wrapping. Returns [nq, nn] int64."""
    q, db = queries.to(torch.int64), database.to(torch.int64)
    nq, d = q.shape
    nn = db.shape[0]
    acc = torch.zeros((5, nq, nn), dtype=torch.int64)
    summed = torch.zeros((nq, nn), dtype=torch.int64)
    for k0 in range(0, d, STAGE):
        qs, ds = q[:, k0:k0 + STAGE], db[:, k0:k0 + STAGE]
        wide = _wide_tiles(qs)[:, None] | _wide_tiles(ds)[None, :]
        qt = ((((qs >> 16) & 0xFF) ^ 0x80) - 0x80, (qs >> 8) & 0xFF, qs & 0xFF)
        dt = ((((ds >> 16) & 0xFF) ^ 0x80) - 0x80, (ds >> 8) & 0xFF, ds & 0xFF)
        narrow = torch.zeros_like(acc)
        for i in range(3):
            for j in range(3):
                narrow[4 - i - j] += qt[i] @ dt[j].T
        acc += torch.where(wide[None], 0, narrow)
        summed += torch.where(wide, qs @ ds.T, 0)
        if acc.numel() and (acc.min() < _I32[0] or acc.max() > _I32[1]):
            raise AssertionError("a limb group left int32")
    out = summed
    for g in range(5):
        out = out + (acc[g] << (8 * g))
    return out
