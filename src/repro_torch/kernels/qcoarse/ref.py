"""Plain PyTorch versions of qcoarse: direct wide dot products.

PyTorch has no int64 matmul on CUDA, so on the card the plain version
multiplies in float64. That is exact: with |w| <= 2^28 and |c| <= 127
every product is below 2^35 in magnitude, and every partial sum over
d <= 8192 terms stays below 2^48 < 2^53, an integer float64 holds exactly
whatever the summation order. On the CPU the int64 matmul computes the
same values directly.
"""
from __future__ import annotations

import torch


def qcoarse_ref(weights: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact weighted dot S [nq, nn] int64 (the int64-accumulator rule)."""
    if weights.device.type == "cuda":
        return torch.matmul(weights.to(torch.float64),
                            codes.to(torch.float64).T).to(torch.int64)
    return torch.matmul(weights.to(torch.int64), codes.to(torch.int64).T)


def qcoarse_planes_ref(weights: torch.Tensor, codes: torch.Tensor
                       ) -> torch.Tensor:
    """The reference's four int32 limb planes [nq, nn, 4]:
    sum w_l * c for w3 = w >> 24 (signed) and the unsigned bytes
    w2 = (w >> 16) & 0xFF, w1 = (w >> 8) & 0xFF, w0 = w & 0xFF."""
    w = weights.to(torch.int32)
    limbs = (w >> 24, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF)
    return torch.stack([qcoarse_ref(l, codes).to(torch.int32) for l in limbs],
                       dim=-1)


def combine_planes_ref(planes: torch.Tensor) -> torch.Tensor:
    p = planes.to(torch.int64)
    return (p[..., 0] << 24) + (p[..., 1] << 16) + (p[..., 2] << 8) + p[..., 3]


# --------------------------------------------------------------------------- #
# CPU model of the card kernel's limb arithmetic (a test aid: nothing on the
# main path calls it)
# --------------------------------------------------------------------------- #

STAGE = 128  # depth per pipeline stage of csrc/qcoarse.cu


def qcoarse_limbs_ref(weights: torch.Tensor, codes: torch.Tensor
                      ) -> torch.Tensor:
    """The kernel's arithmetic step for step on the CPU: weights split into
    byte 3 (s8) and bytes 2..0 (u8), four planes sum_k w_l * c accumulated
    stage by stage (128 codes) and asserted to stay inside int32, then
    combined as (P3 << 24) + (P2 << 16) + (P1 << 8) + P0 in int64.
    Returns [nq, nn] int64."""
    w, c = weights.to(torch.int64), codes.to(torch.int64)
    limbs = (w >> 24, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF)
    acc = torch.zeros((4, w.shape[0], c.shape[0]), dtype=torch.int64)
    for k0 in range(0, w.shape[1], STAGE):
        ck = c[:, k0:k0 + STAGE].T
        for l in range(4):
            acc[l] += limbs[l][:, k0:k0 + STAGE] @ ck
        if acc.numel() and (acc.min() < -(1 << 31) or acc.max() >= 1 << 31):
            raise AssertionError("a limb plane left int32")
    return (acc[0] << 24) + (acc[1] << 16) + (acc[2] << 8) + acc[3]
