"""Plain PyTorch version of qboundary (encode then integer qnorm), and the
CPU model of the card kernel's arithmetic.

``qboundary_ref`` is the plain version that the tests and ``chip_smoke.py``
compare the kernel against. ``qboundary_model`` computes the same function
the way ``csrc/qboundary.cu`` does, step for step, so that the CPU tests
can hold the kernel's arithmetic against the reference: the unchanged
encode, the floor square root as a correctly rounded float64 sqrt with one
exact correction step (``isqrt_model``), and the rounded division as one
reciprocal per row, a float64 product and one exact correction step
(``divide_model``), or beyond the reciprocal's bound one exact integer
divide per element (``divide_wide_model``). Edit the model and the CUDA
source together.
"""
from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fp
from repro_torch.core.contracts import PrecisionContract

# The reciprocal division is exact while |raw << frac_bits| < 2^52, that
# is int_bits + 2 * frac_bits <= DIV_BITS (Q16.16: 47); csrc/qboundary.cu
# states the proof. Beyond it, up to WIDE_BITS (every int32 contract: at
# most 0 + 2 * 31), the kernel divides exactly in 64 bits; the launch
# constants refuse a unit-norm contract beyond that (Q32.32: 96).
DIV_BITS = 51
WIDE_BITS = 62


def qboundary_ref(x: torch.Tensor, contract: PrecisionContract,
                  unit_norm: bool = True) -> torch.Tensor:
    raw = fp.encode(x, contract)
    if unit_norm:
        raw = fp.qnorm(raw, axis=-1, contract=contract)
    return raw


def isqrt_model(s: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(s)) of int64 ``s`` as the kernel computes it: r =
    trunc(sqrt_rn(float64(s))), then one step down if r * r > s or up if
    s - r * r >= 2r + 1. ``s <= 0`` (a wrapped sum) gives 0."""
    s = s.to(torch.int64)
    pos = s > 0
    r = torch.sqrt(torch.where(pos, s, 0).to(torch.float64)).to(torch.int64)
    sq = r * r
    r = torch.where(sq > s, r - 1, torch.where(s - sq >= 2 * r + 1, r + 1, r))
    return torch.where(pos, r, 0)


def divide_model(num: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """num / norm rounded half away from zero, for int64 ``num`` with
    |num| < 2^52 and int64 ``norm`` >= 1 (broadcast), as the kernel
    computes it: q0 = trunc(RN(float64(|num|) * RN(1 / norm))), one exact
    correction step on the remainder, then + (2 * rem >= norm)."""
    a = num.abs()
    inv = 1.0 / norm.to(torch.float64)
    q = (a.to(torch.float64) * inv).to(torch.int64)
    rem = a - q * norm
    down, up = rem < 0, rem >= norm
    q = q - down.to(torch.int64) + up.to(torch.int64)
    rem = torch.where(down, rem + norm, torch.where(up, rem - norm, rem))
    mag = q + (2 * rem >= norm).to(torch.int64)
    return torch.where(num < 0, -mag, mag)


def divide_wide_model(num: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """num / norm rounded half away from zero, for int64 ``num`` with
    |num| < 2^63 and int64 ``norm`` >= 1, as the kernel's wide instance
    computes it: q = |num| // norm and rem = |num| - q * norm exactly, then
    + (2 * rem >= norm)."""
    a = num.abs()
    q = torch.div(a, norm, rounding_mode="floor")
    rem = a - q * norm
    mag = q + (2 * rem >= norm).to(torch.int64)
    return torch.where(num < 0, -mag, mag)


def qboundary_model(x: torch.Tensor, contract: PrecisionContract,
                    unit_norm: bool = True) -> torch.Tensor:
    """The kernel's arithmetic on the CPU: equal to ``qboundary_ref`` for
    every contract with int_bits + 2 * frac_bits <= WIDE_BITS (the
    reciprocal division up to DIV_BITS, the exact divide beyond)."""
    bits = contract.int_bits + 2 * contract.frac_bits
    if unit_norm and bits > WIDE_BITS:
        raise ValueError(f"|raw << frac_bits| does not fit in 64 bits for "
                         f"{contract.name}")
    raw = fp.encode(x, contract)
    if not unit_norm:
        return raw
    wide = raw.to(torch.int64)
    sq = torch.sum(wide * wide, dim=-1, keepdim=True)  # wraps like int64
    norm = isqrt_model(sq)
    divide = divide_wide_model if bits > DIV_BITS else divide_model
    out = divide(wide << contract.frac_bits, torch.where(norm == 0, 1, norm))
    out = torch.where(norm == 0, wide, out)
    return fp.saturate(out, contract)
