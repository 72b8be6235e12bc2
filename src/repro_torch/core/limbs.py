"""Exact wide-integer (128-bit) arithmetic from 32-bit limbs.

The port of ``repro.core.limbs``: the paper's Table 2 "future" contract,
Q32.32, whose products need 128-bit accumulation. A signed 128-bit value
is four 32-bit limbs (little-endian, two's complement) built from
single-width integer operations with explicit carries, so the § 5.1
determinism argument extends to the wide domain unchanged.

The reference computes in uint64 and keeps its limbs as uint32. Here every
limb is an int64 tensor holding the limb's value in [0, 2^32): int64
wraparound add, multiply and xor give the same bits as uint64, and each
right shift of a value that may have bit 63 set is masked back to 32 bits
(``(x >> 32) & 0xFFFFFFFF``), which is the logical shift. ``to_float`` and
``to_python_int`` give the reference's values.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF

# A wide value: 4 int64 tensors of limb values in [0, 2^32), lo → hi.
Wide = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _hi32(x: torch.Tensor) -> torch.Tensor:
    """Bits 32..63 of a 64-bit word (the uint64 ``x >> 32``)."""
    return (x >> 32) & _MASK32


def from_int64(x: torch.Tensor) -> Wide:
    """Sign-extend int64 → 4-limb two's complement."""
    x = x.to(torch.int64)
    sign = torch.where(x < 0, _MASK32, 0).to(torch.int64)
    return (x & _MASK32, _hi32(x), sign, sign)


def zeros_like_wide(x: torch.Tensor) -> Wide:
    z = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    return (z, z, z, z)


def wide_add(a: Wide, b: Wide) -> Wide:
    """Limbwise add with carry propagation (mod 2^128, two's complement)."""
    out = []
    carry = torch.zeros_like(a[0])
    for i in range(4):
        s = a[i] + b[i] + carry
        out.append(s & _MASK32)
        carry = s >> 32
    return tuple(out)


def wide_neg(a: Wide) -> Wide:
    inv = tuple((~x) & _MASK32 for x in a)
    z = torch.zeros_like(a[0])
    return wide_add(inv, (torch.ones_like(a[0]), z, z, z))


def mul_i64_i64(a: torch.Tensor, b: torch.Tensor) -> Wide:
    """Exact signed 64×64 → 128-bit product via 32-bit limb partials.

    |a|, |b| split into (lo, hi) limbs; four 32×32→64 partial products
    (exact as uint64 bits) are accumulated with carries; the sign is
    applied by two's complement. ``abs(-2^63)`` wraps to the bits of 2^63,
    which is its magnitude as uint64."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    sign = (a < 0) ^ (b < 0)
    ua, ub = torch.abs(a), torch.abs(b)
    a0, a1 = ua & _MASK32, _hi32(ua)
    b0, b1 = ub & _MASK32, _hi32(ub)

    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1

    l0 = p00 & _MASK32
    t1 = _hi32(p00) + (p01 & _MASK32) + (p10 & _MASK32)
    l1 = t1 & _MASK32
    t2 = (t1 >> 32) + _hi32(p01) + _hi32(p10) + (p11 & _MASK32)
    l2 = t2 & _MASK32
    l3 = ((t2 >> 32) + _hi32(p11)) & _MASK32
    mag = (l0, l1, l2, l3)
    neg = wide_neg(mag)
    return tuple(torch.where(sign, n, m) for n, m in zip(neg, mag))


def wide_sum(w: Wide, axis: int = -1) -> Wide:
    """Order-invariant exact sum along an axis: per-limb 64-bit partial
    sums with deferred carry propagation (each limb sum ≤ 2^32 · n < 2^64
    for n < 2^32 elements; int64 wraparound keeps the uint64 bits)."""
    sums = [torch.sum(x, dim=axis, dtype=torch.int64) for x in w]
    out = []
    carry = torch.zeros_like(sums[0])
    for s in sums:
        t = s + carry
        out.append(t & _MASK32)
        carry = _hi32(t)
    return tuple(out)


def to_float(w: Wide) -> torch.Tensor:
    """Approximate float64 view (for diagnostics; exactness lives in limbs)."""
    negative = ((w[3] >> 31) & 1) == 1
    neg = wide_neg(w)
    limbs = [torch.where(negative, n, p) for n, p in zip(neg, w)]
    val = torch.zeros(w[0].shape, dtype=torch.float64, device=w[0].device)
    for i, x in enumerate(limbs):
        val = val + x.to(torch.float64) * (2.0 ** (32 * i))
    return torch.where(negative, -val, val)


def to_python_int(w) -> int:
    """Host-side exact conversion (scalar) for tests."""
    limbs = [int(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x))
             for x in w]
    u = sum(limb << (32 * i) for i, limb in enumerate(limbs))
    if u >= 1 << 127:
        u -= 1 << 128
    return u


# --------------------------------------------------------------------------- #
# Q32.32 operations built on limbs
# --------------------------------------------------------------------------- #


def qdot_q32_wide(a: torch.Tensor, b: torch.Tensor, axis: int = -1) -> Wide:
    """Exact Q32.32 dot product accumulated in 128 bits (Q(64) scale): the
    exact Σ aᵢ·bᵢ of int64 raw Q32.32 values, wide and unshifted."""
    return wide_sum(mul_i64_i64(a, b), axis=axis)


def q32_dot_to_q32(a: torch.Tensor, b: torch.Tensor, axis: int = -1
                   ) -> torch.Tensor:
    """Q32.32 dot renormalized back to Q32.32 (int64), saturating.

    Shift right by 32 = drop limb 0; saturate to int64 when the true value
    exceeds 64 bits (limb 3 must be the sign extension of limb 2's msb)."""
    _, l1, l2, l3 = qdot_q32_wide(a, b, axis)
    val = l1 | (l2 << 32)
    sign = (l2 >> 31) & 1
    expect_l3 = torch.where(sign == 1, _MASK32, 0).to(torch.int64)
    ok = l3 == expect_l3
    pos_overflow = (l3 >> 31) == 0
    sat = torch.where(pos_overflow, torch.full_like(val, (1 << 63) - 1),
                      torch.full_like(val, -(1 << 63)))
    return torch.where(ok, val, sat)
