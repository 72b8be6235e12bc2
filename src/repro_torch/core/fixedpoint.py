"""Q-format fixed-point arithmetic in PyTorch (paper §5.1), the port of
``repro.core.fixedpoint``: the float→fixed encode and decode, saturation,
the arithmetic (add, subtract, negate, multiply, divide, sums, means and
dot products, with Q32.32 products through ``core.limbs``) and the exact
integer L2 normalization (``isqrt`` + round-to-nearest division) behind
the unit-norm boundary.

Conventions, as in the reference: "raw" values are the integers of the
contract's storage dtype; products widen to ``contract.acc_dtype`` and
shift back once with round half up (``(x + half) >> frac_bits``); every
narrowing saturates; integer sums accumulate in int64.

Every operation after ``encode`` is integer arithmetic with explicit
dtypes, so results are bit-identical on the CPU and on the card. ``encode``
itself is the determinism boundary: each float32 step (multiply, abs,
+0.5, floor) is one correctly rounded IEEE operation, issued as its own
tensor op so that nothing can contract into a fused multiply-add.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract


def _f32_safe_bounds(contract: PrecisionContract):
    """The float32 clamp bounds of ``encode``: the contract's raw range
    rounded to float32 (round to nearest). At the top of a 32- or 64-bit
    range that rounds *up* to 2^31 or 2^63; the saturating convert below
    then lands it on the storage maximum, exactly as the reference does."""
    return float(np.float32(contract.min_raw)), float(np.float32(contract.max_raw))


def _saturating_convert(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 → integer with saturation at the type's range and NaN → 0
    (the float-to-int convert semantics of XLA and of PTX ``cvt.rzi``).
    ``x`` holds integral values already (it is floored and clamped)."""
    info = torch.iinfo(dtype)
    t = x.to(torch.float64)
    nan = torch.isnan(t)
    hi = t >= float(info.max) + 1.0   # only exactly 2^(bits-1) reaches here
    lo = t < float(info.min)
    safe = torch.where(nan | hi | lo, torch.zeros_like(t), t).to(torch.int64)
    out = torch.where(hi, torch.full_like(safe, info.max), safe)
    out = torch.where(lo, torch.full_like(out, info.min), out)
    return out.to(dtype)


def encode(x, contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """Quantize floats into raw fixed-point integers (saturating).

    Round half away from zero on the float32-scaled value, clamp to the
    contract range, convert with saturation. Every float32 step is one
    correctly rounded op, so the bits match any IEEE implementation of
    the same sequence (the qboundary kernel included)."""
    x = torch.as_tensor(x).to(torch.float32)
    scaled = x * float(contract.one)
    rounded = torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)
    lo, hi = _f32_safe_bounds(contract)
    clamped = torch.clamp(rounded, lo, hi)
    return _saturating_convert(clamped, contract.storage_dtype)


def decode(raw: torch.Tensor, contract: PrecisionContract = DEFAULT_CONTRACT
           ) -> torch.Tensor:
    """Raw fixed-point → float64 (exact: every raw value is representable)."""
    return raw.to(torch.float64) / contract.one


def decode_f32(raw: torch.Tensor,
               contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """Raw fixed-point → float32 (one correctly rounded convert and divide)."""
    return raw.to(torch.float32) / float(contract.one)


def saturate(wide: torch.Tensor, contract: PrecisionContract = DEFAULT_CONTRACT
             ) -> torch.Tensor:
    """Clamp a wide-integer value into the contract's raw range and narrow."""
    return torch.clamp(wide, contract.min_raw, contract.max_raw).to(
        contract.storage_dtype)


def _shift_back(wide: torch.Tensor, contract: PrecisionContract
                ) -> torch.Tensor:
    """Divide a wide product by 2^frac_bits with round-half-up (arith shift)."""
    return (wide + (1 << (contract.frac_bits - 1))) >> contract.frac_bits


def _require_wide_products(contract: PrecisionContract) -> None:
    """Products need 2x the storage width; int64 storage would need int128.
    Q32.32 is served by ``qmul_q32`` / ``qdot_q32`` (``core.limbs``); the
    narrow-contract paths refuse loudly instead of wrapping."""
    if contract.storage_dtype.itemsize >= 8:
        raise NotImplementedError(
            f"{contract.name}: products need >64-bit accumulation; "
            "use qmul_q32/qdot_q32 (core.limbs) for Q32.32")


def _acc(x: torch.Tensor, contract: PrecisionContract) -> torch.Tensor:
    return torch.as_tensor(x).to(contract.acc_dtype)


def qadd(a, b, contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    return saturate(_acc(a, contract) + _acc(b, contract), contract)


def qsub(a, b, contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    return saturate(_acc(a, contract) - _acc(b, contract), contract)


def qneg(a, contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    return saturate(-_acc(a, contract), contract)


def qmul(a, b, contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """Fixed-point multiply: widen, multiply exactly, shift back, saturate."""
    _require_wide_products(contract)
    wide = _acc(a, contract) * _acc(b, contract)
    return saturate(_shift_back(wide, contract), contract)


def qdiv(a, b, contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """Fixed-point divide. b == 0 saturates to the signed max of matching sign."""
    a = torch.as_tensor(a)
    wide_a = _acc(a, contract) << contract.frac_bits
    wide_b = _acc(b, contract)
    safe_b = torch.where(wide_b == 0, torch.ones_like(wide_b), wide_b)
    q = _int_div_round_to_nearest(wide_a, safe_b)
    sat = torch.where(a >= 0, contract.max_raw, contract.min_raw).to(
        contract.acc_dtype)
    q = torch.where(wide_b == 0, sat, q)
    return saturate(q, contract)


def qmul_q32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact Q32.32 multiply: 64×64→128-bit limbs, >>32, saturate to int64."""
    from repro_torch.core import limbs
    return limbs.q32_dot_to_q32(a[..., None], b[..., None], axis=-1)


def qdot_q32(a: torch.Tensor, b: torch.Tensor, axis: int = -1
             ) -> torch.Tensor:
    """Exact Q32.32 dot product (128-bit accumulation), Q32.32 result."""
    from repro_torch.core import limbs
    if axis != -1:
        a = torch.movedim(a, axis, -1)
        b = torch.movedim(b, axis, -1)
    return limbs.q32_dot_to_q32(a, b, axis=-1)


def qdot(a, b, axis: int = -1,
         contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """Fixed-point dot product along ``axis``: exact wide products, an
    integer (order-invariant) sum, one shift back at the end."""
    _require_wide_products(contract)
    acc = torch.sum(_acc(a, contract) * _acc(b, contract), dim=axis,
                    dtype=torch.int64)
    return saturate(_shift_back(acc, contract), contract)


def qdot_wide(a, b, axis: int = -1,
              contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """Like ``qdot`` but returns the wide (unshifted, Q(2f)) accumulator."""
    _require_wide_products(contract)
    return torch.sum(_acc(a, contract) * _acc(b, contract), dim=axis,
                     dtype=torch.int64)


def ql2sq_wide(a, b, axis: int = -1,
               contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """Squared L2 distance in the wide accumulator (exact, Q(2f) scale)."""
    d = _acc(a, contract) - _acc(b, contract)
    return torch.sum(d * d, dim=axis, dtype=torch.int64)


def _sum_all(a: torch.Tensor, axis) -> torch.Tensor:
    if axis is None:
        return torch.sum(a, dtype=torch.int64)
    return torch.sum(a, dim=axis, dtype=torch.int64)


def qsum(a, axis=None, contract: PrecisionContract = DEFAULT_CONTRACT
         ) -> torch.Tensor:
    return saturate(_sum_all(_acc(a, contract), axis), contract)


def qmean(a, axis=None, contract: PrecisionContract = DEFAULT_CONTRACT
          ) -> torch.Tensor:
    a = torch.as_tensor(a)
    wide = _sum_all(_acc(a, contract), axis)
    n = a.shape[axis] if isinstance(axis, int) else a.numel()
    return saturate(_int_div_round_to_nearest(wide, torch.full_like(wide, n)),
                    contract)


def _int_div_round_to_nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer division rounded to nearest (half away from zero), exact.
    Works from |a| // |b| so behaviour is symmetric in sign."""
    abs_a, abs_b = torch.abs(a), torch.abs(b)
    q = torch.div(abs_a, abs_b, rounding_mode="floor")
    rem = abs_a - abs_b * q
    adjust = (2 * rem >= abs_b).to(a.dtype)
    sign = torch.where((a < 0) ^ (b < 0), -1, 1).to(a.dtype)
    return sign * (q + adjust)


def isqrt(x: torch.Tensor) -> torch.Tensor:
    """Exact integer floor-sqrt of non-negative int64 values: the 32-step
    digit recurrence (bit runs over every power of four from 2^62 down).
    A negative input (a wrapped sum of squares) yields 0."""
    rem = x.to(torch.int64)
    res = torch.zeros_like(rem)
    for i in range(32):
        bit = 1 << (62 - 2 * i)
        take = rem >= res + bit
        rem = torch.where(take, rem - (res + bit), rem)
        res = torch.where(take, (res >> 1) + bit, res >> 1)
    return res


def qnorm(v: torch.Tensor, axis: int = -1,
          contract: PrecisionContract = DEFAULT_CONTRACT) -> torch.Tensor:
    """L2-normalize fixed-point vectors in integers only.

    ||v||^2 is summed in int64 (wrapping, like the reference), isqrt gives
    the norm at Q(f) scale, and each component becomes (v_i << f) / norm
    rounded to nearest. Zero-norm rows pass through unchanged."""
    wide = v.to(contract.acc_dtype)
    sq = torch.sum(wide * wide, dim=axis, keepdim=True, dtype=torch.int64)
    norm_raw = isqrt(sq).to(contract.acc_dtype)
    safe = torch.where(norm_raw == 0, torch.ones_like(norm_raw), norm_raw)
    num = wide << contract.frac_bits
    out = _int_div_round_to_nearest(num, safe)
    out = torch.where(norm_raw == 0, wide, out)
    return saturate(out, contract)
