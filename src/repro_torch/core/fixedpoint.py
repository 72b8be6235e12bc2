"""Q-format fixed-point arithmetic in PyTorch (paper §5.1): the parts the
flat substrate's path uses — the float→fixed encode, decode, saturation,
and the exact integer L2 normalization (``isqrt`` + round-to-nearest
division) behind the unit-norm boundary.

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


def saturate(wide: torch.Tensor, contract: PrecisionContract = DEFAULT_CONTRACT
             ) -> torch.Tensor:
    """Clamp a wide-integer value into the contract's raw range and narrow."""
    return torch.clamp(wide, contract.min_raw, contract.max_raw).to(
        contract.storage_dtype)


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
