"""The float -> fixed-point boundary, written plainly in NumPy.

Semantics (DESIGN.md §5, the paper's §5.3): each float32 component is
scaled by 2^frac in float32, rounded half away from zero in float32,
clamped to the contract's range as float32 and converted with
saturation (NaN -> 0); then the row is L2-normalised in integers: the
int64 sum of squares, its exact floor square root, and each component
shifted up by frac and divided by the norm, rounded half away from zero,
then saturated. A zero-norm row passes through.

``normalize_float32`` is the control: the same function computed in
float32 instead of integers past the encode, the precision step a change
to the boundary would be tempted by. It breaks the bit-exactness the
configuration states.
"""
from __future__ import annotations

import math

import numpy as np

# (name, int_bits, frac_bits, storage dtype)
CONTRACTS = {
    "Q16.16": (15, 16, np.int32),
    "Q8.8": (7, 8, np.int16),
    "Q2.13": (2, 13, np.int16),
}


def _bounds(name):
    int_bits, frac, dtype = CONTRACTS[name]
    lo, hi = -(1 << (int_bits + frac)), (1 << (int_bits + frac)) - 1
    return int_bits, frac, dtype, lo, hi


def encode(x: np.ndarray, name: str = "Q16.16") -> np.ndarray:
    """float32 [..., d] -> int64 raw values (in the storage range)."""
    _, frac, dtype, lo, hi = _bounds(name)
    x = np.asarray(x, np.float32)
    scaled = x * np.float32(1 << frac)
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + np.float32(0.5))
    clamped = np.clip(rounded, np.float32(lo), np.float32(hi))
    t = clamped.astype(np.float64)
    info = np.iinfo(dtype)
    nan = np.isnan(t)
    over = t >= float(info.max) + 1.0
    under = t < float(info.min)
    out = np.where(nan | over | under, 0.0, t).astype(np.int64)
    out = np.where(over, info.max, out)
    return np.where(under, info.min, out)


def isqrt(s: np.ndarray) -> np.ndarray:
    """Exact floor square root of int64 values; a negative value (a
    wrapped sum) gives 0."""
    flat = s.reshape(-1)
    out = np.array([math.isqrt(int(v)) if v > 0 else 0 for v in flat],
                   np.int64)
    return out.reshape(s.shape)


def normalize(x: np.ndarray, name: str = "Q16.16") -> np.ndarray:
    """float32 [n, d] -> the stored rows, in the contract's storage dtype."""
    _, frac, dtype, lo, hi = _bounds(name)
    wide = encode(x, name)
    with np.errstate(over="ignore"):
        sq = np.einsum("ij,ij->i", wide, wide)[:, None]
    norm = isqrt(sq)
    safe = np.where(norm == 0, 1, norm)
    num = wide << frac
    a = np.abs(num)
    q = a // safe
    rem = a - q * safe
    mag = q + (2 * rem >= safe)
    out = np.where(num < 0, -mag, mag)
    out = np.where(norm == 0, wide, out)
    return np.clip(out, lo, hi).astype(dtype)


def normalize_float32(x: np.ndarray, name: str = "Q16.16") -> np.ndarray:
    """The control: encode, then normalise in float32 and round back."""
    _, frac, dtype, lo, hi = _bounds(name)
    wide = encode(x, name).astype(np.float32)
    norm = np.sqrt(np.einsum("ij,ij->i", wide, wide, dtype=np.float32))
    norm = np.where(norm == 0, np.float32(1), norm)[:, None]
    unit = wide / norm * np.float32(1 << frac)
    rounded = np.sign(unit) * np.floor(np.abs(unit) + np.float32(0.5))
    return np.clip(rounded, lo, hi).astype(dtype)
