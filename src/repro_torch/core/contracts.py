"""Precision contracts (paper §6): numeric precision as a memory contract.

A contract fixes the Q-format used inside the deterministic domain. The
storage dtype is the narrowest signed integer holding ``1 + int_bits +
frac_bits`` bits; sums of products accumulate in ``acc_dtype`` (twice the
storage width, int64 at most). Same table and names as the JAX package's
``repro.core.contracts``, with torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PrecisionContract:
    """A Q(int_bits).(frac_bits) fixed-point memory contract."""

    name: str
    int_bits: int   # integer bits excluding the sign bit
    frac_bits: int

    @property
    def total_bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def storage_dtype(self) -> torch.dtype:
        bits = self.total_bits
        if bits <= 8:
            return torch.int8
        if bits <= 16:
            return torch.int16
        if bits <= 32:
            return torch.int32
        if bits <= 64:
            return torch.int64
        raise ValueError(f"contract {self.name} needs {bits} bits > 64")

    @property
    def acc_dtype(self) -> torch.dtype:
        """Accumulator type for sums of products (2x storage width)."""
        return torch.int32 if self.total_bits <= 16 else torch.int64

    @property
    def one(self) -> int:
        return 1 << self.frac_bits

    @property
    def max_raw(self) -> int:
        return (1 << (self.int_bits + self.frac_bits)) - 1

    @property
    def min_raw(self) -> int:
        return -(1 << (self.int_bits + self.frac_bits))

    @property
    def max_value(self) -> float:
        return self.max_raw / self.one

    @property
    def min_value(self) -> float:
        return self.min_raw / self.one

    @property
    def resolution(self) -> float:
        return 1.0 / self.one

    @property
    def np_storage_dtype(self) -> np.dtype:
        return np.dtype(str(self.storage_dtype).removeprefix("torch."))

    def describe(self) -> str:
        return (
            f"{self.name}: range [{self.min_value}, {self.max_value}], "
            f"resolution {self.resolution:.2e}, storage {self.np_storage_dtype}, "
            f"accum {str(self.acc_dtype).removeprefix('torch.')}"
        )


Q8_8 = PrecisionContract("Q8.8", int_bits=7, frac_bits=8)
Q16_16 = PrecisionContract("Q16.16", int_bits=15, frac_bits=16)
Q32_32 = PrecisionContract("Q32.32", int_bits=31, frac_bits=32)
# narrow wire format used by the gradient-compression path
Q2_13 = PrecisionContract("Q2.13", int_bits=2, frac_bits=13)

CONTRACTS: Dict[str, PrecisionContract] = {
    c.name: c for c in (Q8_8, Q16_16, Q32_32, Q2_13)
}

DEFAULT_CONTRACT = Q16_16


def get_contract(name: str) -> PrecisionContract:
    try:
        return CONTRACTS[name]
    except KeyError as e:
        raise KeyError(
            f"unknown precision contract {name!r}; have {sorted(CONTRACTS)}"
        ) from e
