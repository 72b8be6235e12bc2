"""The one traffic generator: every input of a run, drawn from ``--seed``
on the run's device.

A traffic mix (``traffic/<mix>.json``) is data: the rows filled in
set-up, the operations of one cycle of the closed loop and the data
distribution. Inputs are drawn per (stream, index) from a seed derived
from ``--seed`` and the stream's name, so any batch can be drawn again,
bit for bit, to hand the reference the same inputs, and every seed gives
the same sizes in the same order.

The data kind (``"data": {"kind": K, ...}``) is the module
``data/<K>.py``, found by name: its ``Data(data, dim, seed, device)`` has
``batch(stream, index, n)``.
"""
from __future__ import annotations

import zlib

from . import harness

_MASK = (1 << 64) - 1


def stream_id(name: str) -> int:
    """A fixed number for a stream's name (CRC-32 of its bytes)."""
    return zlib.crc32(name.encode())


def derive_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit seed for one (stream, index) of a run: SplitMix64 steps
    over ``seed`` (any integer, large ones included)."""
    z = (int(seed) * 0x9E3779B97F4A7C15
         + stream_id(stream) * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) & _MASK
    for _ in range(2):
        z = (z + 0x9E3779B97F4A7C15) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z >> 1


def make(data: dict, dim: int, seed: int, device):
    """The generator of a mix's ``data``."""
    return harness.part("data", data["kind"]).Data(data, dim, seed, device)
