"""Launch of the hand-written qboundary CUDA kernel (``csrc/qboundary.cu``).

Replaces ``_qboundary_kernel`` / ``qboundary_pallas`` of
``repro/kernels/qboundary/kernel.py`` (the Pallas TPU kernel).

What bounds it on the card: bytes. It reads 4 bytes and writes 4 bytes
per element and does a few dozen float and integer operations on each,
far below the card's compute rate; a 512 x 2304 ingest batch moves 9.4 MB
(2.8 us at 3.35 TB/s), a 64 x 2304 query batch 1.2 MB (0.35 us), where
launch latency is all the time there is.

What the design does about it (changed from the first port's kernel, a
256-thread block per row that wrote the encoded row to ``out``, read it
back for the division and divided each element with a 64-bit integer
divide after a 32-step isqrt on one thread):

* one block per row holds the row in registers from the encode through
  the sum of squares to the division, so each element is read once and
  written once;
* 16-byte loads and stores when d % 4 == 0 and both row bases are 16-byte
  aligned (``path`` says which path a call takes); otherwise the same
  kernel moves single values. Threads per row are sized to the row (each
  holds 1, 2, 4 or 8 groups of four values); rows beyond 32768 values
  take a looped two-pass kernel;
* one correctly rounded reciprocal per row and a float64 product with one
  exact correction step per element instead of a 64-bit divide, and a
  double square root with one exact correction step instead of the
  32-step recurrence (the bounds are proved in the source). A unit-norm
  contract beyond the reciprocal's bound (``int_bits + 2 * frac_bits >
  DIV_BITS``, e.g. Q4.27 or Q1.30) takes the kernel's wide instance,
  which divides each element exactly with one 64-bit integer divide.

Float steps of the encode are separate correctly rounded intrinsics, so
it is bit-identical to the plain version. ``ref.qboundary_model`` is the
kernel's arithmetic on the CPU.

The host side of a call is one ctypes call with six arguments: the
launch constants of each (contract, unit_norm) are built once and passed
by address, the C function is bound once, and the stream is PyTorch's
current raw stream of the tensor's device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.contracts import PrecisionContract
from repro_torch.core.fixedpoint import _f32_safe_bounds
from repro_torch.kernels import _build
from repro_torch.kernels.qboundary.ref import DIV_BITS, WIDE_BITS

PATHS = {0: "scalar loads", 1: "16-byte loads", 2: "looped two-pass"}


class QbParams(ctypes.Structure):
    """``struct QbParams`` of ``csrc/qboundary.cu``, field for field."""

    _fields_ = [("one", ctypes.c_float), ("lo", ctypes.c_float),
                ("hi", ctypes.c_float), ("frac_bits", ctypes.c_int),
                ("min_raw", ctypes.c_int64), ("max_raw", ctypes.c_int64),
                ("unit_norm", ctypes.c_int), ("per_thread", ctypes.c_int),
                ("wide", ctypes.c_int)]


_PARAMS: Dict[tuple, Tuple[QbParams, int]] = {}
_launch = None
_raw_stream = None


def params(contract: PrecisionContract, unit_norm: bool,
           per_thread: int = 0) -> Tuple[QbParams, int]:
    """The launch constants of ``contract`` (and their address), built once.
    ``per_thread`` forces the groups of four values each thread holds (0:
    the kernel's own choice)."""
    key = (contract, unit_norm, per_thread)
    hit = _PARAMS.get(key)
    if hit is None:
        bits = contract.int_bits + 2 * contract.frac_bits
        if unit_norm and bits > WIDE_BITS:
            raise ValueError(
                f"qboundary divides |raw << frac_bits| in 64 bits, so "
                f"int_bits + 2 * frac_bits <= {WIDE_BITS}; {contract.name} "
                f"has {bits}")
        lo, hi = _f32_safe_bounds(contract)
        p = QbParams(float(contract.one), lo, hi, contract.frac_bits,
                     contract.min_raw, contract.max_raw, int(unit_norm),
                     per_thread, int(unit_norm and bits > DIV_BITS))
        hit = _PARAMS[key] = (p, ctypes.addressof(p))
    return hit


def plan(x: torch.Tensor, out: torch.Tensor = None,
         p: QbParams = None) -> Tuple[str, int, int]:
    """(path, groups of four values per thread, threads per block) of a
    launch on ``x`` (``out`` None: a fresh, aligned allocation)."""
    if p is None:
        p = QbParams(per_thread=0)
    fn = _build.helper("qboundary", "qboundary_plan",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_void_p, ctypes.c_void_p])
    res = (ctypes.c_int * 3)()
    fn(x.data_ptr(), 0 if out is None else out.data_ptr(), x.shape[1],
       ctypes.addressof(p), res)
    return PATHS[res[0]], res[1], res[2]


def path(x: torch.Tensor) -> str:
    """The path the kernel takes on ``x``, with its launch shape."""
    name, per, threads = plan(x)
    if name == PATHS[2]:
        return f"{name}, {threads} threads per row"
    return f"{name}, {threads} threads x {per} group(s) of 4 per row"


def launch(x: torch.Tensor, out: torch.Tensor, contract: PrecisionContract,
           unit_norm: bool, per_thread: int = 0) -> None:
    """x float32 [n, d] and out int32 [n, d], both contiguous on one card."""
    global _launch, _raw_stream
    if _launch is None:
        _launch = _build.launcher("qboundary")
        _raw_stream = torch._C._cuda_getCurrentRawStream
    _, addr = params(contract, unit_norm, per_thread)
    n, d = x.shape
    err = _launch(x.data_ptr(), out.data_ptr(), n, d, addr,
                  _raw_stream(x.get_device()))
    if err:
        _build.check("qboundary", err)
