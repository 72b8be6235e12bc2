"""Launch of the hand-written qgemm CUDA kernel (``csrc/qgemm.cu``).

Replaces ``_qgemm_kernel`` / ``qgemm_planes_pallas`` of
``repro/kernels/qgemm/kernel.py`` (the Pallas TPU kernel). That kernel
splits each value into a signed high part and a low byte and accumulates
three int32 planes, exact for |raw| <= 2^16. This one keeps the idea of
limbs but cuts them for Hopper's int8 tensor cores, and is exact for
every int16 and int32 row (equal to the int64 product modulo 2^64, as the
reference's plain matmul), not only normalized ones.

What bounds it on the card: bytes. At nq = 64, nn = 131072, d = 2304 the
function must read 1.21 GB of int32 database and write 67 MB of int64
scores: 0.381 ms at 3.35 TB/s, against 0.176 ms for the 3.5e11 int8
operations of its nine limb products at the 1,979 TOP/s int8 rate.

What the design does about it (changed from the CUDA-core kernel of the
first port, which did 1.9e10 32x32->64-bit multiply-adds and was
issue-bound at 9x its bound):

* the database rows are the stream, read from device memory once, in
  depth stages of 64 values through a 3-deep cp.async ring in shared
  memory; each block owns 128 of them against 64 queries;
* the database rows are the wgmma A operand, taken from registers: each
  thread splits its own fragments (byte permutes, no shared-memory round
  trip of the limbs) and every fragment serves three products; the
  queries are the B operand (N = 64), split once per block and stage
  into swizzled planes. This choice, rather than queries as A from shared
  memory, is what the shared-memory bandwidth asks for: a first version
  with queries as A (N = 32 database rows a warpgroup, both operands'
  limbs in shared memory) moved 2.3x the shared-memory bytes per row and
  took 1.17 ms at the shape above on an H100 80GB HBM3 (700 W);
* three limbs (t s8, m and l u8; nine products into five s32 shift
  groups, exact for d <= 8192) hold every value in [-2^23, 2^23); a
  stage in which a warpgroup's rows or the queries hold a value beyond
  is summed on the CUDA cores with wrapping 64-bit multiply-adds into the
  output, decided per warpgroup and stage, so every int32 stays exact
  with no scan of the database;
* int64 rows (Q32.32) go to a CUDA-core kernel with wrapping 64-bit
  multiply-adds: the dispatch is by element type, not a fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

PATHS = {0: "plain loads", 1: "cp.async", 2: "cuda cores (int64)"}


def path(queries: torch.Tensor, database: torch.Tensor) -> str:
    """The load path the kernel takes for these operands (``PATHS``)."""
    fn = _build.helper("qgemm", "qgemm_path",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int])
    return PATHS[fn(queries.data_ptr(), database.data_ptr(),
                    queries.shape[1], queries.element_size())]


def launch(queries: torch.Tensor, database: torch.Tensor,
           out: torch.Tensor) -> None:
    """queries, database [nq, d], [nn, d] of one of int16, int32, int64;
    out int64 [nq, nn]."""
    nq, d = queries.shape
    nn = database.shape[0]
    fn = _build.launcher("qgemm")
    err = fn(queries.data_ptr(), database.data_ptr(), out.data_ptr(), nq, nn,
             d, queries.element_size(),
             torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check("qgemm", err)
