"""Launch of the hand-written qgemm CUDA kernel (``csrc/qgemm.cu``).

Replaces ``_qgemm_kernel`` / ``qgemm_planes_pallas`` of
``repro/kernels/qgemm/kernel.py`` (the Pallas TPU kernel). The TPU has no
int64, so that kernel splits each value into 8-bit limbs and accumulates
three int32 planes; Hopper multiplies 32x32 -> 64 bits natively, so this
kernel accumulates the int64 dot product directly and the planes are gone
(``ops.qgemm_planes`` keeps them as a plain function for the parity tests).

What bounds it on the card: integer operations. Every multiply-add is a
32x32 -> 64-bit multiply plus a 64-bit add on the CUDA cores; at
nq = 64, nn = 131072, d = 2304 that is 1.9e10 multiply-adds against
1.2 GB of int32 database, so the arithmetic, not the 3.35 TB/s of
memory, sets the floor.

What the design does about it now: a simple shared-memory tiled kernel
(64 x 64 output tile per block, depth steps of 32, 4 x 4 int64 register
accumulators per thread) so that each database element read from device
memory serves 64 queries. Making it fast is later work: re-split the
limbs onto the s8/u8 tensor-core path (``wgmma``) with TMA loads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def launch(queries: torch.Tensor, database: torch.Tensor,
           out: torch.Tensor) -> None:
    """queries int32 [nq, d], database int32 [nn, d], out int64 [nq, nn]."""
    nq, d = queries.shape
    nn = database.shape[0]
    fn = _build.launcher("qgemm")
    err = fn(queries.data_ptr(), database.data_ptr(), out.data_ptr(), nq, nn,
             d, torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check("qgemm", err)
