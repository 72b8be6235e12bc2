"""Launch of the hand-written qcoarse CUDA kernel (``csrc/qcoarse.cu``).

Replaces ``_qcoarse_kernel`` / ``qcoarse_planes_pallas`` of
``repro/kernels/qcoarse/kernel.py`` (the Pallas TPU kernel), together with
the int64 combine of ``repro/kernels/qcoarse/ops.py``: the TPU kernel
writes four int32 limb planes [nq, nn, 4] and XLA combines them outside;
this kernel keeps the same four int32 planes in registers and writes the
combined int64 scores, so the planes never reach device memory
(``ops.qcoarse_planes`` keeps them as a plain function for the parity
tests).

What bounds it on the card: bytes, by the count of the work. At the main
path's shape (64 queries x 131072 code rows x d = 2304) the function must
read 302.0 MB of int8 codes and 0.6 MB of weights and write 67.1 MB of
int64 scores: 369.7 MB, 0.110 ms at 3.35 TB/s, against 0.020 ms for its
1.9e10 multiply-adds at the int8 tensor-core rate.

What the design does about it: the codes stream as int8, read four at a
time as 32-bit words (a quarter of the int32 arena's bytes, the point of
the tier), each code word read once per block of 64 queries and used by
64 queries from shared memory. The weights are split into limbs once, by
a small first kernel, so that the main loop is all ``dp4a``: four
multiply-adds per instruction, int32 planes exact by the reference's range
analysis (255 * 127 * 8192 < 2^31). It runs on the CUDA cores, so the
``dp4a`` issue rate, not the bytes, sets its time today. The int8
tensor-core path (``mma.sync`` / ``wgmma`` with u8 x s8 operands) and TMA
loads are later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def launch(weights: torch.Tensor, codes: torch.Tensor, limbs: torch.Tensor,
           out: torch.Tensor) -> None:
    """weights int32 [nq, d], codes int8 [nn, d], limbs int32 scratch
    [nq, ceil(d / 4), 4], out int64 [nq, nn]."""
    nq, d = weights.shape
    nn = codes.shape[0]
    fn = _build.launcher("qcoarse")
    err = fn(weights.data_ptr(), codes.data_ptr(), limbs.data_ptr(),
             out.data_ptr(), nq, nn, d,
             torch.cuda.current_stream(weights.device).cuda_stream)
    _build.check("qcoarse", err)
