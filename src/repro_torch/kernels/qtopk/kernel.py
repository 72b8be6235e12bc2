"""Launch of the hand-written qtopk CUDA kernel (``csrc/qtopk.cu``).

Replaces ``_qtopk_kernel`` / ``qtopk_pallas`` of
``repro/kernels/qtopk/kernel.py`` (the Pallas TPU kernel). The TPU kernel
carries each int64 score as a hi plane and a sign-biased lo plane because
the TPU has no int64; Hopper compares int64 natively, so this kernel reads
the scores as they are and the plane split is gone.

What bounds it on the card: bytes. Each score is read once (8 bytes) and
each candidate written once; at nq = 64, n = 131072 that is 67 MB, about
20 us at 3.35 TB/s. The kk passes of block-wide reductions (two
``__syncthreads`` each) add latency that the bytes do not pay for, which
is why the block holds its lanes in registers and not in shared memory.

What the design does about it: one block per (column block, query row)
gives nq * n_blocks blocks, enough to fill 132 SMs at the main path's
shapes; each score is loaded once, and only kk candidates per block leave
the chip's registers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def launch(scores: torch.Tensor, keys: torch.Tensor, cand_s: torch.Tensor,
           cand_k: torch.Tensor, bn: int, kk: int) -> None:
    """scores int64 [nq, n], keys int32 [n]; cand_s int64 and cand_k int32
    [nq, n_blocks * kk]."""
    nq, n = scores.shape
    fn = _build.launcher("qtopk")
    err = fn(scores.data_ptr(), keys.data_ptr(), cand_s.data_ptr(),
             cand_k.data_ptr(), nq, n, bn, kk,
             torch.cuda.current_stream(scores.device).cuda_stream)
    _build.check("qtopk", err)
