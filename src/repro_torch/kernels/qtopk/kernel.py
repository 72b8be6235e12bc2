"""Launch of the hand-written qtopk CUDA kernel (``csrc/qtopk.cu``).

Replaces ``_qtopk_kernel`` / ``qtopk_pallas`` of
``repro/kernels/qtopk/kernel.py`` (the Pallas TPU kernel). The TPU kernel
carries each int64 score as a hi plane and a sign-biased lo plane because
the TPU has no int64, and selects by k passes of a block-wide minimum
because it has no cross-lane sort; Hopper compares 64-bit keys natively and
has shared-memory atomics and block scans, so this kernel selects by radix
on a 96-bit (score, key) composite in a number of passes set by the bits
of the data, whatever k is.

What bounds it on the card: bytes. Each score is read once (8 bytes) and
each selected pair written once; at nq = 64, n = 131072 that is 67 MB,
about 20 us at 3.35 TB/s. The digit passes add block barriers (two per
digit) that the bytes do not pay for.

What the design does about it: phase 1 gives each (4096-column tile, row)
one 256-thread block that holds its pairs in registers, so the scores
cross from memory once and every digit pass runs on registers and shared
memory; at [64, 131072] that is 2048 blocks over 132 SMs. Only min(k, 4096)
pairs per tile leave the chip. Phase 2 is one 1024-thread block per row
over the row's tile candidates (8192 at k = 256, in registers): a
histogram shared across blocks would need a grid-wide barrier per digit,
and the candidates fit one block. It sorts its <= 2048 selected pairs in
shared memory, so at the main path's k no sort kernel follows. Where a row
is one tile, or k >= 4096 (the coverage read), one pass of the row kernel
does the whole selection, streaming the row from L2 / HBM once per digit,
and the caller's two-key sort orders what it selected.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qtopk import ref

TILE = ref.TILE  # phase-1 columns per block (csrc: 256 threads x 16 keys)
SORT_MAX = 2048  # selections the row kernel sorts itself (csrc: kSortMax)


def _launch(scores, keys, s_stride, k_stride, nq, length, seg, k, out_s,
            out_k, out_stride, out_seg_stride, tile: bool, sort: bool) -> None:
    fn = _build.launcher("qtopk")
    err = fn(scores.data_ptr(), keys.data_ptr(), s_stride, k_stride, nq,
             length, seg, k, out_s.data_ptr(), out_k.data_ptr(), out_stride,
             out_seg_stride, int(tile), int(sort),
             torch.cuda.current_stream(scores.device).cuda_stream)
    _build.check("qtopk", err)


def select(scores: torch.Tensor, keys: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """The min(k, n) smallest (score, key) pairs of each row: scores int64
    [nq, n], keys int32 [n] (unique) -> (int64, int32 [nq, min(k, n)],
    ordered). The pairs are in (score, key) order when ``ordered`` (at
    most ``SORT_MAX`` of them), else unordered. One launch, or two (tiles,
    then each row's candidates) as ``ref.select_plan`` says."""
    nq, n = scores.shape
    m = min(k, n)
    sort = m <= SORT_MAX
    dev = scores.device
    out_s = torch.empty((nq, m), dtype=torch.int64, device=dev)
    out_k = torch.empty((nq, m), dtype=torch.int32, device=dev)
    plan = ref.select_plan(n, k, TILE)
    if plan is None:
        _launch(scores, keys, n, 0, nq, n, n, m, out_s, out_k, m, 0, False,
                sort)
        return out_s, out_k, sort
    _, c = plan
    cand_s = torch.empty((nq, c), dtype=torch.int64, device=dev)
    cand_k = torch.empty((nq, c), dtype=torch.int32, device=dev)
    _launch(scores, keys, n, 0, nq, n, TILE, k, cand_s, cand_k, c, k, True,
            False)
    _launch(cand_s, cand_k, c, c, nq, c, c, k, out_s, out_k, k, 0, False,
            sort)
    return out_s, out_k, sort
