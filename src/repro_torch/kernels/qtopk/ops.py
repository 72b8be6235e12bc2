"""Wrapper of the qtopk kernel: blocking, dispatch, candidate merge.

On a CUDA tensor the per-block selection is the CUDA kernel (or raises);
on a CPU tensor it is the plain blocked version. Either way the
``n_blocks * kk`` candidates then merge in one two-key sort, as the
reference merges outside its Pallas call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.qtopk import kernel as _kernel
from repro_torch.kernels.qtopk import ref

LAUNCHES = 0  # kernel launches since the last reset


def block_n(n: int) -> int:
    """The reference wrapper's column block: 1024, or the whole row when
    shorter (at least 128 wide once n reaches 128)."""
    return 1024 if n >= 1024 else max(128, n) if n >= 128 else n


def qtopk(scores: torch.Tensor, keys: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic k smallest (score, key) per row.

    scores [nq, n] int64; keys [n] int32 tie keys (unique).
    Returns (scores [nq, min(k, ...)] int64, keys int32), sorted."""
    global LAUNCHES
    if k < 1:
        raise ValueError(f"qtopk needs k >= 1, got {k}")
    if scores.dim() != 2 or keys.dim() != 1 or keys.shape[0] != scores.shape[1]:
        raise ValueError(f"qtopk takes scores [nq, n] and keys [n], got "
                         f"{tuple(scores.shape)} and {tuple(keys.shape)}")
    nq, n = scores.shape
    bn = block_n(n)
    kk = min(k, bn)
    if scores.device.type != "cuda":
        return ref.qtopk_blocked(scores, keys, k, bn)
    if scores.dtype != torch.int64 or keys.dtype != torch.int32:
        raise TypeError(f"qtopk takes int64 scores and int32 keys, got "
                        f"{scores.dtype}, {keys.dtype}")
    if keys.device != scores.device:
        raise ValueError("qtopk inputs must be on one device")
    if not (scores.is_contiguous() and keys.is_contiguous()):
        raise ValueError("qtopk needs contiguous inputs")
    nb = -(-n // bn) if n else 0
    cand_s = torch.empty((nq, nb * kk), dtype=torch.int64, device=scores.device)
    cand_k = torch.empty((nq, nb * kk), dtype=torch.int32, device=scores.device)
    _kernel.launch(scores, keys, cand_s, cand_k, bn, kk)
    LAUNCHES += 1
    return ref.merge(cand_s, cand_k, k)
