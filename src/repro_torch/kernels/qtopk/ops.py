"""Wrapper of the qtopk kernel: dispatch, candidate merge, pad columns.

On a CUDA tensor the selection is the CUDA kernel (or raises): it leaves
the min(k, n) smallest pairs per row, sorted by the kernel itself up to
``kernel.SORT_MAX`` of them, else by one two-key sort after it, as the
reference merges outside its Pallas call. On a CPU tensor the whole
function is the plain blocked version. Both return the reference's width
(``ref.qtopk_width``), pad columns included.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import obs
from repro_torch.kernels.qtopk import kernel as _kernel
from repro_torch.kernels.qtopk import ref


def block_n(n: int) -> int:
    """The reference wrapper's column block: 1024, or the whole row when
    shorter (at least 128 wide once n reaches 128)."""
    return 1024 if n >= 1024 else max(128, n) if n >= 128 else n


def qtopk(scores: torch.Tensor, keys: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic k smallest (score, key) per row.

    scores [nq, n] int64, each < INT64_MAX; keys [n] int32 tie keys
    (unique). Returns (scores [nq, w] int64, keys int32), sorted, with
    w = ``ref.qtopk_width(n, k, block_n(n))``: the k smallest pairs where
    k <= n; else all n pairs, then w - n pad columns where w > n."""
    if k < 1:
        raise ValueError(f"qtopk needs k >= 1, got {k}")
    if scores.dim() != 2 or keys.dim() != 1 or keys.shape[0] != scores.shape[1]:
        raise ValueError(f"qtopk takes scores [nq, n] and keys [n], got "
                         f"{tuple(scores.shape)} and {tuple(keys.shape)}")
    nq, n = scores.shape
    bn = block_n(n)
    if scores.device.type != "cuda":
        return ref.qtopk_blocked(scores, keys, k, bn)
    if scores.dtype != torch.int64 or keys.dtype != torch.int32:
        raise TypeError(f"qtopk takes int64 scores and int32 keys, got "
                        f"{scores.dtype}, {keys.dtype}")
    if keys.device != scores.device:
        raise ValueError("qtopk inputs must be on one device")
    if not (scores.is_contiguous() and keys.is_contiguous()):
        raise ValueError("qtopk needs contiguous inputs")
    s, i, ordered = _kernel.select(scores, keys, k)
    if nq and n:  # an empty input launches nothing
        obs.count("launch.qtopk")
    if not ordered:
        s, i = ref.merge(s, i, min(k, n))
    return ref.pad_columns(s, i, keys, k, bn)
