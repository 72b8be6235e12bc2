"""Plain PyTorch versions of qtopk.

``qtopk_sorted`` is the definition: the k smallest (score, key) pairs per
row by a full two-key sort. ``qtopk_blocked`` is the function the kernel
computes, step for step: columns cut into blocks of ``bn`` (the last one
padded with (INT64_MAX, INT32_MAX) lanes), ``kk`` selection passes per
block, each retiring the lanes that carry the (score, key) minimum, then
one two-key sort over the candidates. The two agree whenever the keys are
unique and k <= n; the blocked form also reproduces the reference
kernel's output where they do not.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sorting import sort2

I64_MAX = (1 << 63) - 1
I32_MAX = (1 << 31) - 1


def qtopk_sorted(scores: torch.Tensor, keys: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    nq, n = scores.shape
    keys_b = keys.to(torch.int32)[None, :].expand(nq, n)
    s, i = sort2(scores, keys_b)
    return s[:, :k], i[:, :k]


def block_candidates(scores: torch.Tensor, keys: torch.Tensor, bn: int,
                     kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block candidates [nq, n_blocks * kk] (score int64, key int32)."""
    nq, n = scores.shape
    nb = -(-n // bn)
    pad = nb * bn - n
    dev = scores.device
    s = torch.cat([scores.to(torch.int64),
                   torch.full((nq, pad), I64_MAX, dtype=torch.int64, device=dev)],
                  dim=1).view(nq, nb, bn)
    kb = torch.cat([keys.to(torch.int32),
                    torch.full((pad,), I32_MAX, dtype=torch.int32, device=dev)]
                   ).view(1, nb, bn).expand(nq, nb, bn)
    out_s = torch.empty((nq, nb, kk), dtype=torch.int64, device=dev)
    out_k = torch.empty((nq, nb, kk), dtype=torch.int32, device=dev)
    for t in range(kk):
        ms = s.min(dim=-1).values
        km = torch.where(s == ms[..., None], kb, I32_MAX)
        mk = km.min(dim=-1).values
        out_s[..., t] = ms
        out_k[..., t] = mk
        s = torch.where(km == mk[..., None], I64_MAX, s)
    return out_s.view(nq, nb * kk), out_k.view(nq, nb * kk)


def merge(cand_s: torch.Tensor, cand_k: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final (score, key) two-key sort over the block candidates."""
    s, i = sort2(cand_s, cand_k)
    return s[:, :k], i[:, :k]


def qtopk_blocked(scores: torch.Tensor, keys: torch.Tensor, k: int, bn: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    cand_s, cand_k = block_candidates(scores, keys, bn, min(k, bn))
    return merge(cand_s, cand_k, k)
