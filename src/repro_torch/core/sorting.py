"""Two-key lexicographic sort: the port's ``jax.lax.sort(num_keys=2)``.

Distances reach 2^62, so (distance, slot) cannot be packed into one int64
key. A stable sort on the secondary key followed by a stable sort on the
primary key orders by (primary, secondary); payload arrays follow the same
permutation. Where both keys tie, payloads keep their input order (the
reference's sort is unstable there, but every caller's payloads are equal
on such ties, so the result is the same).
"""
from __future__ import annotations

from typing import Tuple

import torch


def sort2(k1: torch.Tensor, k2: torch.Tensor, *payload: torch.Tensor,
          dim: int = -1) -> Tuple[torch.Tensor, ...]:
    """Sort along ``dim`` by (k1, k2); returns (k1, k2, *payload) sorted."""
    _, idx = torch.sort(k2, dim=dim, stable=True)
    _, idx2 = torch.sort(torch.gather(k1, dim, idx), dim=dim, stable=True)
    perm = torch.gather(idx, dim, idx2)
    return tuple(torch.gather(t, dim, perm) for t in (k1, k2, *payload))
