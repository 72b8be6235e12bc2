"""Plain PyTorch version of qboundary: encode then integer qnorm."""
from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fp
from repro_torch.core.contracts import PrecisionContract


def qboundary_ref(x: torch.Tensor, contract: PrecisionContract,
                  unit_norm: bool = True) -> torch.Tensor:
    raw = fp.encode(x, contract)
    if unit_norm:
        raw = fp.qnorm(raw, axis=-1, contract=contract)
    return raw
