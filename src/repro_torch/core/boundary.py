"""The determinism boundary (paper §5, §5.3).

Every float tensor entering the memory substrate passes through
``normalize_embedding`` exactly once, after which all state is integer:
float vector → Q-encode (saturating, round half away from zero) → optional
exact integer L2 normalization.

On the card the boundary *is* the qboundary kernel: a CUDA tensor under a
contract with int32 storage goes through the hand-written fused kernel,
which is bit-identical to ``fixedpoint.encode`` + ``fixedpoint.qnorm``.
Every other contract, and every CPU tensor, takes that plain composition
(the reference wrapper's rule). In the JAX package the engine reaches the
boundary through ``encode``/``qnorm`` and never calls its kernel; here the
kernel is the path.
"""
from __future__ import annotations

import torch

from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract
from repro_torch.kernels.qboundary import ops as qboundary_ops


def normalize_embedding(x, contract: PrecisionContract = DEFAULT_CONTRACT,
                        unit_norm: bool = True) -> torch.Tensor:
    """Float embedding(s) [..., dim] → deterministic raw fixed-point vectors."""
    x = torch.as_tensor(x).to(torch.float32)
    lead, dim = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, dim).contiguous()
    raw = qboundary_ops.qboundary(flat, contract, unit_norm=unit_norm)
    return raw.reshape(*lead, dim)


def admit_query(q, contract: PrecisionContract = DEFAULT_CONTRACT,
                unit_norm: bool = True) -> torch.Tensor:
    """Queries cross the same boundary as stored vectors."""
    return normalize_embedding(q, contract, unit_norm)
