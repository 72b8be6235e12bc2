"""Deterministic parameter initializers: truncated normal on [-2, 2] from an
explicit ``torch.Generator``, at the reference's scales.

The draws are the port's own and not bit-equal to ``jax.random``'s; a
model that must match the reference takes the reference's weights through
``models.convert``. A ``None`` generator builds on the ``meta`` device:
shapes and dtypes only, nothing allocated or drawn.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def device_of(generator: Optional[torch.Generator]) -> torch.device:
    """Where a parameter drawn from ``generator`` lives (``meta`` for
    None)."""
    return torch.device("meta") if generator is None else generator.device


def _truncated_normal(shape: Sequence[int],
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=device_of(generator))
    if generator is not None:
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return t


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               param_dtype: torch.dtype, *, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    """Truncated normal with 1/sqrt(fan_in) scale (fan_in = shape[-2] by
    default)."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = _truncated_normal(shape, generator)
    return t.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(param_dtype)


def embed_init(generator: Optional[torch.Generator], shape: Sequence[int],
               param_dtype: torch.dtype) -> torch.Tensor:
    return _truncated_normal(shape, generator).to(param_dtype)
