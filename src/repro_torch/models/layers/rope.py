"""Rotary position embeddings (rotate-half), tables in float32 computed on
the fly from integer positions. M-RoPE comes with the VLM family."""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> torch.Tensor:
    """positions [...] int → angles [..., head_dim/2] f32."""
    return (positions.to(torch.float32)[..., None]
            * _freqs(head_dim, theta, positions.device))


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., n_heads, head_dim], angles [..., head_dim/2] (broadcast over
    heads). Pairs are (x[..:d/2], x[..d/2:])."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    cos = torch.cos(angles)[..., None, :]  # add the head axis
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)
