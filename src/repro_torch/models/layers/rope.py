"""Rotary position embeddings: standard RoPE (rotate-half) and Qwen2-VL's
M-RoPE, tables in float32 computed on the fly from integer positions."""
from __future__ import annotations

from typing import Sequence

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


def mrope_angles(positions_3d: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. positions_3d [3, B, L] (temporal,
    height, width) int → angles [B, L, head_dim/2] f32: the head_dim/2
    frequency slots are split into ``sections`` (e.g. 16/24/24) and each
    section takes its angle from its own positional stream. With three
    equal streams (text) it is standard RoPE exactly."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {head_dim // 2}")
    freqs = _freqs(head_dim, theta, positions_3d.device)
    ang = positions_3d.to(torch.float32)[..., None] * freqs  # [3, B, L, d2]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, ..., start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def text_positions_3d(positions: torch.Tensor) -> torch.Tensor:
    """Lift text positions [B, L] → [3, B, L] (all streams equal)."""
    return positions[None].expand((3,) + tuple(positions.shape))
