"""RMSNorm in gemma's (1 + w) form, computed in float32 and cast back."""
from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """Holds ``scale`` [d], stored zero-centred (zero init is the
    identity); the reference's ``init_rmsnorm``."""

    def __init__(self, d: int, param_dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=param_dtype,
                                              device=device))


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float, *,
            gemma_style: bool = True) -> torch.Tensor:
    """Computed in f32 for stability, cast back to the input dtype;
    ``gemma_style`` applies the scale as (1 + w)."""
    return rmsnorm_scale(params.scale, x, eps, gemma_style=gemma_style)


def rmsnorm_scale(scale: torch.Tensor, x: torch.Tensor, eps: float, *,
                  gemma_style: bool = True) -> torch.Tensor:
    """``rmsnorm`` over a bare ``scale`` tensor (the Mamba2 block's gated
    norm keeps its scale as one of the block's own parameters)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    w = 1.0 + w if gemma_style else w
    return (xf * w).to(dtype)
