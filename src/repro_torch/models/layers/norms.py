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
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = params.scale.to(torch.float32)
    w = 1.0 + w if gemma_style else w
    return (xf * w).to(dtype)
