"""Feed-forward blocks: SwiGLU / GeGLU (gated) and the plain GELU MLP.

GELU is the tanh approximation, as ``jax.nn.gelu``'s default is."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.initializers import dense_init


class MLP(nn.Module):
    """``w_gate`` [d_model, d_ff] (gated forms only), ``w_up`` [d_model,
    d_ff], ``w_down`` [d_ff, d_model]: the reference's ``init_mlp``."""

    def __init__(self, generator: torch.Generator, d_model: int, d_ff: int,
                 activation: str, param_dtype: torch.dtype):
        super().__init__()
        if activation in ("swiglu", "geglu"):
            self.w_gate = nn.Parameter(
                dense_init(generator, (d_model, d_ff), param_dtype))
        self.w_up = nn.Parameter(
            dense_init(generator, (d_model, d_ff), param_dtype))
        self.w_down = nn.Parameter(
            dense_init(generator, (d_ff, d_model), param_dtype))


def mlp(params: MLP, x: torch.Tensor, activation: str) -> torch.Tensor:
    dtype = x.dtype
    if activation in ("swiglu", "geglu"):
        gate = x @ params.w_gate.to(dtype)
        up = x @ params.w_up.to(dtype)
        act = F.silu(gate) if activation == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        return (act * up) @ params.w_down.to(dtype)
    h = F.gelu(x @ params.w_up.to(dtype), approximate="tanh")
    return h @ params.w_down.to(dtype)
