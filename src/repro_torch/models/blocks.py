"""Decoder blocks: attention + FFN (a dense MLP, or the MoE layer under the
moe family), and the Mamba2 layer of the ssm and hybrid families.

Norm styles of the decoder block:

  pre      : h += f(norm(h))                       (llama family)
  pre_post : h += post_norm(f(pre_norm(h)))        (gemma2 sandwich)

The hybrid family's shared attention blocks are decoder blocks with the
dense MLP at ``d_ff``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models import collectives, pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.initializers import device_of
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import ssm as ssm_lib
from repro_torch.models.layers.mlp import MLP, mlp
from repro_torch.models.layers.norms import RMSNorm, rmsnorm


class DecoderBlock(nn.Module):
    """``ln_attn``, ``ln_ffn``, ``attn``, ``moe`` (moe family) or ``mlp``
    and, under pre_post, ``ln_attn_post`` and ``ln_ffn_post``: the
    reference's ``init_decoder_block``."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dev, pd = device_of(generator), cfg.params_dtype
        self.ln_attn = RMSNorm(cfg.d_model, pd, dev)
        self.ln_ffn = RMSNorm(cfg.d_model, pd, dev)
        self.attn = attn_lib.Attention(generator, cfg)
        if cfg.family == "moe":
            self.moe = moe_lib.MoE(generator, cfg)
        else:
            self.mlp = MLP(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                           pd)
        if cfg.norm_style == "pre_post":
            self.ln_attn_post = RMSNorm(cfg.d_model, pd, dev)
            self.ln_ffn_post = RMSNorm(cfg.d_model, pd, dev)


def decoder_block(params: DecoderBlock, h: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, *, local: bool,
                  mode: str, cache_slice: Optional[attn_lib.Cache] = None,
                  angles: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[attn_lib.Cache],
                             torch.Tensor]:
    """Returns (h, the layer's cache after this call, the MoE balance loss:
    float32 zero outside the moe family). ``angles`` are M-RoPE's, or None
    for text RoPE. Under a mesh whose ``model`` axis divides ``d_ff`` the
    dense MLP is column- then row-parallel: one sum over ``model``."""
    a_in = rmsnorm(params.ln_attn, h, cfg.rms_eps)
    a_out, new_cache = attn_lib.attention(
        params.attn, a_in, positions, cfg, local=local, mode=mode,
        cache_slice=cache_slice, angles=angles)
    if cfg.norm_style == "pre_post":
        a_out = rmsnorm(params.ln_attn_post, a_out, cfg.rms_eps)
    h = h + a_out

    f_in = rmsnorm(params.ln_ffn, h, cfg.rms_eps)
    if cfg.family == "moe":
        f_out, aux = moe_lib.moe_ffn(params.moe, f_in, cfg)
    else:
        f_out = mlp(params.mlp, f_in, cfg.activation)
        if pspec.model_divides(cfg.d_ff):
            f_out = collectives.psum(f_out, "model")
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.norm_style == "pre_post":
        f_out = rmsnorm(params.ln_ffn_post, f_out, cfg.rms_eps)
    return h + f_out, new_cache, aux


class MambaLayer(nn.Module):
    """``ln`` and ``mamba``: the reference's ``init_mamba_layer``."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.params_dtype,
                         device_of(generator))
        self.mamba = ssm_lib.Mamba(generator, cfg)


def mamba_layer(params: MambaLayer, h: torch.Tensor, cfg: ModelConfig, *,
                mode: str, cache_slice: Optional[ssm_lib.SSMCache] = None
                ) -> Tuple[torch.Tensor, Optional[ssm_lib.SSMCache]]:
    """h += mamba(norm(h)); returns (h, the layer's cache after this call)."""
    m_out, new_cache = ssm_lib.mamba_block(
        params.mamba, rmsnorm(params.ln, h, cfg.rms_eps), cfg, mode=mode,
        cache_slice=cache_slice)
    return h + m_out, new_cache
