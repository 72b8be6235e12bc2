"""Decoder block: attention + FFN with pre or pre_post (gemma2 sandwich)
norms.

  pre      : h += f(norm(h))                       (llama family)
  pre_post : h += post_norm(f(pre_norm(h)))        (gemma2 sandwich)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.mlp import MLP, mlp
from repro_torch.models.layers.norms import RMSNorm, rmsnorm


class DecoderBlock(nn.Module):
    """``ln_attn``, ``ln_ffn``, ``attn``, ``mlp`` and, under pre_post,
    ``ln_attn_post`` and ``ln_ffn_post``: the reference's
    ``init_decoder_block``."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.family} blocks are not ported (ROADMAP.md Queue 1)")
        dev, pd = generator.device, cfg.params_dtype
        self.ln_attn = RMSNorm(cfg.d_model, pd, dev)
        self.ln_ffn = RMSNorm(cfg.d_model, pd, dev)
        self.attn = attn_lib.Attention(generator, cfg)
        self.mlp = MLP(generator, cfg.d_model, cfg.d_ff, cfg.activation, pd)
        if cfg.norm_style == "pre_post":
            self.ln_attn_post = RMSNorm(cfg.d_model, pd, dev)
            self.ln_ffn_post = RMSNorm(cfg.d_model, pd, dev)


def decoder_block(params: DecoderBlock, h: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, *, local: bool,
                  mode: str, cache_slice: Optional[attn_lib.Cache] = None
                  ) -> Tuple[torch.Tensor, Optional[attn_lib.Cache]]:
    """Returns (h, the layer's cache after this call)."""
    a_in = rmsnorm(params.ln_attn, h, cfg.rms_eps)
    a_out, new_cache = attn_lib.attention(
        params.attn, a_in, positions, cfg, local=local, mode=mode,
        cache_slice=cache_slice)
    if cfg.norm_style == "pre_post":
        a_out = rmsnorm(params.ln_attn_post, a_out, cfg.rms_eps)
    h = h + a_out

    f_in = rmsnorm(params.ln_ffn, h, cfg.rms_eps)
    f_out = mlp(params.mlp, f_in, cfg.activation)
    if cfg.norm_style == "pre_post":
        f_out = rmsnorm(params.ln_ffn_post, f_out, cfg.rms_eps)
    return h + f_out, new_cache
