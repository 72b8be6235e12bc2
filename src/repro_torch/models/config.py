"""Model configuration schema (the port of ``repro.models.config``).

One dataclass for every family, field for field and property for property
with the reference, so a configuration reads the same in both packages.
``compute_dtype`` and ``params_dtype`` return torch dtypes. ``ShapeConfig``
and ``SHAPES`` are the reference's dry-run cells.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | moe | vlm | audio | hybrid

    # trunk
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 → d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # attention behaviour
    attn_pattern: str = "full"       # full | swa | local_global
    sliding_window: int = 4096       # window for swa / local layers
    attn_logit_softcap: float = 0.0  # 0 = off (gemma2: 50.0)
    final_logit_softcap: float = 0.0  # (gemma2: 30.0)
    qkv_bias: bool = False           # qwen-family
    query_scale_dim: int = 0         # 0 → head_dim (gemma2-2b: 256)
    rope_theta: float = 10_000.0
    rope_type: str = "rope"          # rope | mrope
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    # mlp
    activation: str = "swiglu"       # swiglu | geglu | gelu_mlp
    # norms
    rms_eps: float = 1e-6
    norm_style: str = "pre"          # pre | pre_post (gemma2 sandwich norms)

    # embeddings
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma2: embed * sqrt(d_model)
    external_embeddings: bool = False  # vlm/audio: inputs are embeddings

    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    expert_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2)
    hybrid_period: int = 6
    num_shared_blocks: int = 2

    # compute
    vocab_pad_multiple: int = 256    # padded logits are masked in _head
    dtype: str = "bfloat16"          # activations/compute
    param_dtype: str = "float32"     # master params
    remat: str = "block"             # none | block
    flash_q_chunk: int = 512
    flash_kv_chunk: int = 1024
    flash_threshold: int = 2048      # use flash attention for seq ≥ this
    attn_impl: str = "auto"          # auto | flash | naive | latency

    # --------------------------------------------------------------- #
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def padded_experts(self) -> int:
        e = self.num_experts
        if e == 0 or e <= 16 or e % 16 == 0:
            return e
        return ((e + 15) // 16) * 16

    @property
    def query_scale(self) -> float:
        d = self.query_scale_dim or self.head_dim_
        return d ** -0.5

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_is_local(self, layer_idx: int) -> bool:
        """local_global pattern: even layers local (sliding), odd global."""
        if self.attn_pattern == "swa":
            return True
        if self.attn_pattern == "local_global":
            return layer_idx % 2 == 0
        return False

    def param_count(self) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, Dh = self.num_heads, self.num_kv_heads, self.head_dim_
        n = V * D  # embedding
        if not self.tie_embeddings and not self.external_embeddings:
            n += V * D  # lm_head
        if self.family in ("dense", "vlm", "audio", "moe"):
            attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
            if self.qkv_bias:
                attn += (H + 2 * KV) * Dh
            if self.family == "moe":
                E, Fe = self.num_experts, self.expert_d_ff
                ff = D * E + E * (2 * D * Fe + Fe * D)
            else:
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                ff = mult * D * F
            norms = 2 * D if self.norm_style == "pre" else 4 * D
            n += L * (attn + ff + norms)
        elif self.family == "ssm":
            n += L * self._mamba_block_params()
        elif self.family == "hybrid":
            n += L * self._mamba_block_params()
            attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
            ff = 3 * D * F
            n += self.num_shared_blocks * (attn + ff + 2 * D)
        n += D  # final norm
        return n

    def _mamba_block_params(self) -> int:
        D, Din, N, G = (self.d_model, self.d_inner, self.ssm_state,
                        self.ssm_ngroups)
        H = self.ssm_nheads
        in_proj = D * (2 * Din + 2 * G * N + H)
        conv = self.ssm_conv * (Din + 2 * G * N)
        out = Din * D
        extras = 2 * H + Din
        return in_proj + conv + out + extras + D

    def active_param_count(self) -> int:
        """Active params per token (= dense count except MoE top-k subset)."""
        if self.family != "moe":
            return self.param_count()
        E, k = self.num_experts, self.num_experts_per_tok
        Fe, D, L = self.expert_d_ff, self.d_model, self.num_layers
        return self.param_count() - L * (E - k) * (2 * D * Fe + Fe * D)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run cell: an input shape and the step it runs."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}
