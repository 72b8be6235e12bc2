"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) vocab=32064,
MoE 16 experts top-2, expert d_ff=6400. [hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    attn_pattern="full",
    rope_theta=10_000.0,
    activation="swiglu",
    num_experts=16,
    num_experts_per_tok=2,
    expert_d_ff=6400,
)

REDUCED = ModelConfig(
    name="phi3.5-moe-reduced",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    attn_pattern="full",
    activation="swiglu",
    num_experts=4,
    num_experts_per_tok=2,
    expert_d_ff=64,
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = False  # pure full attention → long_500k skipped
