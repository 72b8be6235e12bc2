"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) vocab=49155,
MoE 40 experts top-8, expert d_ff=512.

Note: the assignment line reads "MoE 40e top-8" with a bracketed hf pointer to
the 1b-a400m sibling (32e); we implement the listed 40e/top-8 spec (recorded
in DESIGN.md §Arch-applicability). [hf:ibm-granite]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    attn_pattern="full",
    rope_theta=10_000.0,
    activation="swiglu",
    tie_embeddings=True,
    num_experts=40,
    num_experts_per_tok=8,
    expert_d_ff=512,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=32,
    vocab_size=512,
    attn_pattern="full",
    activation="swiglu",
    tie_embeddings=True,
    num_experts=8,
    num_experts_per_tok=2,
    expert_d_ff=32,
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = False  # pure full attention → long_500k skipped
