"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (sections 16/24/24), dynamic resolution.
Vision frontend is a STUB per assignment: input_specs() supplies precomputed
patch embeddings; the backbone is exercised end to end. [arXiv:2409.12191; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    attn_pattern="full",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    activation="swiglu",
    external_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen2-vl-7b-reduced",
    family="vlm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    attn_pattern="full",
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(4, 2, 2),
    activation="swiglu",
    external_embeddings=True,
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = False  # pure full attention → long_500k skipped
