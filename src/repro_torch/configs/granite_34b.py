"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1 ⇒ MQA) d_ff=24576
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    attn_pattern="full",
    rope_theta=10_000.0,
    activation="swiglu",
)

REDUCED = ModelConfig(
    name="granite-34b-reduced",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    attn_pattern="full",
    activation="swiglu",
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = False  # pure full attention → long_500k skipped
