"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (kv=32 ⇒ MHA) d_ff=13440
vocab=92416 — qwen1.5 arch (qkv bias, rope theta 1e6). [hf:Qwen/CodeQwen1.5-7B]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    attn_pattern="full",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
)

REDUCED = ModelConfig(
    name="codeqwen1.5-7b-reduced",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=8,
    d_ff=128,
    vocab_size=512,
    attn_pattern="full",
    qkv_bias=True,
    activation="swiglu",
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = False  # pure full attention → long_500k skipped
