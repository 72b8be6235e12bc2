"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention. [arXiv:2401.16818; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attn_pattern="swa",
    sliding_window=4096,
    rope_theta=10_000.0,
    activation="swiglu",
)

REDUCED = ModelConfig(
    name="h2o-danube-1.8b-reduced",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    attn_pattern="swa",
    sliding_window=16,
    activation="swiglu",
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = True  # SWA ⇒ KV cache bounded by window
