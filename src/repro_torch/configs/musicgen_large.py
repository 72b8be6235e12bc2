"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32 ⇒ MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens.

Backbone only per assignment: the EnCodec frontend + codebook interleaving is
a STUB (input_specs() supplies frame embeddings); the decoder predicts one
codebook stream (vocab 2048). Deviations recorded in DESIGN.md: RoPE replaces
MusicGen's sinusoidal positions (TPU-idiomatic, no persistent buffers);
cross-attention text conditioning is out of backbone scope.
[arXiv:2306.05284; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    attn_pattern="full",
    rope_theta=10_000.0,
    activation="gelu_mlp",
    external_embeddings=True,
)

REDUCED = ModelConfig(
    name="musicgen-large-reduced",
    family="audio",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=8,
    d_ff=128,
    vocab_size=128,
    attn_pattern="full",
    activation="gelu_mlp",
    external_embeddings=True,
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = False  # pure full attention → long_500k skipped
