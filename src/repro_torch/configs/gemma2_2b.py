"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local+global alternating attention (window 4096), attn/final logit softcaps,
head_dim 256 (explicit: 8·256 ≠ d_model), query scale 1/sqrt(256), GeGLU,
sandwich (pre+post) norms, tied + scaled embeddings. [arXiv:2408.00118; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    attn_pattern="local_global",
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale_dim=256,
    rope_theta=10_000.0,
    activation="geglu",
    norm_style="pre_post",
    tie_embeddings=True,
    scale_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma2-2b-reduced",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    attn_pattern="local_global",
    sliding_window=16,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale_dim=16,
    activation="geglu",
    norm_style="pre_post",
    tie_embeddings=True,
    scale_embeddings=True,
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

# half the layers are 4k-windowed; global layers are O(S) per decoded token —
# long-context decode is tractable (see DESIGN.md §Arch-applicability)
LONG_CONTEXT_OK = True
