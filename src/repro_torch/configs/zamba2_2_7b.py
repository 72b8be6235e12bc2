"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d_model=2560 ssm_state=64
vocab=32000 + 2 alternating shared attention blocks (32H kv=32, d_ff=10240)
hit every 6 mamba layers. [arXiv:2411.15242; hf]

Deviation recorded in DESIGN.md: the shared block consumes the hidden stream
directly (Zamba2 concatenates the original embedding and LoRA-specializes
each invocation; both are orthogonal to the memory-substrate study here).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    hybrid_period=6,
    num_shared_blocks=2,
    rope_theta=10_000.0,
    activation="swiglu",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
    hybrid_period=2,
    num_shared_blocks=2,
    activation="swiglu",
    tie_embeddings=True,
    flash_threshold=64,
    flash_q_chunk=16,
    flash_kv_chunk=16,
)

LONG_CONTEXT_OK = True  # O(1) mamba state + 9 shared-attn caches
