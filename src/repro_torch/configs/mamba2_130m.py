"""mamba2-130m [ssm] — 24L d_model=768, attention-free SSD, ssm_state=128,
vocab=50280, expand 2 (d_inner 1536), headdim 64 (24 heads), 1 group, conv 4.
[arXiv:2405.21060]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    num_layers=4,
    d_model=64,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
)

LONG_CONTEXT_OK = True  # O(1) decode state — long_500k is the showcase cell
