"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.

48L d=1536 ssm_state=128 vocab=50280.  [arXiv:2405.21060]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,            # d_inner=3072, 48 ssm heads
    ssm_chunk=256,
    tie_embeddings=True,
)

DRAFT = ModelConfig(
    name="mamba2-780m-draft",
    family="ssm",
    num_layers=6,
    d_model=512,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=32,
    ssm_headdim=32,
    ssm_expand=2,
    tie_embeddings=True,
)
