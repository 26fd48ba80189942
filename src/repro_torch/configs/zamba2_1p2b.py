"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.

38L d=2048 32H (kv=32) shared-block ff=8192, ssm_state=64, vocab=32000.
[arXiv:2411.15242]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
    scan_layers=False,        # heterogeneous layer sequence
    tie_embeddings=True,
)

DRAFT = ModelConfig(
    name="zamba2-1.2b-draft",
    family="ssm",
    num_layers=4,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=32000,
    ssm_state=32,
    ssm_headdim=32,
    ssm_expand=2,
    tie_embeddings=True,
)
