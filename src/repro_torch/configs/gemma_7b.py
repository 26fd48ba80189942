"""gemma-7b [dense]: GeGLU, head_dim=256. 28L d=3072 16H (kv=16) ff=24576
vocab=256000.  [arXiv:2403.08295]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    mlp_type="geglu",
    rmsnorm_offset=True,     # gemma's (1 + w) RMSNorm
    embed_scale=True,        # embeddings scaled by sqrt(d_model)
    tie_embeddings=True,
)

DRAFT = ModelConfig(
    name="gemma-7b-draft",
    family="dense",
    num_layers=4,
    d_model=768,
    num_heads=4,
    num_kv_heads=1,          # MQA draft (gemma-2b style)
    head_dim=256,
    d_ff=2048,
    vocab_size=256_000,
    mlp_type="geglu",
    rmsnorm_offset=True,
    embed_scale=True,
    tie_embeddings=True,
)
