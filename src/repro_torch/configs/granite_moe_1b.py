"""granite-moe-1b-a400m [moe]: 32 experts top-8. 24L d=1024 16H (kv=8)
ff=512/expert vocab=49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    mlp_type="swiglu",
    moe_num_experts=32,
    moe_top_k=8,
    tie_embeddings=True,
)

DRAFT = ModelConfig(
    name="granite-moe-1b-a400m-draft",
    family="dense",
    num_layers=2,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=49155,
    tie_embeddings=True,
)
