"""grok-1-314b [moe]: 8 experts top-2. 64L d=6144 48H (kv=8) ff=32768
vocab=131072.  [hf:xai-org/grok-1]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    mlp_type="swiglu",
    moe_num_experts=8,
    moe_top_k=2,
    logit_softcap=30.0,
    tie_embeddings=True,
)

DRAFT = ModelConfig(
    name="grok-1-314b-draft",
    family="dense",
    num_layers=6,
    d_model=1536,
    num_heads=12,
    num_kv_heads=4,
    head_dim=128,
    d_ff=4096,
    vocab_size=131072,
    tie_embeddings=True,
)
