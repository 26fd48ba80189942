"""qwen3-14b [dense]: qk_norm, GQA kv=8. 40L d=5120 40H ff=17408 vocab=151936.
[hf:Qwen/Qwen3-8B family]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

DRAFT = ModelConfig(
    name="qwen3-14b-draft",
    family="dense",
    num_layers=4,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
