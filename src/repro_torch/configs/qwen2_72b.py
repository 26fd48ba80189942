"""qwen2-72b [dense]: GQA kv=8, QKV bias. 80L d=8192 64H ff=29568 vocab=152064.
[arXiv:2407.10671]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

DRAFT = ModelConfig(
    name="qwen2-72b-draft",
    family="dense",
    num_layers=6,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=2816,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
