"""The paper's own experimental pair (DeepSeek-R1-Distill-Qwen-7B target +
DeepSeek-R1-DRAFT-Qwen2.5-0.5B draft) — qwen2-7b architecture.

Used by the faithful-reproduction benchmarks (Tables 3/5/6, Figures 2/9-15).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paper-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=10_000.0,
    tie_embeddings=False,
)

DRAFT = ModelConfig(
    name="paper-7b-draft",      # qwen2.5-0.5B layout
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=152064,
    qkv_bias=True,
    tie_embeddings=True,
)
