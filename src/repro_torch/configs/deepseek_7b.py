"""deepseek-7b [dense]: llama-arch. 30L d=4096 32H (kv=32) ff=11008 vocab=102400.
[arXiv:2401.02954]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)

DRAFT = ModelConfig(
    name="deepseek-7b-draft",
    family="dense",
    num_layers=4,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=2048,
    vocab_size=102400,
    tie_embeddings=True,
)
