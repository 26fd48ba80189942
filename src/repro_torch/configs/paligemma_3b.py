"""paligemma-3b [vlm]: SigLIP (stubbed) + gemma backbone.

18L d=2048 8H (kv=1 MQA) ff=16384 vocab=257216; 256 bidirectional image
prefix tokens supplied as precomputed patch embeddings.  [arXiv:2407.07726]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="geglu",
    rmsnorm_offset=True,
    embed_scale=True,
    num_image_tokens=256,
    tie_embeddings=True,
)

DRAFT = ModelConfig(
    name="paligemma-3b-draft",
    family="dense",
    num_layers=4,
    d_model=768,
    num_heads=4,
    num_kv_heads=1,
    head_dim=128,
    d_ff=2048,
    vocab_size=257216,
    mlp_type="geglu",
    rmsnorm_offset=True,
    embed_scale=True,
    tie_embeddings=True,
)
