"""whisper-medium [audio]: enc-dec, conv frontend stubbed.

24L (24 enc + 24 dec), d_model=1024, 16H MHA, d_ff=4096, vocab=51865.
[arXiv:2212.04356]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=48,            # informational: 24 enc + 24 dec below
    enc_layers=24,
    dec_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_embedding="learned",
    max_position_embeddings=65536,
    enc_context=1500,         # 30s audio window for decode-shape cross-KV
    tie_embeddings=True,
)

# shallow decoder-only draft over the same vocabulary (text-side speculation)
DRAFT = ModelConfig(
    name="whisper-medium-draft",
    family="dense",
    num_layers=4,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm_type="rmsnorm",
    tie_embeddings=True,
)
