"""mellum2-12b-a2.5b [moe, window and full layers]: 28L d=2304 32H (kv=4,
hd 128); layers three sliding (window 1,024) then one full, seven times;
yarn (factor 16 over 8,192 positions) on the full layers' rope, plain rope
on the sliding ones, both theta 500,000; every MLP 64 experts top-8 of
width 896, renormalised gates, no shared expert; vocab 98,304, untied.
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct]

A port-only architecture: the reference has no window and no yarn, so the
config is a :class:`~.base.WindowedConfig`, kept out of the registry's
``_MODULES`` (whose names the parity tests look up in the reference).  The
benchmark builds the same config from its file (``bench_port/archs/
swa_moe.py``).  The draft is the repository's 2-layer dense one at the
target's vocabulary: none is published.
"""
from .base import FULL, SLIDING, ModelConfig, WindowedConfig

LAYER_TYPES = (SLIDING, SLIDING, SLIDING, FULL) * 7

CONFIG = WindowedConfig(
    name="mellum2-12b-a2.5b",
    family="moe",
    num_layers=28,
    d_model=2304,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=896,
    vocab_size=98304,
    rope_theta=500_000.0,
    max_position_embeddings=131_072,
    mlp_type="swiglu",
    moe_num_experts=64,
    moe_top_k=8,
    tie_embeddings=False,
    layer_types=LAYER_TYPES,
    sliding_window=1024,
    yarn_factor=16.0,
    yarn_original_max=8192,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_attention_factor=1.2772588722239782,
)

DRAFT = ModelConfig(
    name="mellum2-12b-a2.5b-draft",
    family="dense",
    num_layers=2,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=98304,
    tie_embeddings=True,
)


def reduced(cfg: WindowedConfig = CONFIG, *, window: int = 8
            ) -> WindowedConfig:
    """The CPU tests' size: one period of the 3 : 1 pattern (four layers),
    d 128, 4 / 2 heads of 32, 8 experts top-2 of width 64 at capacity
    factor 8 (no drops at this scale), a vocabulary of 256, float32, and a
    window of ``window`` positions, shorter than the tests' contexts; the
    yarn parameters as published."""
    return cfg.replace(num_layers=4, d_model=128, num_heads=4,
                       num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=256,
                       max_position_embeddings=512, moe_num_experts=8,
                       moe_top_k=2, moe_capacity_factor=8.0,
                       layer_types=(SLIDING, SLIDING, SLIDING, FULL),
                       sliding_window=window, dtype="float32")
