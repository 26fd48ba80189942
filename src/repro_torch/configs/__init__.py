"""Config registry of the port: the dense architectures it serves, their draft
pairings, and reduced configs for CPU tests.

Data only — a copy of the reference registry, limited to the dense family
that the paged decoder covers.
"""
from __future__ import annotations

from .base import ModelConfig
from . import deepseek_7b, paper_7b, qwen3_14b

_MODULES = {
    "deepseek-7b": deepseek_7b,
    "qwen3-14b": qwen3_14b,
    "paper-7b": paper_7b,
}


def list_archs():
    return list(_MODULES.keys())


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_draft_config(name: str) -> ModelConfig:
    return _MODULES[name].DRAFT


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family and features, tiny dimensions (smoke tests, CPU)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        vocab_size=256,
        max_position_embeddings=512,
        attn_chunk=64,
        xent_chunk=64,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 4) if
                  cfg.num_kv_heads > 1 else 1)
        kw["num_kv_heads"] = 1 if cfg.num_kv_heads == 1 else (
            2 if cfg.num_kv_heads < cfg.num_heads else 4)
        kw["head_dim"] = 32 if cfg.head_dim else 0
    if cfg.d_ff:
        kw["d_ff"] = 256 if not cfg.moe_num_experts else 64
    if cfg.moe_num_experts:
        kw.update(moe_num_experts=min(cfg.moe_num_experts, 4),
                  moe_top_k=min(cfg.moe_top_k, 2),
                  moe_capacity_factor=8.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, dec_layers=2, enc_context=32)
    if cfg.family == "hybrid":
        kw.update(num_layers=4, hybrid_attn_every=2)
    if cfg.num_image_tokens:
        kw["num_image_tokens"] = 8
    return cfg.replace(**kw)
