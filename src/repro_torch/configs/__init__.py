"""Config registry of the port: the architectures it serves, their draft
pairings, the assigned shapes, the inputs of each (arch, shape) cell as
meta tensors (``input_specs``), and reduced configs for CPU tests.

A copy of the reference registry: every architecture of the reference,
each family served by its own model module.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ModelConfig, ParallelConfig, ShapeConfig, shapes_for)
from . import (deepseek_7b, gemma_7b, granite_moe_1b, grok1_314b,
               mamba2_780m, paligemma_3b, paper_7b, qwen2_72b, qwen3_14b,
               whisper_medium, zamba2_1p2b)

_MODULES = {
    "whisper-medium": whisper_medium,
    "deepseek-7b": deepseek_7b,
    "gemma-7b": gemma_7b,
    "qwen2-72b": qwen2_72b,
    "qwen3-14b": qwen3_14b,
    "grok-1-314b": grok1_314b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "zamba2-1.2b": zamba2_1p2b,
    "paligemma-3b": paligemma_3b,
    "mamba2-780m": mamba2_780m,
    "paper-7b": paper_7b,
}


ASSIGNED_ARCHS: Tuple[str, ...] = tuple(k for k in _MODULES if k != "paper-7b")


def list_archs():
    return list(_MODULES.keys())


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_draft_config(name: str) -> ModelConfig:
    return _MODULES[name].DRAFT


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


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
        # cf=8: no capacity drops at smoke scale, so prefill + decode equals
        # the full forward (drops depend on the batch's composition)
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, batch_override=None,
                device="meta") -> Dict:
    """The inputs of the step of this (arch, shape) cell, as empty tensors
    on ``device`` (meta: shapes and dtypes, no storage) — the reference's
    ``ShapeDtypeStruct`` tree:

    train   -> {"batch": {tokens, labels[, enc_emb | image_emb]}}
    prefill -> {"batch": {tokens[, enc_emb | image_emb]}}
    decode  -> {"cache": the family's cache filled to S, "tokens": (B, 1)}
    """
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.family == "encdec":
            dec_len = S if shape.kind == "train" else max(S // 4, 1)
            batch["enc_emb"] = empty((B, S, cfg.d_model), bf16)
            batch["tokens"] = empty((B, dec_len), i32)
            if shape.kind == "train":
                batch["labels"] = empty((B, dec_len), i32)
        elif cfg.family == "vlm":
            n_img = cfg.num_image_tokens
            batch["image_emb"] = empty((B, n_img, cfg.d_model), bf16)
            batch["tokens"] = empty((B, S - n_img), i32)
            if shape.kind == "train":
                batch["labels"] = empty((B, S - n_img), i32)
        else:
            batch["tokens"] = empty((B, S), i32)
            if shape.kind == "train":
                batch["labels"] = empty((B, S), i32)
        return {"batch": batch}

    from ..models import registry  # local import: models import configs
    api = registry.get_model(cfg)
    if cfg.family == "encdec":
        cache = api.init_cache(B, S, enc_len=cfg.enc_context, device=device)
    else:
        cache = api.init_cache(B, S, device=device)
    return {"cache": cache, "tokens": empty((B, 1), i32)}
