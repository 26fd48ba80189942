"""A configuration file read into the sizes the harness counts with, the
port's ``ModelConfig``, and seeded weights in the port's parameter layout.

A configuration file holds the target's published ``config.json`` keys at
its top level, the draft's in ``draft``, the serving deployment in
``deployment`` and what the port needs besides the published keys
(family, q/k/v bias, the MoE capacity factor) in ``port``.  Every value is
the one that runs.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# published keys whose value the port has no mechanism for: the file must
# give the value that runs (the mechanism's identity), listed in
# ``reduced`` where the source differs
_IDENTITY = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
             "logits_scaling": 1.0}


def sizes(group: dict) -> Dict[str, object]:
    """The sizes of one model (the target's top level, or ``draft``), by
    the names the harness's counts and reference use."""
    for key, ident in _IDENTITY.items():
        if key in group and float(group[key]) != ident:
            raise ValueError(f"{key}={group[key]}: the port has no such "
                             f"multiplier; the file must hold {ident}")
    heads = int(group["num_attention_heads"])
    hd = int(group.get("head_dim", 0)) or int(group["hidden_size"]) // heads
    if "attention_multiplier" in group and not math.isclose(
            float(group["attention_multiplier"]), hd ** -0.5):
        raise ValueError("attention_multiplier: the port scales scores by "
                         "head_dim ** -0.5")
    if float(group.get("rms_norm_eps", 1e-6)) != 1e-6:
        raise ValueError("the port's RMSNorm takes eps 1e-6")
    return {
        "layers": int(group["num_hidden_layers"]),
        "d_model": int(group["hidden_size"]),
        "heads": heads,
        "kv_heads": int(group["num_key_value_heads"]),
        "head_dim": hd,
        "d_ff": int(group["intermediate_size"]),
        "vocab": int(group["vocab_size"]),
        "experts": int(group.get("num_local_experts", 0)),
        "top_k": int(group.get("num_experts_per_tok", 0)),
        "rope_theta": float(group["rope_theta"]),
        "tied": bool(group["tie_word_embeddings"]),
    }


def port_config(name: str, group: dict, port: dict):
    """The port's ``ModelConfig`` of one model of the file."""
    from repro_torch.configs.base import ModelConfig
    s = sizes(group)
    kw = dict(name=name, family=port["family"], num_layers=s["layers"],
              d_model=s["d_model"], num_heads=s["heads"],
              num_kv_heads=s["kv_heads"], d_ff=s["d_ff"],
              vocab_size=s["vocab"], rope_theta=s["rope_theta"],
              tie_embeddings=s["tied"], qkv_bias=bool(port["qkv_bias"]),
              mlp_type="swiglu", dtype=group["torch_dtype"])
    if s["head_dim"] * s["heads"] != s["d_model"]:
        kw["head_dim"] = s["head_dim"]
    if s["experts"]:
        kw.update(moe_num_experts=s["experts"], moe_top_k=s["top_k"],
                  moe_capacity_factor=float(port["moe_capacity_factor"]))
    return ModelConfig(**kw)


def pair(config: dict):
    """(target, draft) ``ModelConfig`` of a configuration file."""
    return (port_config(config["name"], config, config["port"]["target"]),
            port_config(config["name"] + "-draft", config["draft"],
                        config["port"]["draft"]))


def make_weights(cfg, gen: torch.Generator, device) -> dict:
    """Seeded weights in the port's parameter layout
    (``registry.param_layout``), made on ``device`` in the type they are
    served in, one draw per stacked leaf: dense weights N(0, 1/fan_in),
    embeddings N(0, 0.02^2), norm scales 1 + N(0, 0.05^2) and biases
    N(0, 0.02^2) (neither left at its identity, so the comparison sees
    them), the fp32 router like a dense weight."""
    from repro_torch.models.registry import param_layout
    from repro_torch.models.common import Spec, leaf_dtype

    def make(s: Spec):
        t = torch.randn(s.shape, generator=gen, device=device,
                        dtype=leaf_dtype(cfg, s))
        if s.init == "dense":
            return t.mul_(max(s.fan_in, 1) ** -0.5)
        if s.init == "embed":
            return t.mul_(0.02)
        if s.init == "ones":
            return t.mul_(0.05).add_(1.0)
        if s.init == "zeros":
            return t.mul_(0.02)
        raise ValueError(f"{cfg.name}: no seeded init for {s.init!r}")

    def walk(layout):
        if isinstance(layout, dict):
            return {k: walk(v) for k, v in layout.items()}
        return make(layout)

    return walk(param_layout(cfg))


def make_pair_weights(tcfg, dcfg, seed: int, device) -> Tuple[dict, dict]:
    """Target and draft weights from one generator seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return make_weights(tcfg, gen, device), make_weights(dcfg, gen, device)
