"""Model API of the port over every family of the reference: one
transformer serves the dense, MoE and VLM families (as in the reference's
``registry._FAMILY_MODULES``), ``mamba2`` the ssm family, ``hybrid`` the
zamba2-style hybrid and ``encdec`` the whisper-style encoder-decoder.

``get_model(cfg)`` returns a :class:`ModelAPI` with
  init(device=..., seed=...) -> params
  forward(params, batch) -> final hidden states (B, S, d)
    (batch["image_emb"] (B, N, d) prefixes a VLM's text; batch["enc_emb"]
    (B, S_enc, d) is an encoder-decoder's input)
  init_cache(batch_size, max_len, device=...) -> cache
  prefill(params, batch, max_len) -> (last_logits, cache)
  decode_step(params, cache, tokens) -> (logits, cache)
    (T > 1 on an ssm / hybrid model adds ``checkpoints`` of the state after
    each token, for the speculative rollback)
and, for the transformer families only (SSM state is O(1) and has no
pages),
  init_paged_cache(num_blocks, block_size, device=...) -> pages
  decode_step_paged(params, pages, tokens, tables, start[, valid])
    -> (logits, pages)
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

from .. import device as _device
from ..configs.base import ModelConfig
from . import encdec, hybrid, mamba2, transformer
from .common import init_layout, leaves, specs_of


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    init_paged_cache: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None


FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                  "vlm": transformer, "ssm": mamba2, "hybrid": hybrid,
                  "encdec": encdec}


def get_model(cfg: ModelConfig) -> ModelAPI:
    mod = FAMILY_MODULES[cfg.family]
    paged = {}
    if mod is transformer:
        paged = dict(
            init_paged_cache=functools.partial(transformer.init_paged_cache,
                                               cfg),
            decode_step_paged=functools.partial(
                transformer.decode_step_paged, cfg))
    return ModelAPI(
        cfg=cfg,
        init=functools.partial(init_params, cfg),
        forward=functools.partial(mod.forward, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
        prefill=functools.partial(mod.prefill, cfg),
        decode_step=functools.partial(mod.decode_step, cfg),
        **paged)


def param_layout(cfg: ModelConfig) -> dict:
    """The family's nested dict of parameter :class:`~.common.Spec`."""
    return FAMILY_MODULES[cfg.family].param_layout(cfg)


def param_specs(cfg: ModelConfig) -> dict:
    """The family's parameter tree as meta tensors (no storage)."""
    return specs_of(cfg, param_layout(cfg))


def init_params(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> dict:
    """Seeded random weights on ``device``: the reference's distributions
    (``common.init_layout``: truncated-normal fan-in dense weights,
    N(0, 0.02) embeddings, unit norms, zero biases, an fp32 MoE router, an
    SSM layer's A_log and dt_bias) drawn from a ``torch.Generator``."""
    return init_layout(cfg, param_layout(cfg), _device.resolve(device), seed)


def param_count(cfg: ModelConfig) -> int:
    """Parameter count from the port's own parameter shapes (no storage);
    a MoE counts every expert."""
    return sum(math.prod(s.shape) for s in leaves(param_layout(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (a MoE counts its top-k experts
    only)."""
    total = param_count(cfg)
    if not cfg.moe_num_experts:
        return total
    # subtract the inactive experts' MLP weights
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = (cfg.moe_num_experts - cfg.moe_top_k) * per_expert \
        * cfg.num_layers
    return total - inactive


def tree_to(params, device) -> dict:
    """Copy a parameter tree to ``device`` (draft offload / reload)."""
    return {k: tree_to(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in params.items()}
