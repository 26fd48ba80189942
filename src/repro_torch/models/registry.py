"""Model API of the port: the full-sequence, dense-cache and paged serving
paths of the dense, MoE and VLM families (one transformer serves all three,
as in the reference's ``registry._FAMILY_MODULES``).

``get_model(cfg)`` returns a :class:`ModelAPI` with
  init(device=..., seed=...) -> params
  forward(params, batch) -> final hidden states (B, S, d)
    (batch["image_emb"] (B, N, d) prefixes a VLM's text)
  init_cache(batch_size, max_len, device=...) -> cache
  prefill(params, batch, max_len) -> (last_logits, cache)
  decode_step(params, cache, tokens) -> (logits, cache)
  init_paged_cache(num_blocks, block_size, device=...) -> pages
  decode_step_paged(params, pages, tokens, tables, start[, valid])
    -> (logits, pages)
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

from ..configs.base import ModelConfig
from . import transformer


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


FAMILIES = ("dense", "moe", "vlm")


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in FAMILIES or cfg.pos_embedding == "learned":
        raise NotImplementedError(
            f"{cfg.name}: the port serves the {', '.join(FAMILIES)} "
            f"families with RoPE or no position embedding (family "
            f"{cfg.family!r} not ported)")
    return ModelAPI(
        cfg=cfg,
        init=functools.partial(transformer.init_params, cfg),
        forward=functools.partial(transformer.forward, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
        prefill=functools.partial(transformer.prefill, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_paged_cache=functools.partial(transformer.init_paged_cache, cfg),
        decode_step_paged=functools.partial(transformer.decode_step_paged,
                                            cfg),
    )


def leaves(tree):
    """The leaves of a nested dict, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def param_count(cfg: ModelConfig) -> int:
    """Parameter count from the port's own parameter shapes (meta tensors,
    no storage); a MoE counts every expert."""
    return sum(math.prod(t.shape) for t in leaves(
        transformer.param_specs(cfg)))


def tree_to(params, device) -> dict:
    """Copy a parameter tree to ``device`` (draft offload / reload)."""
    return {k: tree_to(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in params.items()}
