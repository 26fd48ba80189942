"""Model API of the port: the paged serving path of the dense family.

``get_model(cfg)`` returns a :class:`ModelAPI` with
  init(device=..., seed=...) -> params
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
    init_paged_cache: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None


def get_model(cfg: ModelConfig) -> ModelAPI:
    if (cfg.family != "dense" or cfg.moe_num_experts
            or cfg.pos_embedding == "learned"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense decoders with RoPE or no "
            f"position embedding (family {cfg.family!r} not ported)")
    return ModelAPI(
        cfg=cfg,
        init=functools.partial(transformer.init_params, cfg),
        init_paged_cache=functools.partial(transformer.init_paged_cache, cfg),
        decode_step_paged=functools.partial(transformer.decode_step_paged,
                                            cfg),
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ModelConfig) -> int:
    """Parameter count from the port's own parameter shapes (meta tensors,
    no storage)."""
    return sum(math.prod(t.shape) for t in _leaves(
        transformer.param_specs(cfg)))


def tree_to(params, device) -> dict:
    """Copy a parameter tree to ``device`` (draft offload / reload)."""
    return {k: tree_to(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in params.items()}
