"""Model API of the port over every family of the reference: one
transformer serves the dense, MoE and VLM families (as in the reference's
``registry._FAMILY_MODULES``), ``mamba2`` the ssm family, ``hybrid`` the
zamba2-style hybrid and ``encdec`` the whisper-style encoder-decoder.

``get_model(cfg)`` returns a :class:`ModelAPI` with
  init(device=..., seed=...) -> params
  forward(params, batch) -> final hidden states (B, S, d)
    (batch["image_emb"] (B, N, d) prefixes a VLM's text; batch["enc_emb"]
    (B, S_enc, d) is an encoder-decoder's input)
  loss(params, batch) -> (scalar loss, metrics): the streamed
    cross-entropy of batch["labels"] (B, S_txt), -100 ignored
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
    (padded: tokens (B, T), logits (B, T, V); packed: tokens (N, 1), the
    real tokens of R < N rows, logits (R, 1, V) at each row's last
    position: ``transformer.decode_step_paged``)
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..configs.base import ModelConfig
from ..distributed.sharding import (gather_weights, label_logits,
                                    logsumexp, replicate_dim)
from . import encdec, hybrid, mamba2, transformer
from .common import init_layout, leaf_dtype, leaves, specs_of


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
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


def unembed_table(cfg, params):
    """The (V, d) unembedding: the embedding when tied (always for an
    encoder-decoder), else ``lm_head``."""
    if cfg.family == "encdec" or cfg.tie_embeddings or "lm_head" not in params:
        return params["embed"]
    return params["lm_head"]


def _chunk_nll(softcap: float, table, h, y):
    """(summed NLL, count of labels >= 0) of one chunk: h (B, C, d), y
    (B, C).  The product runs in the model dtype, the softmax in fp32."""
    logits = (h @ table.t()).float()
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    lse = logsumexp(logits)
    mask = y >= 0
    gold = label_logits(logits, y.clamp(min=0).long())
    nll = torch.where(mask, lse - gold, torch.zeros_like(lse))
    return nll.sum(), mask.sum()


def streamed_xent(cfg, params, hidden, labels):
    """Chunked softmax cross-entropy: hidden (B, S, d), labels (B, S); label
    -100 is ignored.  The sequence is cut into ``cfg.xent_chunk`` chunks
    (the last one shorter where the chunk does not divide S; the reference
    pads it with ignored labels, which add nothing), each unembedded under
    ``torch.utils.checkpoint``, so no (B, S, V) logits tensor exists in the
    forward or the backward: a chunk's logits are rebuilt when its gradient
    is taken.  No padding: DTensor on the card's PyTorch cannot propagate a
    pad of a batch-sharded tensor."""
    table = gather_weights(unembed_table(cfg, params))
    hidden = replicate_dim(hidden, 1)   # chunks slice the sequence
    S = hidden.shape[1]
    chunk = min(cfg.xent_chunk, S)
    tot = cnt = 0
    for start in range(0, S, chunk):
        sl = slice(start, min(start + chunk, S))
        s, c = checkpoint(_chunk_nll, cfg.logit_softcap, table,
                          hidden[:, sl], labels[:, sl], use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / cnt.clamp(min=1)


def make_loss(cfg, forward):
    """``loss(params, batch) -> (loss, {})`` over the family's ``forward``:
    a VLM given ``image_emb`` drops the image rows before the loss."""
    def loss(params, batch):
        hidden = forward(cfg, params, batch)
        if cfg.family == "vlm" and "image_emb" in batch:
            hidden = hidden[:, cfg.num_image_tokens:, :]
        return streamed_xent(cfg, params, hidden, batch["labels"]), {}
    return loss


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
        loss=make_loss(cfg, mod.forward),
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


def param_bytes(cfg: ModelConfig) -> int:
    """Bytes of the parameters, each leaf at its own dtype's width."""
    return sum(math.prod(s.shape) * torch.empty((), dtype=leaf_dtype(cfg, s))
               .element_size() for s in leaves(param_layout(cfg)))


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
