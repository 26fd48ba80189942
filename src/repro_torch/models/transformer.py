"""Decoder-only transformer covering the dense, MoE and VLM families.

Layer parameters are stacked on a leading ``L`` axis, as the reference's
``scan_layers`` layout.  A MoE layer holds ``"moe"`` (router and stacked
experts, ``models/moe.py``) where a dense one holds ``"mlp"``; a VLM takes
``batch["image_emb"]`` (precomputed patch embeddings, projected by
``image_proj``) as a bidirectional prefix of ``num_image_tokens`` positions
in ``forward`` and ``prefill``, and serves text through the cache paths.
Two serving paths:

* paged: pools ``(L, NB+1, bs, KH, hd)`` with the write-off ("trash") block
  last.  One function, :func:`decode_step_paged`, serves every
  ``RealBackend`` shape: prefill (start=0), chunked-prefill appends (ragged
  ``valid``), decode (T=1) and speculative verification (T=gamma+1).
* dense cache: ``(L, B, S, KH, hd)`` k/v plus ``length`` (the
  ``DenseSlotBackend`` tier).  :func:`prefill` runs the whole prompt through
  the full-sequence attention (the flash kernel on the card) and
  :func:`decode_step` extends it by T tokens.

:func:`forward` is the full-sequence pass (final hidden states).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import device as _device
from ..kernels.paged_attention import paged_attention
from .common import (Spec, apply_mlp, apply_norm, attn_output,
                     blockwise_attention, cache_write, decode_attention,
                     model_dtype, qkv_project, rope_angles, stacked)
from . import moe

Params = Dict[str, Any]


def norm_layout(cfg, lead=()):
    d = cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": Spec(lead + (d,), "ones"),
                "bias": Spec(lead + (d,), "zeros")}
    return {"scale": Spec(lead + (d,), "zeros" if cfg.rmsnorm_offset
                           else "ones")}


def attn_layout(cfg, lead=(), *, cross: bool = False):
    """One attention block's projections (the reference's
    ``init_attention``): a cross-attention block has no qkv bias."""
    d, H, KH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    attn = {
        "wq": Spec(lead + (d, H, hd), "dense", d),
        "wk": Spec(lead + (d, KH, hd), "dense", d),
        "wv": Spec(lead + (d, KH, hd), "dense", d),
        "wo": Spec(lead + (H, hd, d), "dense", H * hd),
    }
    if cfg.qkv_bias and not cross:
        attn.update(bq=Spec(lead + (H, hd), "zeros"),
                    bk=Spec(lead + (KH, hd), "zeros"),
                    bv=Spec(lead + (KH, hd), "zeros"))
    if cfg.qk_norm:
        attn.update(q_norm=Spec(lead + (hd,), "ones"),
                    k_norm=Spec(lead + (hd,), "ones"))
    return attn


def mlp_layout(cfg, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wg": Spec(lead + (d, f), "dense", d),
                "wu": Spec(lead + (d, f), "dense", d),
                "wd": Spec(lead + (f, d), "dense", f)}
    return {"w1": Spec(lead + (d, f), "dense", d),
            "b1": Spec(lead + (f,), "zeros"),
            "w2": Spec(lead + (f, d), "dense", f),
            "b2": Spec(lead + (d,), "zeros")}


def param_layout(cfg) -> Dict[str, Any]:
    """Nested dict of every parameter's shape and initialiser."""
    d, ll = cfg.d_model, (cfg.num_layers,)
    mlp = (moe.moe_layout(cfg, ll) if cfg.moe_num_experts
           else mlp_layout(cfg, ll))
    layout = {
        "embed": Spec((cfg.vocab_size, d), "embed"),
        "layers": {"attn": attn_layout(cfg, ll), "ln1": norm_layout(cfg, ll),
                   "ln2": norm_layout(cfg, ll),
                   "moe" if cfg.moe_num_experts else "mlp": mlp},
        "final_norm": norm_layout(cfg),
    }
    if not cfg.tie_embeddings:
        layout["lm_head"] = Spec((cfg.vocab_size, d), "embed")
    if cfg.num_image_tokens:
        # the stubbed modality frontend: one projection of the patch
        # embeddings
        layout["image_proj"] = Spec((d, d), "embed")
    return layout


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters as views into the stacked tree."""
    return stacked(params["layers"], i)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    h = params["embed"][tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def embed_inputs(cfg, params, batch):
    """batch["tokens"] (B, S_txt), with batch["image_emb"] (B, N, d) for a
    VLM -> (B, N + S_txt, d): the projected image rows before the text.
    ``embed_scale`` applies to the text tokens only."""
    h = embed_tokens(cfg, params, batch["tokens"].long())
    if cfg.num_image_tokens and "image_emb" in batch:
        img = batch["image_emb"].to(h.dtype) @ params["image_proj"]
        h = torch.cat([img, h], dim=1)
    return h


def unembed(cfg, params, h):
    """h (B, T, d) -> fp32 logits (B, T, V).  The product runs in the model
    dtype (a bf16 model rounds its logits to bf16 before the cast)."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ table.t()).float()
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def rope_for(cfg, positions):
    """Every layer's RoPE angles for ``positions`` (B, S), or None."""
    if cfg.pos_embedding != "rope":
        return None
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Full sequence and dense KV cache
# ---------------------------------------------------------------------------


def _ffn(cfg, layer, x, capacity_factor=None):
    """The block's MLP, or its MoE at ``capacity_factor`` (None: the
    config's)."""
    if cfg.moe_num_experts:
        return moe.apply_moe(cfg, layer["moe"], x,
                             capacity_factor=capacity_factor)[0]
    return apply_mlp(cfg, layer["mlp"], x)


def _decode_cf(cfg) -> float:
    """The capacity factor of decode / verify / paged calls: at least 2, as
    the reference's ``apply_layer_decode`` and ``apply_layer_decode_paged``
    take it."""
    return max(cfg.moe_capacity_factor, 2.0)


def apply_layer_full(cfg, layer, h, rope, *, prefix_len: int = 0):
    """Full-sequence (prefill) pass through one block: h (B, S, d) ->
    (h, k, v), with causal attention over the whole sequence and a
    bidirectional prefix of ``prefix_len`` positions."""
    x = apply_norm(cfg, h, layer["ln1"])
    q, k, v = qkv_project(cfg, layer["attn"], x, rope)
    o = blockwise_attention(q, k, v, causal=True, prefix_len=prefix_len)
    h = h + attn_output(layer["attn"], o)
    x = apply_norm(cfg, h, layer["ln2"])
    return h + _ffn(cfg, layer, x), k, v


def _full_inputs(cfg, params, batch):
    """(h, rope, prefix_len) of a full-sequence pass: the image prefix (if
    any) counts in the positions."""
    h = embed_inputs(cfg, params, batch)
    S = h.shape[1]
    prefix = (cfg.num_image_tokens
              if cfg.num_image_tokens and "image_emb" in batch else 0)
    rope = rope_for(cfg, torch.arange(S, device=h.device)[None, :])
    return h, rope, prefix


def forward(cfg, params, batch):
    """batch["tokens"] (B, S_txt) [+ batch["image_emb"] (B, N, d)] -> final
    hidden states (B, N + S_txt, d), after the final norm (logits are
    ``unembed`` of them)."""
    h, rope, prefix = _full_inputs(cfg, params, batch)
    for i in range(cfg.num_layers):
        h = apply_layer_full(cfg, layer_params(params, i), h, rope,
                             prefix_len=prefix)[0]
    return apply_norm(cfg, h, params["final_norm"])


def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda"):
    """Dense KV cache: k/v (L, batch_size, max_len, KH, hd) zeros and
    ``length`` (batch_size,) int32 zeros."""
    dev = _device.resolve(device)
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=model_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=model_dtype(cfg), device=dev),
            "length": torch.zeros((batch_size,), dtype=torch.int32,
                                  device=dev)}


def prefill(cfg, params, batch, max_len: int):
    """Run the whole prompt batch["tokens"] (B, S_txt), after the image
    prefix batch["image_emb"] (B, N, d) of a VLM: returns the last
    position's logits (B, 1, V) fp32 and a new cache of ``max_len``
    positions holding the K/V of all S = N + S_txt positions, with length
    S."""
    h, rope, prefix = _full_inputs(cfg, params, batch)
    B, S = h.shape[:2]
    if S > max_len:
        raise ValueError(f"prefill: {S} prompt positions exceed the cache's "
                         f"{max_len}")
    cache = init_cache(cfg, B, max_len, device=h.device)
    for i in range(cfg.num_layers):
        h, k, v = apply_layer_full(cfg, layer_params(params, i), h, rope,
                                   prefix_len=prefix)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    cache["length"].fill_(S)
    h = apply_norm(cfg, h[:, -1:], params["final_norm"])
    return unembed(cfg, params, h), cache


def apply_layer_decode(cfg, layer, h, k_cache, v_cache, positions, rope):
    """Decode / extend: h (B, T, d); one layer's caches (B, S, KH, hd),
    written IN PLACE at ``positions`` (B, T) first; then every query attends
    to all cache slots at or before its position."""
    x = apply_norm(cfg, h, layer["ln1"])
    q, k, v = qkv_project(cfg, layer["attn"], x, rope)
    cache_write(k_cache, k, positions[:, 0])
    cache_write(v_cache, v, positions[:, 0])
    o = decode_attention(q, k_cache, v_cache, positions)
    h = h + attn_output(layer["attn"], o)
    x = apply_norm(cfg, h, layer["ln2"])
    return h + _ffn(cfg, layer, x, _decode_cf(cfg))


def decode_step(cfg, params, cache, tokens):
    """Extend by T tokens: tokens (B, T) int at positions cache["length"]
    onwards; T=1 is plain decode and T=gamma+1 the speculative-verify
    extension.  The k/v tensors are updated in place; returns (logits
    (B, T, V) fp32, a cache dict with those tensors and ``length`` + T)."""
    T = tokens.shape[1]
    positions = (cache["length"].long()[:, None]
                 + torch.arange(T, device=tokens.device)[None, :])
    rope = rope_for(cfg, positions)
    h = embed_tokens(cfg, params, tokens.long())
    for i in range(cfg.num_layers):
        h = apply_layer_decode(cfg, layer_params(params, i), h,
                               cache["k"][i], cache["v"][i], positions, rope)
    h = apply_norm(cfg, h, params["final_norm"])
    return unembed(cfg, params, h), {"k": cache["k"], "v": cache["v"],
                                     "length": cache["length"] + T}


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


def init_paged_cache(cfg, num_blocks: int, block_size: int, *,
                     device="cuda"):
    """Paged KV pool: (L, num_blocks + 1, block_size, KH, hd).

    The LAST block (index ``num_blocks``) is the write-off ("trash") block:
    padded batch rows and ragged-chunk tail slots scatter their K/V there,
    so no write can touch a live sequence's blocks.  Block tables are padded
    with the trash id too, which doubles as the "any valid id" padding the
    attention kernel requires."""
    dev = _device.resolve(device)
    shape = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k_pages": torch.zeros(shape, dtype=model_dtype(cfg), device=dev),
            "v_pages": torch.zeros(shape, dtype=model_dtype(cfg), device=dev)}


def _write_slots(tables, positions, valid, trash: int, block_size: int):
    """(block, offset) of every new token's K/V slot, each (B, T): through
    the block tables, with invalid slots routed to the trash block.  The
    same for every layer, so computed once per step."""
    idx = (positions // block_size).clamp(max=tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, idx)
    blk = torch.where(valid, blk, torch.full_like(blk, trash))
    return blk, positions % block_size


def apply_layer_decode_paged(cfg, layer, h, k_pages, v_pages, tables,
                             slots, rope, lengths):
    """h (B, T, d); one layer's pages (NB+1, bs, KH, hd).  The new K/V are
    written IN PLACE at ``slots`` first, then every query attends to all
    paged slots at or before its position."""
    x = apply_norm(cfg, h, layer["ln1"])
    q, k, v = qkv_project(cfg, layer["attn"], x, rope)
    k_pages.index_put_(slots, k.to(k_pages.dtype))
    v_pages.index_put_(slots, v.to(v_pages.dtype))
    o = paged_attention(q.contiguous(), k_pages, v_pages, tables, lengths)
    h = h + attn_output(layer["attn"], o.to(h.dtype))
    x = apply_norm(cfg, h, layer["ln2"])
    return h + _ffn(cfg, layer, x, _decode_cf(cfg))


def decode_step_paged(cfg, params, pages, tokens, tables, start, valid=None):
    """Extend T tokens per sequence against the paged KV pool.

    tokens: (B, T) int; tables: (B, max_blocks) int32 block tables padded
    with the trash id; start: (B,) tokens already materialised per sequence;
    valid: (B,) count of real tokens per row (None = all T valid).  Invalid
    tail slots write their K/V to the trash block and produce garbage
    logits — callers read logits at index ``valid - 1``.  The pages are
    updated in place.  Returns (logits (B, T, V) fp32, pages)."""
    B, T = tokens.shape
    ar = torch.arange(T, device=tokens.device)
    positions = start.long()[:, None] + ar[None, :]               # (B, T)
    if valid is None:
        vmask = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    else:
        vmask = ar[None, :] < valid[:, None]
    lengths = (start + T).to(torch.int32)
    tables = tables.to(torch.int32).contiguous()
    _, nb1, bs = pages["k_pages"].shape[:3]
    slots = _write_slots(tables, positions, vmask, nb1 - 1, bs)
    rope = rope_for(cfg, positions)
    h = embed_tokens(cfg, params, tokens.long())
    for i in range(cfg.num_layers):
        h = apply_layer_decode_paged(
            cfg, layer_params(params, i), h, pages["k_pages"][i],
            pages["v_pages"][i], tables, slots, rope, lengths)
    h = apply_norm(cfg, h, params["final_norm"])
    return unembed(cfg, params, h), pages
