"""Dense decoder-only transformer over a paged KV pool.

Layer parameters are stacked on a leading ``L`` axis, as the reference's
``scan_layers`` layout, and the paged pools are ``(L, NB+1, bs, KH, hd)``
with the write-off ("trash") block last.  One function,
:func:`decode_step_paged`, serves every real-backend shape: prefill
(start=0), chunked-prefill appends (ragged ``valid``), decode (T=1) and
speculative verification (T=gamma+1).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from .. import device as _device
from ..kernels.paged_attention import paged_attention
from .common import (apply_mlp, apply_norm, attn_output, dense_init_,
                     embed_init_, qkv_project, rope_angles)

Params = Dict[str, Any]


class _Spec(NamedTuple):
    shape: Tuple[int, ...]
    init: str          # dense | embed | ones | zeros
    fan_in: int = 0


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _norm_layout(cfg, lead=()):
    d = cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": _Spec(lead + (d,), "ones"),
                "bias": _Spec(lead + (d,), "zeros")}
    return {"scale": _Spec(lead + (d,), "zeros" if cfg.rmsnorm_offset
                           else "ones")}


def param_layout(cfg) -> Dict[str, Any]:
    """Nested dict of every parameter's shape and initialiser."""
    d, H, KH, hd, f, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, cfg.d_ff, cfg.num_layers)
    ll = (L,)
    attn = {
        "wq": _Spec(ll + (d, H, hd), "dense", d),
        "wk": _Spec(ll + (d, KH, hd), "dense", d),
        "wv": _Spec(ll + (d, KH, hd), "dense", d),
        "wo": _Spec(ll + (H, hd, d), "dense", H * hd),
    }
    if cfg.qkv_bias:
        attn.update(bq=_Spec(ll + (H, hd), "zeros"),
                    bk=_Spec(ll + (KH, hd), "zeros"),
                    bv=_Spec(ll + (KH, hd), "zeros"))
    if cfg.qk_norm:
        attn.update(q_norm=_Spec(ll + (hd,), "ones"),
                    k_norm=_Spec(ll + (hd,), "ones"))
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp = {"wg": _Spec(ll + (d, f), "dense", d),
               "wu": _Spec(ll + (d, f), "dense", d),
               "wd": _Spec(ll + (f, d), "dense", f)}
    else:
        mlp = {"w1": _Spec(ll + (d, f), "dense", d),
               "b1": _Spec(ll + (f,), "zeros"),
               "w2": _Spec(ll + (f, d), "dense", f),
               "b2": _Spec(ll + (d,), "zeros")}
    layout = {
        "embed": _Spec((cfg.vocab_size, d), "embed"),
        "layers": {"attn": attn, "ln1": _norm_layout(cfg, ll),
                   "ln2": _norm_layout(cfg, ll), "mlp": mlp},
        "final_norm": _norm_layout(cfg),
    }
    if not cfg.tie_embeddings:
        layout["lm_head"] = _Spec((cfg.vocab_size, d), "embed")
    return layout


def _map_layout(fn, layout):
    if isinstance(layout, _Spec):
        return fn(layout)
    return {k: _map_layout(fn, v) for k, v in layout.items()}


def param_specs(cfg) -> Params:
    """The parameter tree as meta tensors: shapes and dtypes, no storage."""
    dt = _dtype(cfg)
    return _map_layout(lambda s: torch.empty(s.shape, dtype=dt,
                                             device="meta"), param_layout(cfg))


def init_params(cfg, *, device="cuda", seed: int = 0) -> Params:
    """Seeded random weights on ``device``: the reference's distributions
    (truncated-normal fan-in dense weights, N(0, 0.02) embeddings, unit
    norms, zero qkv biases) drawn from a ``torch.Generator``."""
    dev = _device.resolve(device)
    dt = _dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(s: _Spec):
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        t = torch.empty(s.shape, dtype=dt, device=dev)
        if s.init == "embed":
            return embed_init_(t, gen)
        return dense_init_(t, s.fan_in, gen)

    return _map_layout(make, param_layout(cfg))


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters as views into the stacked tree."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    h = params["embed"][tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def unembed(cfg, params, h):
    """h (B, T, d) -> fp32 logits (B, T, V).  The product runs in the model
    dtype (a bf16 model rounds its logits to bf16 before the cast)."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ table.t()).float()
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


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
    return {"k_pages": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v_pages": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}


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
    return h + apply_mlp(cfg, layer["mlp"], x)


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
    rope = (rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if cfg.pos_embedding == "rope" else None)
    h = embed_tokens(cfg, params, tokens.long())
    for i in range(cfg.num_layers):
        h = apply_layer_decode_paged(
            cfg, layer_params(params, i), h, pages["k_pages"][i],
            pages["v_pages"][i], tables, slots, rope, lengths)
    h = apply_norm(cfg, h, params["final_norm"])
    return unembed(cfg, params, h), pages
