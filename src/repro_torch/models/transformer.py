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
  ``RealBackend`` shape: padded calls — prefill (start=0), decode (T=1) and
  speculative verification (T=gamma+1) — and packed calls, which run the
  chunked prefill's ragged rows (chunks beside T=1 decode rows, draft
  catch-ups) over their real positions only.
* dense cache: ``(L, B, S, KH, hd)`` k/v plus ``length`` (the
  ``DenseSlotBackend`` tier).  :func:`prefill` runs the whole prompt through
  the full-sequence attention (the flash kernel on the card) and
  :func:`decode_step` extends it by T tokens.

:func:`forward` is the full-sequence pass (final hidden states), each layer
under ``cfg.remat``.  On DTensor parameters and inputs the full-sequence
and dense-cache paths take the reference's sharding hooks
(``distributed/sharding.py``); the paged path takes none, as in the
reference.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import device as _device
from ..distributed.sharding import (cache_write, embed_lookup,
                                    gather_sequence, gather_weights,
                                    new_cache, replicate_dim,
                                    replicate_new_kv, shard_activations,
                                    shard_kv_cache, write_prefix)
from ..configs.base import FULL
from ..kernels.paged_attention import paged_attention
from .common import (Spec, apply_mlp, apply_norm, attn_output,
                     blockwise_attention, decode_attention, maybe_remat,
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
    h = embed_lookup(params["embed"], tokens)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def embed_inputs(cfg, params, batch):
    """batch["tokens"] (B, S_txt), with batch["image_emb"] (B, N, d) for a
    VLM -> (B, N + S_txt, d): the projected image rows before the text.
    ``embed_scale`` applies to the text tokens only."""
    h = embed_tokens(cfg, params, batch["tokens"].long())
    if cfg.num_image_tokens and "image_emb" in batch:
        # a DTensor projection's model-sharded columns gathered: the
        # residual stream keeps d whole
        img = replicate_dim(batch["image_emb"].to(h.dtype)
                            @ params["image_proj"], 2)
        h = torch.cat([img, h], dim=1)
    return h


def unembed(cfg, params, h):
    """h (B, T, d) -> fp32 logits (B, T, V).  The product runs in the model
    dtype (a bf16 model rounds its logits to bf16 before the cast)."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ gather_weights(table).t()).float()
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def rope_for(cfg, positions):
    """The RoPE angles for ``positions`` (B, S), once per step, or None.  A
    config without layer types has one table for every layer; one with
    layer types (``configs.base.WindowedConfig``) a table per kind present,
    ``{kind: (cos, sin)}``, the full layers' yarn's where it has yarn.  A
    layer picks its own with :func:`layer_rope`."""
    if cfg.pos_embedding != "rope":
        return None
    hd = cfg.resolved_head_dim
    if not cfg.layer_types:
        return rope_angles(positions, hd, cfg.rope_theta,
                           yarn=cfg if cfg.yarn_factor else None)
    return {kind: rope_angles(positions, hd, cfg.rope_theta,
                              yarn=cfg if kind == FULL and cfg.yarn_factor
                              else None)
            for kind in set(cfg.layer_types)}


def layer_rope(cfg, rope, i: int):
    """Layer ``i``'s table of :func:`rope_for`'s ``rope``."""
    return rope[cfg.layer_types[i]] if cfg.layer_types and rope else rope


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


def _packed_cf(cfg) -> float:
    """The capacity factor of a packed paged call: E / k, so that every
    expert has room for all of the call's tokens and none is dropped.  A
    padded chunk call gave its chunk's tokens the head of queues longer
    than the chunk; packed at 2.0, a chunk's tail and the decode rows behind
    it would drop wherever routing is uneven.  None for a dense model."""
    return cfg.moe_num_experts / cfg.moe_top_k if cfg.moe_num_experts \
        else None


def apply_layer_full(cfg, layer, h, rope, *, prefix_len: int = 0,
                     window: int = 0):
    """Full-sequence (prefill) pass through one block: h (B, S, d) ->
    (h, k, v), with causal attention over the whole sequence (a sliding
    layer: over its last ``window`` positions) and a bidirectional prefix
    of ``prefix_len`` positions."""
    h = gather_sequence(h)
    x = apply_norm(cfg, h, layer["ln1"])
    q, k, v = qkv_project(cfg, layer["attn"], x, rope)
    o = blockwise_attention(q, k, v, causal=True, prefix_len=prefix_len,
                            window=window)
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

    def block(hh, i):
        return shard_activations(apply_layer_full(
            cfg, layer_params(params, i), hh, layer_rope(cfg, rope, i),
            prefix_len=prefix, window=cfg.layer_window(i))[0])

    block = maybe_remat(cfg, block)
    h = shard_activations(h)
    for i in range(cfg.num_layers):
        h = block(h, i)
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
    cache = new_cache(lambda dev: init_cache(cfg, B, max_len, device=dev), h)
    for i in range(cfg.num_layers):
        h, k, v = apply_layer_full(cfg, layer_params(params, i), h,
                                   layer_rope(cfg, rope, i),
                                   prefix_len=prefix,
                                   window=cfg.layer_window(i))
        h = shard_activations(h)
        write_prefix(cache["k"][i], k)
        write_prefix(cache["v"][i], v)
    cache["length"].fill_(S)
    h = apply_norm(cfg, replicate_dim(h, 1)[:, -1:], params["final_norm"])
    return unembed(cfg, params, h), cache


def apply_layer_decode(cfg, layer, h, k_cache, v_cache, positions, rope,
                       window: int = 0):
    """Decode / extend: h (B, T, d); one layer's caches (B, S, KH, hd),
    written IN PLACE at ``positions`` (B, T) first; then every query attends
    to all cache slots at or before its position (a sliding layer: the last
    ``window`` of them)."""
    x = apply_norm(cfg, h, layer["ln1"])
    q, k, v = qkv_project(cfg, layer["attn"], x, rope)
    start = positions[:, 0]
    k_cache = shard_kv_cache(cache_write(k_cache, replicate_new_kv(k), start))
    v_cache = shard_kv_cache(cache_write(v_cache, replicate_new_kv(v), start))
    o = decode_attention(q, k_cache, v_cache, positions, window)
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
                               cache["k"][i], cache["v"][i], positions,
                               layer_rope(cfg, rope, i), cfg.layer_window(i))
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


def _attend(q, k_pages, v_pages, tables, lengths, runs, window=0):
    """Paged attention of one layer (a sliding layer: over the last
    ``window`` positions of each query).  Without ``runs`` (a padded call)
    one launch over the (B, T) queries.  A packed call's q is (N, 1, H, D),
    its rows' positions one after another; each run ``(r0, r1, n, off)`` of
    rows r0..r1-1 holding n queries each, from position ``off`` of the
    stream on, attends in one launch of (r1 - r0, n) queries."""
    if runs is None:
        return paged_attention(q, k_pages, v_pages, tables, lengths, window)
    H, D = q.shape[2:]
    outs = [paged_attention(q[off:off + (r1 - r0) * n].view(r1 - r0, n, H, D),
                            k_pages, v_pages, tables[r0:r1], lengths[r0:r1],
                            window)
            .reshape(-1, 1, H, D) for r0, r1, n, off in runs]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def apply_layer_decode_paged(cfg, layer, h, k_pages, v_pages, tables,
                             slots, rope, lengths, runs=None, window=0):
    """h (B, T, d); one layer's pages (NB+1, bs, KH, hd).  The new K/V are
    written IN PLACE at ``slots`` first, then every query attends to all
    paged slots at or before its position (a sliding layer: the last
    ``window`` of them; ``runs``: a packed call's rows, see
    :func:`_attend`)."""
    x = apply_norm(cfg, h, layer["ln1"])
    q, k, v = qkv_project(cfg, layer["attn"], x, rope)
    k_pages.index_put_(slots, k.to(k_pages.dtype))
    v_pages.index_put_(slots, v.to(v_pages.dtype))
    o = _attend(q.contiguous(), k_pages, v_pages, tables, lengths, runs,
                window)
    h = h + attn_output(layer["attn"], o.to(h.dtype))
    x = apply_norm(cfg, h, layer["ln2"])
    cf = _decode_cf(cfg) if runs is None else _packed_cf(cfg)
    return h + _ffn(cfg, layer, x, cf)


def decode_step_paged(cfg, params, pages, tokens, tables, start, valid=None):
    """Extend sequences against the paged KV pool, which is updated in
    place.  Two layouts, told apart by the operands' shapes:

    * padded, tokens (B, T) beside B rows of tables: tables (B, max_blocks)
      int32 block tables padded with the trash id; start (B,) tokens
      already materialised per sequence; valid (B,) count of real tokens
      per row (None = all T valid).  Invalid tail slots write their K/V to
      the trash block and produce garbage logits — callers read logits at
      index ``valid - 1``.  start and valid may lie on the host.  Returns
      (logits (B, T, V) fp32, pages).
    * packed, tokens (N, 1) beside R < N rows of tables: the R rows' real
      tokens one after another, with tables (R, max_blocks), start (R,) and
      valid (R,) per row, N = sum(valid).  Only the N real positions run
      and no slot is written to the trash block.  Returns (logits (R, 1, V)
      fp32 at each row's last position, pages).  Pass start and valid as
      host tensors: the layout is read from them on the host.

    When N == R every row holds one token, and the two layouts are one
    call."""
    if tokens.shape[0] > tables.shape[0]:
        return _decode_step_packed(cfg, params, pages, tokens, tables, start,
                                   valid)
    B, T = tokens.shape
    start = start.to(tokens.device)
    ar = torch.arange(T, device=tokens.device)
    positions = start.long()[:, None] + ar[None, :]               # (B, T)
    if valid is None:
        vmask = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    else:
        vmask = ar[None, :] < valid.to(tokens.device)[:, None]
    lengths = (start + T).to(torch.int32)
    tables = tables.to(torch.int32).contiguous()
    _, nb1, bs = pages["k_pages"].shape[:3]
    slots = _write_slots(tables, positions, vmask, nb1 - 1, bs)
    rope = rope_for(cfg, positions)
    h = embed_tokens(cfg, params, tokens.long())
    for i in range(cfg.num_layers):
        h = apply_layer_decode_paged(
            cfg, layer_params(params, i), h, pages["k_pages"][i],
            pages["v_pages"][i], tables, slots, layer_rope(cfg, rope, i),
            lengths, window=cfg.layer_window(i))
    h = apply_norm(cfg, h, params["final_norm"])
    return unembed(cfg, params, h), pages


def _decode_step_packed(cfg, params, pages, tokens, tables, start, valid):
    """:func:`decode_step_paged` of the packed layout.  Every token-wise op
    (embedding, norms, projections, the MLP or the MoE layer, the K/V
    writes) runs over the N real positions, the MoE layer taking them as
    its call with room for all of them (:func:`_packed_cf`); attention
    runs once per run of consecutive rows with equal query counts; the
    unembedding only at each row's last position."""
    dev = tokens.device
    st = start.cpu().numpy().astype(np.int64)
    nv = valid.cpu().numpy().astype(np.int64)
    N, R = tokens.shape[0], len(nv)
    if tokens.shape[1] != 1 or int(nv.sum()) != N or nv.min() < 1:
        raise ValueError(f"decode_step_paged: a packed call takes tokens "
                         f"(sum(valid), 1) and rows of at least one token; "
                         f"got tokens {tuple(tokens.shape)}, valid {nv}")
    ends = np.cumsum(nv)
    first = ends - nv                       # each row's offset in the stream
    row = np.repeat(np.arange(R), nv)
    pos = st[row] + np.arange(N) - first[row]
    idx = torch.from_numpy(np.concatenate([pos, row, ends - 1])).to(dev)
    positions, row_d, last = idx[:N, None], idx[N:2 * N], idx[2 * N:]
    lengths = torch.from_numpy((st + nv).astype(np.int32)).to(dev)
    cut = np.flatnonzero(np.diff(nv)) + 1
    runs = [(int(a), int(b), int(nv[a]), int(first[a]))
            for a, b in zip(np.r_[0, cut], np.r_[cut, R])]
    tables = tables.to(torch.int32).contiguous()
    bs = pages["k_pages"].shape[2]
    slots = (tables.long()[row_d[:, None], positions // bs], positions % bs)
    rope = rope_for(cfg, positions)
    h = embed_tokens(cfg, params, tokens.long())                   # (N, 1, d)
    for i in range(cfg.num_layers):
        h = apply_layer_decode_paged(
            cfg, layer_params(params, i), h, pages["k_pages"][i],
            pages["v_pages"][i], tables, slots, layer_rope(cfg, rope, i),
            lengths, runs, cfg.layer_window(i))
    h = apply_norm(cfg, h[last], params["final_norm"])             # (R, 1, d)
    return unembed(cfg, params, h), pages
