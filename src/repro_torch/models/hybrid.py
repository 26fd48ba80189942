"""Zamba2-style hybrid, the ``hybrid`` family: a Mamba2 backbone plus ONE
shared attention + MLP block whose weights are reused after every
``hybrid_attn_every``-th layer (zamba2's parameter sharing).

Each application point keeps its own KV cache (weights are shared,
activations are not).  The shared block sees the current hidden state plus
the original token embedding (the reference's additive simplification of
zamba2's concat + linear).  The mamba layers are stacked on a leading ``L``
axis; the reference keeps them as a list (``scan_layers=False``), which
``bridge.params_from_numpy`` stacks.  Prefill runs the shared block's
attention through ``blockwise_attention`` (the flash kernel on the card);
decode through the plain dense-cache attention.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..distributed.sharding import (cache_write, embed_lookup,
                                    gather_sequence, new_cache,
                                    replicate_dim, replicate_new_kv,
                                    shard_activations, shard_kv_cache,
                                    tree_gather, write_prefix)
from .common import (Spec, apply_mlp, attn_output, blockwise_attention,
                     decode_attention, maybe_remat, model_dtype,
                     qkv_project, rms_norm, stacked, tied_unembed)
from . import mamba2
from .transformer import attn_layout, mlp_layout, rope_for

Params = Dict[str, Any]


def attn_points(cfg):
    """Layer indices after which the shared attention block is applied."""
    k = cfg.hybrid_attn_every
    return tuple(i for i in range(cfg.num_layers) if (i + 1) % k == 0)


def param_layout(cfg) -> Params:
    d = cfg.d_model
    return {
        "embed": Spec((cfg.vocab_size, d), "embed"),
        "layers": mamba2.mamba_layer_layout(cfg, (cfg.num_layers,)),
        "shared": {"attn": attn_layout(cfg), "mlp": mlp_layout(cfg),
                   "ln1": Spec((d,), "ones"), "ln2": Spec((d,), "ones")},
        "final_norm": Spec((d,), "ones"),
    }


def _shared_full(cfg, shared, h, emb, rope):
    shared = tree_gather(shared)
    h = gather_sequence(h)
    x = rms_norm(h + emb, shared["ln1"])
    q, k, v = qkv_project(cfg, shared["attn"], x, rope)
    h = h + attn_output(shared["attn"],
                        blockwise_attention(q, k, v, causal=True))
    x = rms_norm(h, shared["ln2"])
    return h + apply_mlp(cfg, shared["mlp"], x), k, v


def _shared_decode(cfg, shared, h, emb, k_cache, v_cache, positions, rope):
    """The shared block at one application point: its caches (B, S, KH, hd)
    are written IN PLACE at ``positions`` first."""
    shared = tree_gather(shared)
    x = rms_norm(h + emb, shared["ln1"])
    q, k, v = qkv_project(cfg, shared["attn"], x, rope)
    start = positions[:, 0]
    k_cache = shard_kv_cache(cache_write(k_cache, replicate_new_kv(k), start))
    v_cache = shard_kv_cache(cache_write(v_cache, replicate_new_kv(v), start))
    h = h + attn_output(shared["attn"],
                        decode_attention(q, k_cache, v_cache, positions))
    x = rms_norm(h, shared["ln2"])
    return h + apply_mlp(cfg, shared["mlp"], x)


def forward(cfg, params, batch):
    """batch["tokens"] (B, S) -> final hidden states (B, S, d)."""
    tokens = batch["tokens"].long()
    emb = embed_lookup(params["embed"], tokens)
    rope = rope_for(cfg, torch.arange(tokens.shape[1],
                                      device=tokens.device)[None, :])
    pts = set(attn_points(cfg))

    def block(hh, i):
        hh = mamba2.apply_mamba_full(cfg, stacked(params["layers"], i),
                                     hh)[0]
        if i in pts:
            hh = _shared_full(cfg, params["shared"], hh, emb, rope)[0]
        return shard_activations(hh)

    block = maybe_remat(cfg, block, dots=False)
    h = emb
    for i in range(cfg.num_layers):
        h = block(h, i)
    return rms_norm(h, params["final_norm"])


def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda"):
    """The mamba state plus attn_k / attn_v (points, B, max_len, KH, hd)."""
    cache = mamba2.init_cache(cfg, batch_size, device=device)
    shape = (len(attn_points(cfg)), batch_size, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = cache["length"].device
    cache["attn_k"] = torch.zeros(shape, dtype=model_dtype(cfg), device=dev)
    cache["attn_v"] = torch.zeros(shape, dtype=model_dtype(cfg), device=dev)
    return cache


def prefill(cfg, params, batch, max_len: int):
    """Run the prompt (B, S): the last position's logits (B, 1, V) fp32 and
    a new cache of ``max_len`` attention positions."""
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prefill: {S} prompt positions exceed the cache's "
                         f"{max_len}")
    emb = embed_lookup(params["embed"], tokens)
    rope = rope_for(cfg, torch.arange(S, device=tokens.device)[None, :])
    cache = new_cache(lambda dev: init_cache(cfg, B, max_len, device=dev),
                      emb)
    pts = attn_points(cfg)
    h = emb
    for i in range(cfg.num_layers):
        layer = stacked(params["layers"], i)
        cache["conv"][i].copy_(mamba2.conv_tail(cfg, layer, h))
        h, final = mamba2.apply_mamba_full(cfg, layer, h)
        cache["ssm"][i].copy_(final)
        if i in pts:
            h, k, v = _shared_full(cfg, params["shared"], h, emb, rope)
            app = pts.index(i)
            write_prefix(cache["attn_k"][app], k)
            write_prefix(cache["attn_v"][app], v)
    cache["length"].fill_(S)
    h = rms_norm(replicate_dim(h, 1)[:, -1:], params["final_norm"])
    return tied_unembed(params, h), cache


def _step_once(cfg, params, cache, tok_col, positions):
    """One token (B,) at ``positions`` (B, 1) through every layer: logits
    (B, 1, V) and a cache whose conv / ssm are new tensors and whose
    attention caches were written in place."""
    emb = embed_lookup(params["embed"], tok_col)[:, None]
    rope = rope_for(cfg, positions)
    pts = attn_points(cfg)
    h, convs, ssms = emb, [], []
    for i in range(cfg.num_layers):
        h, cs, ss = mamba2.apply_mamba_step(
            cfg, stacked(params["layers"], i), h, cache["conv"][i],
            cache["ssm"][i])
        convs.append(cs)
        ssms.append(ss)
        if i in pts:
            app = pts.index(i)
            h = _shared_decode(cfg, params["shared"], h, emb,
                               cache["attn_k"][app], cache["attn_v"][app],
                               positions, rope)
    logits = tied_unembed(params, rms_norm(h, params["final_norm"]))
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                    "attn_k": cache["attn_k"], "attn_v": cache["attn_v"],
                    "length": cache["length"] + 1}


def decode_step(cfg, params, cache, tokens):
    """Extend by tokens (B, T) at positions cache["length"] onwards, one
    token at a time; T > 1 returns ``checkpoints`` of the conv / SSM state
    after each token, (T, L, B, ...), each its own tensor.  The attention
    caches are written in place (they roll back by length alone)."""
    tokens = tokens.long()
    T = tokens.shape[1]
    base = cache["length"].long()
    cur = {k: v for k, v in cache.items() if k != "checkpoints"}
    logits, conv_ck, ssm_ck = [], [], []
    for t in range(T):
        lg, cur = _step_once(cfg, params, cur, tokens[:, t],
                             (base + t)[:, None])
        logits.append(lg)
        conv_ck.append(cur["conv"])
        ssm_ck.append(cur["ssm"])
    if T > 1:
        cur["checkpoints"] = {"conv": torch.stack(conv_ck),
                              "ssm": torch.stack(ssm_ck)}
    return torch.cat(logits, dim=1), cur
