"""Whisper-style encoder-decoder, the ``encdec`` family.

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``batch["enc_emb"] (B, S_enc, d)``.  The
encoder is bidirectional self-attention; the decoder has causal
self-attention plus cross-attention over the encoder output.  LayerNorm
with bias, the GELU MLP with biases, learned positions (``enc_pos``,
``dec_pos``), no RoPE.  Layers are stacked on a leading axis.

Every full-sequence attention — the encoder, the decoder's self- and
cross-attention in ``forward`` and ``prefill`` — runs
``blockwise_attention`` (the flash kernel on the card, non-causal with
Sq != Sk for the cross-attention); ``decode_step`` uses the plain
dense-cache attention, with the cross-attention seeing every encoder
position.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import device as _device
from .common import (Spec, apply_mlp, attn_output, blockwise_attention,
                     cache_write, decode_attention, head_proj, layer_norm,
                     model_dtype, qkv_project, stacked, tied_unembed)
from .transformer import attn_layout, mlp_layout

Params = Dict[str, Any]


def _ln_layout(cfg, lead=()):
    d = cfg.d_model
    return {"scale": Spec(lead + (d,), "ones"),
            "bias": Spec(lead + (d,), "zeros")}


def _ln(x, p):
    return layer_norm(x, p["scale"], p["bias"])


def param_layout(cfg) -> Params:
    d, P = cfg.d_model, cfg.max_position_embeddings
    el, dl = (cfg.enc_layers,), (cfg.dec_layers,)
    return {
        "embed": Spec((cfg.vocab_size, d), "embed"),
        "enc_pos": Spec((P, d), "embed"),
        "dec_pos": Spec((P, d), "embed"),
        "enc_layers": {"attn": attn_layout(cfg, el),
                       "mlp": mlp_layout(cfg, el),
                       "ln1": _ln_layout(cfg, el), "ln2": _ln_layout(cfg, el)},
        "dec_layers": {"self_attn": attn_layout(cfg, dl),
                       "cross_attn": attn_layout(cfg, dl, cross=True),
                       "mlp": mlp_layout(cfg, dl),
                       "ln1": _ln_layout(cfg, dl), "ln2": _ln_layout(cfg, dl),
                       "ln3": _ln_layout(cfg, dl)},
        "enc_norm": _ln_layout(cfg),
        "dec_norm": _ln_layout(cfg),
    }


def encode(cfg, params, enc_emb):
    """Frame embeddings (B, S_enc, d) -> encoder output (B, S_enc, d)."""
    S = enc_emb.shape[1]
    h = enc_emb.to(model_dtype(cfg)) + params["enc_pos"][:S][None]
    for i in range(cfg.enc_layers):
        layer = stacked(params["enc_layers"], i)
        x = _ln(h, layer["ln1"])
        q, k, v = qkv_project(cfg, layer["attn"], x, None)
        h = h + attn_output(layer["attn"],
                            blockwise_attention(q, k, v, causal=False))
        h = h + apply_mlp(cfg, layer["mlp"], _ln(h, layer["ln2"]))
    return _ln(h, params["enc_norm"])


def _cross_kv(layer, enc_out):
    return (head_proj(enc_out, layer["cross_attn"]["wk"]),
            head_proj(enc_out, layer["cross_attn"]["wv"]))


def _dec_layer_full(cfg, layer, h, enc_out):
    """One decoder layer over the whole sequence: (h, k, v, cross k,
    cross v)."""
    x = _ln(h, layer["ln1"])
    q, k, v = qkv_project(cfg, layer["self_attn"], x, None)
    h = h + attn_output(layer["self_attn"],
                        blockwise_attention(q, k, v, causal=True))
    qc = head_proj(_ln(h, layer["ln2"]), layer["cross_attn"]["wq"])
    kc, vc = _cross_kv(layer, enc_out)
    h = h + attn_output(layer["cross_attn"],
                        blockwise_attention(qc, kc, vc, causal=False))
    return h + apply_mlp(cfg, layer["mlp"], _ln(h, layer["ln3"])), k, v, kc, vc


def _dec_inputs(params, tokens, positions):
    return params["embed"][tokens] + params["dec_pos"][positions]


def forward(cfg, params, batch):
    """batch["enc_emb"] (B, S_enc, d), batch["tokens"] (B, S) -> the
    decoder's final hidden states (B, S, d)."""
    enc_out = encode(cfg, params, batch["enc_emb"])
    tokens = batch["tokens"].long()
    h = _dec_inputs(params, tokens,
                    torch.arange(tokens.shape[1], device=tokens.device)[None])
    for i in range(cfg.dec_layers):
        h = _dec_layer_full(cfg, stacked(params["dec_layers"], i), h,
                            enc_out)[0]
    return _ln(h, params["dec_norm"])


def init_cache(cfg, batch_size: int, max_len: int, enc_len=None, *,
               device="cuda"):
    """Self-attention k / v (L_dec, B, max_len, KH, hd), cross-attention
    cross_k / cross_v (L_dec, B, enc_len, KH, hd), ``enc_len`` and
    ``length``."""
    dev = _device.resolve(device)
    KH, hd, L = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.dec_layers
    enc_len = enc_len or cfg.enc_context

    def zeros(shape, dtype=model_dtype(cfg)):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return {"k": zeros((L, batch_size, max_len, KH, hd)),
            "v": zeros((L, batch_size, max_len, KH, hd)),
            "cross_k": zeros((L, batch_size, enc_len, KH, hd)),
            "cross_v": zeros((L, batch_size, enc_len, KH, hd)),
            "enc_len": zeros((batch_size,), torch.int32),
            "length": zeros((batch_size,), torch.int32)}


def prefill(cfg, params, batch, max_len: int):
    """Encode batch["enc_emb"] and run the prompt batch["tokens"] (B, S):
    the last position's logits (B, 1, V) fp32 and a new cache."""
    enc_out = encode(cfg, params, batch["enc_emb"])
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prefill: {S} prompt positions exceed the cache's "
                         f"{max_len}")
    cache = init_cache(cfg, B, max_len, enc_out.shape[1],
                       device=enc_out.device)
    h = _dec_inputs(params, tokens,
                    torch.arange(S, device=tokens.device)[None])
    for i in range(cfg.dec_layers):
        h, k, v, kc, vc = _dec_layer_full(
            cfg, stacked(params["dec_layers"], i), h, enc_out)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["cross_k"][i] = kc
        cache["cross_v"][i] = vc
    cache["enc_len"].fill_(enc_out.shape[1])
    cache["length"].fill_(S)
    return tied_unembed(params, _ln(h[:, -1:], params["dec_norm"])), cache


def decode_step(cfg, params, cache, tokens):
    """Extend by tokens (B, T) at positions cache["length"] onwards; the
    self-attention k / v are written in place.  Returns (logits (B, T, V)
    fp32, the cache with ``length`` + T)."""
    tokens = tokens.long()
    B, T = tokens.shape
    positions = (cache["length"].long()[:, None]
                 + torch.arange(T, device=tokens.device)[None, :])
    h = _dec_inputs(params, tokens, positions)
    # every query sees every encoder position
    enc_positions = (cache["enc_len"].long() - 1)[:, None].expand(B, T)
    for i in range(cfg.dec_layers):
        layer = stacked(params["dec_layers"], i)
        x = _ln(h, layer["ln1"])
        q, k, v = qkv_project(cfg, layer["self_attn"], x, None)
        cache_write(cache["k"][i], k, positions[:, 0])
        cache_write(cache["v"][i], v, positions[:, 0])
        h = h + attn_output(layer["self_attn"], decode_attention(
            q, cache["k"][i], cache["v"][i], positions))
        qc = head_proj(_ln(h, layer["ln2"]), layer["cross_attn"]["wq"])
        h = h + attn_output(layer["cross_attn"], decode_attention(
            qc, cache["cross_k"][i], cache["cross_v"][i], enc_positions))
        h = h + apply_mlp(cfg, layer["mlp"], _ln(h, layer["ln3"]))
    h = _ln(h, params["dec_norm"])
    return tied_unembed(params, h), {**cache, "length": cache["length"] + T}
