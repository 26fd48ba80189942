"""Building blocks of the dense decoder: initialisers, norms, RoPE, the
attention projections, full-sequence and dense-cache attention, and the
MLPs.

Weight layouts are the reference's, so bridged weights need no reshape:
``wq (d, H, hd)``, ``wk/wv (d, KH, hd)``, ``wo (H, hd, d)``, ``bq (H, hd)``,
MLP ``wg/wu (d, f)``, ``wd (f, d)``, norm ``scale (d,)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.ref import NEG_INF

# ---------------------------------------------------------------------------
# Initialisation (same distributions as the reference; not the same bits)
# ---------------------------------------------------------------------------


class Spec(NamedTuple):
    """One parameter: its shape, initialiser, fan-in and dtype (None: the
    model's)."""
    shape: Tuple[int, ...]
    init: str    # dense | embed | normal | ones | zeros | a_log | dt_bias
    fan_in: int = 0
    dtype: Optional[str] = None


def dense_init_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """Truncated normal on [-2, 2], scaled by 1/sqrt(fan_in), in place."""
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t.copy_(tmp.mul_(1.0 / math.sqrt(max(fan_in, 1))))
    return t


def embed_init_(t: torch.Tensor, gen: torch.Generator):
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    tmp.normal_(0.0, 1.0, generator=gen)
    t.copy_(tmp.mul_(0.02))
    return t


def map_layout(fn, layout):
    """``fn`` applied to every :class:`Spec` of a nested dict."""
    if isinstance(layout, Spec):
        return fn(layout)
    return {k: map_layout(fn, v) for k, v in layout.items()}


def leaves(tree):
    """The leaves of a nested dict (tensors, or a layout's :class:`Spec`),
    in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def leaf_dtype(cfg, s: Spec) -> torch.dtype:
    return getattr(torch, s.dtype or cfg.dtype)


def specs_of(cfg, layout):
    """A layout as meta tensors: shapes and dtypes, no storage."""
    return map_layout(lambda s: torch.empty(
        s.shape, dtype=leaf_dtype(cfg, s), device="meta"), layout)


def init_layout(cfg, layout, dev: torch.device, seed: int):
    """Seeded random weights of a layout on ``dev``, drawn from one
    ``torch.Generator``: the reference's distributions — truncated-normal
    fan-in ``dense``, N(0, 0.02) ``embed``, N(0, 1/fan_in) ``normal`` (the
    SSM conv), unit / zero norms and biases, and an SSM layer's
    ``A_log = log(linspace(1, 16, H))`` and ``dt_bias``, the inverse
    softplus of a log-uniform draw in [1e-3, 1e-1]."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(s: Spec):
        dt = leaf_dtype(cfg, s)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "a_log":
            a = torch.log(torch.linspace(1.0, 16.0, s.shape[-1],
                                         device=dev))
            return a.expand(s.shape).to(dt).clone()
        t = torch.empty(s.shape, dtype=dt, device=dev)
        if s.init == "embed":
            return embed_init_(t, gen)
        if s.init == "dense":
            return dense_init_(t, s.fan_in, gen)
        tmp = torch.empty(s.shape, dtype=torch.float32, device=dev)
        if s.init == "normal":
            tmp.normal_(0.0, 1.0, generator=gen).mul_(s.fan_in ** -0.5)
        elif s.init == "dt_bias":
            tmp.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
            tmp = torch.log(torch.expm1(torch.exp(tmp)))
        else:
            raise ValueError(f"unknown initialiser {s.init!r}")
        return t.copy_(tmp)

    return map_layout(make, layout)


def stacked(params, i: int):
    """Entry ``i`` of a tree stacked on a leading axis, as views."""
    if isinstance(params, dict):
        return {k: stacked(v, i) for k, v in params.items()}
    return params[i]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, *, eps: float = 1e-6, offset: bool = False):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    w = (1.0 + scale.float()) if offset else scale.float()
    return (y * w).to(dt)


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(cfg, x, p):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"], offset=cfg.rmsnorm_offset)


# ---------------------------------------------------------------------------
# Rotary position embedding (split-half convention)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions, head_dim: int, theta: float):
    """(cos, sin), each (B, S, 1, head_dim/2) fp32, for positions (B, S) —
    computed once per step and shared by every layer's q and k."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, rope):
    """x: (B, S, H, D) rotated by ``rope_angles``' (cos, sin), in x's
    dtype."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections and MLP
# ---------------------------------------------------------------------------


def head_proj(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


def qkv_project(cfg, p, x, rope):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KH,hd) with bias, qk-norm and
    RoPE (``rope_angles`` of the positions, or None) applied."""
    q, k, v = (head_proj(x, p["wq"]), head_proj(x, p["wk"]),
               head_proj(x, p["wv"]))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope is not None:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    return q, k, v


def attn_output(p, o):
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    H, hd, d = p["wo"].shape
    return o.reshape(*o.shape[:2], H * hd) @ p["wo"].reshape(H * hd, d)


# ---------------------------------------------------------------------------
# Attention over full sequences and dense caches
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, causal: bool, prefix_len: int = 0):
    """Full-sequence attention: q (B, Sq, H, D), k/v (B, Sk, KH, D) ->
    (B, Sq, H, D) in q's dtype, the running softmax in fp32.

    ``prefix_len`` marks a bidirectional prefix (keys before it are visible
    to every query) under ``causal``.  On the card this is the flash kernel;
    on the CPU its plain version."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, q_positions):
    """Attention of T new positions against a (partially filled) cache.

    q: (B, T, H, D); caches (B, S, KH, D) with the new K/V already written;
    q_positions: (B, T) absolute positions.  Each query attends to every
    cache slot at or before its own position: decode (T=1) and speculative
    verify (T=gamma+1).  Scores in fp32; the unnormalised probabilities are
    rounded to the cache dtype before the product with V, as the reference
    does."""
    B, T, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, T, KH, G, D) * (D ** -0.5)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k_cache.float())
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= q_positions[:, :, None])                          # (B, T, S)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                            # (B,KH,G,T)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, D).to(q.dtype)


def cache_write(cache, new, start):
    """Write ``new`` (B, T, KH, hd) into ``cache`` (B, S, KH, hd) at
    positions start[b] .. start[b] + T - 1, IN PLACE (``index_put_``; the
    reference builds a new array).  Every position must lie inside the
    cache.  Returns ``cache``."""
    B, T = new.shape[:2]
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    pos = start.long()[:, None] + torch.arange(T, device=cache.device)
    return cache.index_put_((rows, pos), new.to(cache.dtype))


def tied_unembed(params, h):
    """h (B, T, d) @ embed.T -> fp32 logits (B, T, V), the product in the
    model dtype: the unembedding of the ssm, hybrid and encoder-decoder
    families, which always reuse the embedding (the reference's
    ``_unembed_table``)."""
    return (h @ params["embed"].t()).float()


def apply_mlp(cfg, p, x):
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if cfg.mlp_type == "geglu":
        return (F.gelu(x @ p["wg"], approximate="tanh")
                * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]
