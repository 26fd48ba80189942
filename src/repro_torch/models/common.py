"""Building blocks of the dense paged decoder: initialisers, norms, RoPE,
the attention projections and the MLPs.

Weight layouts are the reference's, so bridged weights need no reshape:
``wq (d, H, hd)``, ``wk/wv (d, KH, hd)``, ``wo (H, hd, d)``, ``bq (H, hd)``,
MLP ``wg/wu (d, f)``, ``wd (f, d)``, norm ``scale (d,)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initialisation (same distributions as the reference; not the same bits)
# ---------------------------------------------------------------------------


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


def _proj(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


def qkv_project(cfg, p, x, rope):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KH,hd) with bias, qk-norm and
    RoPE (``rope_angles`` of the positions, or None) applied."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
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


def apply_mlp(cfg, p, x):
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if cfg.mlp_type == "geglu":
        return (F.gelu(x @ p["wg"], approximate="tanh")
                * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]
