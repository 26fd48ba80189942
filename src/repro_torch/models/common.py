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
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed.sharding import (align, attention_local_map,
                                    gather_weights, reduce_partial,
                                    replicate_dim, shard_decode_scores)
from ..kernels.flash_attention import flash_attention
from ..kernels.ref import NEG_INF, flash_attention_ref

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
    """Entry ``i`` of a tree stacked on a leading axis, as views (a DTensor
    leaf gathered over the data axes: :func:`gather_weights`)."""
    if isinstance(params, dict):
        return {k: stacked(v, i) for k, v in params.items()}
    return gather_weights(params[i])


def _save_matmuls(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_matmuls)


def maybe_remat(cfg, fn, *, dots: bool = True):
    """``fn`` under the reference's ``cfg.remat``: ``"full"`` recomputes
    the whole call in the backward (``torch.utils.checkpoint``,
    non-reentrant); ``"dots"`` saves the outputs of the 2-D products
    (``aten.mm`` / ``aten.addmm``) and recomputes everything else.

    ``"dots"`` is the counterpart of XLA's
    ``checkpoint_dots_with_no_batch_dims``, which decides per dot on its
    dimension numbers; here the decision is per aten op, so a product
    PyTorch runs as ``bmm`` (decode attention's einsums, the MoE experts)
    is recomputed, and the flash kernel (one custom op) is recomputed
    whole, where XLA would see its inner dots.  Families whose reference
    remats only under ``"full"`` pass ``dots=False``."""
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots" and dots:
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_context)
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn


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


def yarn_frequencies(head_dim: int, theta: float, factor: float,
                     original_max: int, beta_fast: float, beta_slow: float,
                     device=None):
    """Yarn's inverse frequencies (transformers' ``_compute_yarn_parameters``
    with ``truncate``): the dims that turn more than ``beta_fast`` times
    within ``original_max`` positions keep the plain frequency, those that
    turn fewer than ``beta_slow`` times take it divided by ``factor``, and a
    linear ramp over the half-dims blends the band between."""
    def dim_at(rotations):
        return (head_dim * math.log(original_max / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(dim_at(beta_fast)), 0)
    high = min(math.ceil(dim_at(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    extrap = rope_frequencies(head_dim, theta, device=device)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0.0, 1.0)
    return extrap / factor * ramp + extrap * (1.0 - ramp)


def rope_angles(positions, head_dim: int, theta: float, yarn=None):
    """(cos, sin), each (B, S, 1, head_dim/2) fp32, for positions (B, S) —
    computed once per step and shared by every layer's q and k.  ``yarn``,
    a config with ``yarn_factor`` > 0, takes its frequencies
    (:func:`yarn_frequencies`) and scales cos and sin by its
    ``yarn_attention_factor``."""
    if yarn is None:
        freqs = rope_frequencies(head_dim, theta, device=positions.device)
    else:
        freqs = yarn_frequencies(head_dim, theta, yarn.yarn_factor,
                                 yarn.yarn_original_max, yarn.yarn_beta_fast,
                                 yarn.yarn_beta_slow, device=positions.device)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    if yarn is None:
        return torch.cos(angles), torch.sin(angles)
    scale = yarn.yarn_attention_factor
    return torch.cos(angles) * scale, torch.sin(angles) * scale


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
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd).  A DTensor weight
    sharded on hd (its heads do not divide the model axis) is gathered
    there first: flattening (H, hd) may shard only H."""
    d, H, hd = w.shape
    w = replicate_dim(w, 2)
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
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d).  On DTensors the
    heads' partial sums are reduced here (a row-parallel product), so the
    residual stream stays whole over ``model``."""
    H, hd, d = p["wo"].shape
    # as in head_proj, (H, hd) is flattened with at most H sharded
    o, wo = replicate_dim(o, 3), replicate_dim(p["wo"], 1)
    return reduce_partial(o.reshape(*o.shape[:2], H * hd)
                          @ wo.reshape(H * hd, d))


# ---------------------------------------------------------------------------
# Attention over full sequences and dense caches
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, causal: bool, prefix_len: int = 0,
                        window: int = 0):
    """Full-sequence attention: q (B, Sq, H, D), k/v (B, Sk, KH, D) ->
    (B, Sq, H, D) in q's dtype, the running softmax in fp32.

    ``prefix_len`` marks a bidirectional prefix (keys before it are visible
    to every query) under ``causal``.  On the card this is the flash kernel;
    on the CPU its plain version.  DTensors go through ``local_map``: each
    rank attends over its local batch rows and heads with the whole
    sequence (a sequence-sharded q / k / v is all-gathered first).

    A causal ``window`` > 0 lets query i see keys i - window + 1 .. i.  Only
    the plain version takes one: the flash kernel has no window, so on the
    card a windowed call raises (the paged path serves windowed layers)."""
    if window:
        if q.device.type != "cpu" or not causal:
            raise NotImplementedError(
                f"blockwise_attention: a window of {window} runs only in the "
                f"plain causal version on the CPU (no windowed flash kernel);"
                f" serve windowed layers through the paged path")
        return flash_attention_ref(q, k, v, causal=True,
                                   prefix_len=prefix_len, window=window)
    return attention_local_map(_local_attention, q, k, v, causal=causal,
                               prefix_len=prefix_len)


def _local_attention(q, k, v, *, causal: bool, prefix_len: int):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, q_positions, window: int = 0):
    """Attention of T new positions against a (partially filled) cache.

    q: (B, T, H, D); caches (B, S, KH, D) with the new K/V already written;
    q_positions: (B, T) absolute positions.  Each query attends to every
    cache slot at or before its own position (and, with a ``window`` > 0,
    after position - window): decode (T=1) and speculative verify
    (T=gamma+1).  Scores in fp32; the unnormalised probabilities are
    rounded to the cache dtype before the product with V, as the reference
    does."""
    B, T, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    # a DTensor q's heads gathered: the products flatten (batch, heads)
    qg = replicate_dim(q, 2).reshape(B, T, KH, G, D) * (D ** -0.5)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k_cache.float())
    s = shard_decode_scores(s)
    slots = torch.arange(S, device=q.device)[None, None, :]
    mask = slots <= q_positions[:, :, None]                      # (B, T, S)
    if window:
        mask = mask & (slots > q_positions[:, :, None] - window)
    s = torch.where(align(mask[:, None, None], s), s,
                    torch.full_like(s, NEG_INF))
    p = shard_decode_scores(torch.exp(s - s.amax(dim=-1, keepdim=True)))
    l = p.sum(dim=-1)                                            # (B,KH,G,T)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, D).to(q.dtype)


def tied_unembed(params, h):
    """h (B, T, d) @ embed.T -> fp32 logits (B, T, V), the product in the
    model dtype: the unembedding of the ssm, hybrid and encoder-decoder
    families, which always reuse the embedding (the reference's
    ``_unembed_table``)."""
    return (h @ gather_weights(params["embed"]).t()).float()


def apply_mlp(cfg, p, x):
    """The MLP; on DTensors its row-parallel output is reduced, as
    :func:`attn_output`'s."""
    if cfg.mlp_type == "swiglu":
        return reduce_partial((F.silu(x @ p["wg"]) * (x @ p["wu"]))
                              @ p["wd"])
    if cfg.mlp_type == "geglu":
        return reduce_partial((F.gelu(x @ p["wg"], approximate="tanh")
                               * (x @ p["wu"])) @ p["wd"])
    return reduce_partial(F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
                          @ p["w2"]) + p["b2"]
