"""The decoder of the Mellum2 layout: layers of two kinds, sliding-window
and full attention, over grouped key / value heads; yarn on the full
layers' rotary embeddings and plain rotary embeddings on the sliding ones;
every MLP a softmax top-k MoE of SwiGLU experts.

The sizes are read from the published keys that state the layout
(``layer_types``, ``sliding_window``, ``rope_parameters``,
``mlp_layer_types``), and a value the port has no mechanism for is
refused: a dense MLP layer, a rope type other than yarn on the full layers
and the plain one on the sliding ones, two rope thetas, a key of an
attention sink, gate or q / k norm, or a shared expert.

The plain reference (``logits``) is ``gqa``'s, layer by layer, with two
changes.  A sliding layer's query at position q sees the keys k with
q - k < ``sliding_window`` (transformers' convention: the window counts
the query's own position); a full layer's sees every k <= q.  A full
layer's rope takes yarn's inverse frequencies, computed here in closed
form as transformers' ``_compute_yarn_parameters`` does with ``truncate``
(the band between the dims that turn ``beta_fast`` and ``beta_slow`` times
within ``original_max_position_embeddings`` positions, a linear ramp over
the half-dims blending the plain frequencies with those divided by
``factor``), and its cos and sin are multiplied by ``attention_factor``.
It imports nothing of the program; ``precision="fp8"`` is ``gqa``'s
control.

The counts: a sliding layer's query sees at most ``sliding_window``
positions, so its flops and the K / V bytes it reads are capped there
(``token_flops``, ``attention_need``, ``window_need``); the windowed
launches have kernel names of their own (``WINDOW_KERNELS``).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from bench_port.lib import spec

GQA = spec.load_arch("gqa", Path(__file__).resolve().parents[2])

FULL, SLIDING = "full_attention", "sliding_attention"
# the device kernels of the sliding layers' calls, and of every call
WINDOW_KERNELS = ("paged_window_attention_kernel",
                  "paged_window_combine_kernel")
ATTENTION_KERNELS = GQA.ATTENTION_KERNELS + WINDOW_KERNELS

# published keys of mechanisms the port does not have: refused unless
# absent, false or zero
_ABSENT = ("attention_sink", "attention_sinks", "use_attention_sink",
           "sink_size", "attention_gate", "use_attention_gate", "gated_attn",
           "qk_norm", "use_qk_norm", "shared_expert_intermediate_size",
           "n_shared_experts", "num_shared_experts")
_YARN_KEYS = {"rope_type", "rope_theta", "factor",
              "original_max_position_embeddings", "beta_fast", "beta_slow",
              "attention_factor"}


def sizes(group: dict) -> Dict[str, object]:
    """The target's sizes, by ``gqa``'s names and those of the window and
    the yarn rope.  Refuses what the port does not model."""
    for key in _ABSENT:
        if group.get(key):
            raise ValueError(f"{key}={group[key]!r}: the port has no such "
                             f"mechanism")
    layers = int(group["num_hidden_layers"])
    types = list(group["layer_types"])
    if len(types) != layers or set(types) - {FULL, SLIDING}:
        raise ValueError(f"layer_types: {layers} of {FULL!r} / {SLIDING!r} "
                         f"expected, got {types}")
    mlps = list(group["mlp_layer_types"])
    if mlps != ["sparse"] * layers:
        raise ValueError(f"mlp_layer_types {mlps}: the port's layers are "
                         f"all sparse")
    if not group.get("use_sliding_window", True):
        raise ValueError("use_sliding_window false: the layout has windows")
    for key, want in (("hidden_act", "silu"), ("attention_bias", False),
                      ("norm_topk_prob", True)):
        if group.get(key, want) != want:
            raise ValueError(f"{key}={group[key]!r}: the port takes {want!r}")
    rp = group["rope_parameters"]
    if set(rp) != {FULL, SLIDING}:
        raise ValueError(f"rope_parameters {sorted(rp)}: one group for "
                         f"each kind of layer expected")
    full, slide = rp[FULL], rp[SLIDING]
    if slide.get("rope_type") != "default" or set(slide) - {"rope_type",
                                                            "rope_theta"}:
        raise ValueError(f"sliding layers' rope {slide}: the port takes the "
                         f"default rope")
    if full.get("rope_type") != "yarn" or set(full) - _YARN_KEYS:
        raise ValueError(f"full layers' rope {full}: the port takes yarn "
                         f"with {sorted(_YARN_KEYS)}")
    if float(full["rope_theta"]) != float(slide["rope_theta"]):
        raise ValueError("the port takes one rope theta for both kinds")
    factor = float(full["factor"])
    attn = float(full.get("attention_factor",
                          0.1 * math.log(factor) + 1.0))
    moe = dict(GQA.sizes({
        "num_hidden_layers": layers, "hidden_size": group["hidden_size"],
        "num_attention_heads": group["num_attention_heads"],
        "num_key_value_heads": group["num_key_value_heads"],
        "head_dim": group["head_dim"],
        "intermediate_size": group["moe_intermediate_size"],
        "vocab_size": group["vocab_size"],
        "num_local_experts": group["num_experts"],
        "num_experts_per_tok": group["num_experts_per_tok"],
        "rope_theta": slide["rope_theta"],
        "rms_norm_eps": group["rms_norm_eps"],
        "tie_word_embeddings": group["tie_word_embeddings"]}))
    return dict(moe, layer_types=types,
                window=int(group["sliding_window"]),
                yarn={"factor": factor,
                      "original_max": int(
                          full["original_max_position_embeddings"]),
                      "beta_fast": float(full.get("beta_fast", 32)),
                      "beta_slow": float(full.get("beta_slow", 1)),
                      "attention_factor": attn})


def port_config(name: str, group: dict, port: dict):
    """The port's ``WindowedConfig`` of the target."""
    from repro_torch.configs.base import WindowedConfig
    s = sizes(group)
    y = s["yarn"]
    return WindowedConfig(
        name=name, family=port["family"], num_layers=s["layers"],
        d_model=s["d_model"], num_heads=s["heads"],
        num_kv_heads=s["kv_heads"], head_dim=s["head_dim"], d_ff=s["d_ff"],
        vocab_size=s["vocab"], rope_theta=s["rope_theta"],
        max_position_embeddings=int(group["max_position_embeddings"]),
        tie_embeddings=s["tied"], qkv_bias=bool(port["qkv_bias"]),
        mlp_type="swiglu", moe_num_experts=s["experts"],
        moe_top_k=s["top_k"],
        moe_capacity_factor=float(port["moe_capacity_factor"]),
        layer_types=tuple(s["layer_types"]), sliding_window=s["window"],
        yarn_factor=y["factor"], yarn_original_max=y["original_max"],
        yarn_beta_fast=y["beta_fast"], yarn_beta_slow=y["beta_slow"],
        yarn_attention_factor=y["attention_factor"],
        dtype=group["torch_dtype"])


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------


def yarn_inv_freq(head_dim: int, theta: float, yarn: dict) -> torch.Tensor:
    """Yarn's inverse frequencies (head_dim / 2,) in float32."""
    def dim_at(rotations):
        return (head_dim * math.log(yarn["original_max"]
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(dim_at(yarn["beta_fast"])), 0)
    high = min(math.ceil(dim_at(yarn["beta_slow"])), head_dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                          / head_dim)
    extrap = 1.0 / pos_freqs
    interp = 1.0 / (yarn["factor"] * pos_freqs)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    return interp * ramp + extrap * (1 - ramp)


def plain_inv_freq(head_dim: int, theta: float) -> torch.Tensor:
    """The plain rope's inverse frequencies, as ``gqa._rope`` takes them."""
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                           / head_dim)


def _rope(x, pos, inv_freq, scale):
    """x (S, H, D) rotated at positions ``pos`` (S,), split-half, by the
    inverse frequencies ``inv_freq``, cos and sin times ``scale``."""
    D = x.shape[-1]
    ang = pos.float()[:, None] * inv_freq.to(x.device)[None, :]
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window, q_block=512):
    """Causal attention of one sequence, q (S, H, D), k / v (S, KH, D):
    query i sees keys j <= i, and with a ``window`` > 0 only those with
    i - j < window."""
    S, H, D = q.shape
    KH = k.shape[1]
    k = k.repeat_interleave(H // KH, dim=1)
    v = v.repeat_interleave(H // KH, dim=1)
    out = torch.empty_like(q)
    for a in range(0, S, q_block):
        b = min(a + q_block, S)
        lo = max(a - window + 1, 0) if window else 0
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[lo:b]) * D ** -0.5
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(lo, b, device=q.device)[None, :]
        mask = kj <= qi
        if window:
            mask = mask & (qi - kj < window)
        s = s.masked_fill(~mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                v[lo:b])
    return out


def logits(params: dict, m: Dict[str, object],
           sequences: Sequence[torch.Tensor], score_from: Sequence[int],
           *, precision: str = "fp32") -> List[torch.Tensor]:
    """fp32 logits of each sequence's positions ``score_from[i]`` onwards,
    as ``gqa.logits`` gives them, with each layer's window and rope."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, KH, hd = m["heads"], m["kv_heads"], m["head_dim"]
    theta, yarn = m["rope_theta"], m["yarn"]
    ropes = {SLIDING: (plain_inv_freq(hd, theta), 1.0),
             FULL: (yarn_inv_freq(hd, theta, yarn), yarn["attention_factor"])}
    lens = [len(s) for s in sequences]
    dev = params["embed"].device
    with torch.no_grad():
        toks = torch.cat([s.to(dev) for s in sequences])
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        h = params["embed"][toks].float()
        bounds = torch.tensor([0] + lens).cumsum(0).tolist()
        for i, kind in enumerate(m["layer_types"]):
            lp = {k: {n: w[i] for n, w in grp.items()}
                  for k, grp in params["layers"].items()}
            a = lp["attn"]
            x = GQA._rms(h, lp["ln1"]["scale"])
            q = torch.empty((len(h), H, hd), device=dev)
            k = torch.empty((len(h), KH, hd), device=dev)
            v = torch.empty_like(k)
            for r in GQA._rows(len(h)):
                for out, w, n in ((q, "wq", H), (k, "wk", KH), (v, "wv", KH)):
                    out[r] = GQA._lin(x[r], a[w].reshape(-1, n * hd),
                                      precision).view(-1, n, hd)
            inv_freq, scale = ropes[kind]
            q, k = _rope(q, pos, inv_freq, scale), _rope(k, pos, inv_freq,
                                                         scale)
            window = m["window"] if kind == SLIDING else 0
            o = torch.empty_like(q)
            for s0, s1 in zip(bounds[:-1], bounds[1:]):
                o[s0:s1] = _attention(q[s0:s1], k[s0:s1], v[s0:s1], window)
            wo = a["wo"].reshape(H * hd, -1)
            for r in GQA._rows(len(h)):
                h[r] += GQA._lin(o[r].reshape(-1, H * hd), wo, precision)
            x = GQA._rms(h, lp["ln2"]["scale"])
            for r in GQA._rows(len(h)):
                h[r] += GQA._moe(x[r], lp["moe"], m, precision)
        table = (params["embed"] if m["tied"]
                 else params["lm_head"]).float().t()
        out = []
        for (s0, s1), start in zip(zip(bounds[:-1], bounds[1:]), score_from):
            hs = GQA._rms(h[s0 + start:s1], params["final_norm"]["scale"])
            out.append(torch.cat([hs[r] @ table
                                  for r in GQA._rows(len(hs), 1024)])
                       if len(hs) else hs.new_zeros((0, m["vocab"])))
        return out


# ---------------------------------------------------------------------------
# counts: a token's flops, a paged-attention call's flops and bytes
# ---------------------------------------------------------------------------


def _kinds(cfg) -> Tuple[int, int]:
    """(full layers, sliding layers) of ``cfg``."""
    n_slide = sum(1 for t in cfg.layer_types if t == SLIDING)
    return cfg.num_layers - n_slide, n_slide


def window_need(cfg, rows: Iterable[Tuple[int, int]], elem_bytes: int
                ) -> Tuple[int, float, float]:
    """(sliding layers, flops, bytes) that one call of ``cfg`` on its real
    ``rows`` ((start, n) pairs) needs of each sliding layer's windowed
    launch: query t of a row sees min(start + t + 1, W) positions, and the
    row reads the K and V of the positions from its first query's window
    start to its last, min(start + n, n + W - 1), each once, plus its
    queries read and its outputs written."""
    W = cfg.sliding_window
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    flops = nbytes = 0.0
    for start, n in rows:
        # queries seeing fewer than W positions, then W each
        short = max(min(W - 1 - start, n), 0)
        seen = short * start + short * (short + 1) // 2 + (n - short) * W
        flops += 4.0 * H * hd * seen
        nbytes += elem_bytes * hd * (2 * KH * min(start + n, n + W - 1)
                                     + 2 * H * n)
    return _kinds(cfg)[1], flops, nbytes


def attention_need(cfg, rows: Iterable[Tuple[int, int]], elem_bytes: int
                   ) -> List[Tuple[int, float, float]]:
    """Two groups: the full layers, each needing ``gqa``'s count of the
    call, and the sliding layers (``window_need``)."""
    rows = list(rows)
    f, b = GQA.paged_attention_need(
        rows, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, elem_bytes=elem_bytes)
    return [(_kinds(cfg)[0], f, b), window_need(cfg, rows, elem_bytes)]


def token_flops(m: dict, ctx: int) -> float:
    """Useful flops of one target token that sees ``ctx`` positions: 2 per
    weight it multiplies by, QK^T + PV over ``ctx`` positions in a full
    layer and over at most the window in a sliding one."""
    seen = sum(min(ctx, m["window"]) if t == SLIDING else ctx
               for t in m["layer_types"])
    return (2.0 * GQA.matmul_params_per_token(m)
            + 4.0 * m["heads"] * m["head_dim"] * seen)
