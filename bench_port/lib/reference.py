"""The plain reference: the decoder's forward pass in plain PyTorch, in
float32 with TF32 off, over whole sequences, with no cache, no batching and
no kernel.

It imports nothing of the program.  It reads the weights the benchmark
made (the parameter tree, by its key names) and recomputes everything the
program derives from them.  What it follows: RMSNorm (eps 1e-6) before
attention and the MLP, q / k / v projections with their biases, rotary
embeddings in the split-half convention, causal attention with grouped
key / value heads scaled by head_dim ** -0.5, a SwiGLU MLP or, in a MoE
layer, a softmax router whose top-k gates are renormalised, every routed
expert applied (the published models drop no token), then the final norm
and the (tied or separate) unembedding.

``precision="fp8"`` is the control: every matrix product of the layers
takes its operands through float8 e4m3 (per-token activation scales,
per-output-channel weight scales), the step a later change would be
tempted by; the embedding, router and unembedding stay as served.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

F8_MAX = 448.0   # the largest finite float8 e4m3 value


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3, scaled along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _lin(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (N, in) fp32 @ w (in, out) in ``precision``."""
    w = w.float()
    if precision == "fp8":
        x, w = _q8(x, -1), _q8(w, 0)
    return x @ w


def _rms(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x, pos, theta):
    """x (S, H, D) rotated at positions ``pos`` (S,), split-half."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = pos.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, q_block=512):
    """Causal attention of one sequence: q (S, H, D), k / v (S, KH, D);
    query head h reads key / value head h // (H // KH)."""
    S, H, D = q.shape
    KH = k.shape[1]
    k = k.repeat_interleave(H // KH, dim=1)
    v = v.repeat_interleave(H // KH, dim=1)
    out = torch.empty_like(q)
    for a in range(0, S, q_block):
        b = min(a + q_block, S)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * D ** -0.5
        mask = (torch.arange(b, device=q.device)[None, :]
                <= torch.arange(a, b, device=q.device)[:, None])
        s = s.masked_fill(~mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:b])
    return out


def _swiglu(x, wg, wu, wd, precision):
    return _lin(torch.nn.functional.silu(_lin(x, wg, precision))
                * _lin(x, wu, precision), wd, precision)


def _moe(x, p, m, precision):
    """Every token through its top-k experts, gate-weighted; no drops."""
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, m["top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m["experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            ye = _swiglu(x[tok], p["wg"][e], p["wu"][e], p["wd"][e],
                         precision)
            y.index_add_(0, tok, ye * gates[tok, slot][:, None])
    return y


def _rows(n, block=4096):
    return [slice(a, min(a + block, n)) for a in range(0, n, block)]


def logits(params: dict, m: Dict[str, object],
           sequences: Sequence[torch.Tensor], score_from: Sequence[int],
           *, precision: str = "fp32") -> List[torch.Tensor]:
    """fp32 logits of each sequence's positions ``score_from[i]`` onwards:
    a list of (len_i - score_from[i], V).  Layer by layer over all the
    sequences, each layer's weights in fp32 only while it runs, so a
    full-width model fits beside its bf16 weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, KH, hd = m["heads"], m["kv_heads"], m["head_dim"]
    lens = [len(s) for s in sequences]
    dev = params["embed"].device
    with torch.no_grad():
        toks = torch.cat([s.to(dev) for s in sequences])
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        h = params["embed"][toks].float()
        bounds = torch.tensor([0] + lens).cumsum(0).tolist()
        for i in range(m["layers"]):
            lp = {k: {n: w[i] for n, w in grp.items()}
                  for k, grp in params["layers"].items()}
            a = lp["attn"]
            x = _rms(h, lp["ln1"]["scale"])
            q = torch.empty((len(h), H, hd), device=dev)
            k = torch.empty((len(h), KH, hd), device=dev)
            v = torch.empty_like(k)
            for r in _rows(len(h)):
                for out, w, b, n in ((q, "wq", "bq", H), (k, "wk", "bk", KH),
                                     (v, "wv", "bv", KH)):
                    out[r] = _lin(x[r], a[w].reshape(-1, n * hd),
                                  precision).view(-1, n, hd)
                    if b in a:
                        out[r] += a[b].float()
            q, k = _rope(q, pos, m["rope_theta"]), _rope(k, pos, m["rope_theta"])
            o = torch.empty_like(q)
            for s0, s1 in zip(bounds[:-1], bounds[1:]):
                o[s0:s1] = _attention(q[s0:s1], k[s0:s1], v[s0:s1])
            wo = a["wo"].reshape(H * hd, -1)
            for r in _rows(len(h)):
                h[r] += _lin(o[r].reshape(-1, H * hd), wo, precision)
            x = _rms(h, lp["ln2"]["scale"])
            for r in _rows(len(h)):
                if m["experts"]:
                    h[r] += _moe(x[r], lp["moe"], m, precision)
                else:
                    f = lp["mlp"]
                    h[r] += _swiglu(x[r], f["wg"], f["wu"], f["wd"],
                                    precision)
        table = (params["embed"] if m["tied"]
                 else params["lm_head"]).float().t()
        out = []
        for (s0, s1), start in zip(zip(bounds[:-1], bounds[1:]), score_from):
            hs = _rms(h[s0 + start:s1], params["final_norm"]["scale"])
            out.append(torch.cat([hs[r] @ table
                                  for r in _rows(len(hs), 1024)])
                       if len(hs) else hs.new_zeros((0, m["vocab"])))
        return out
