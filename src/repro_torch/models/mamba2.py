"""Mamba2 (state-space duality / SSD) blocks, the ``ssm`` family.

The chunked SSD algorithm of "Transformers are SSMs" (arXiv:2405.21060): a
within-chunk quadratic (attention-like) term plus an inter-chunk recurrence
on the (H, P, N) states.  Decode runs the O(1)-state recurrence

    h <- h * exp(dt*A) + dt * (B ⊗ x);   y = C · h + D * x

and a multi-token ``decode_step`` (speculative verify) keeps the conv and
SSM state after every token (``checkpoints``), so the speculative step can
roll back to the acceptance point — the SSM analogue of KV truncation.

Layer parameters are stacked on a leading ``L`` axis (the reference's
``scan_layers`` layout).  ``A_log``, ``D`` and ``dt_bias`` are fp32 in every
config; the state is fp32; the conv output is rounded to the model dtype
before the fp32 recurrence and ``y`` before the gated norm, where the
reference rounds them.  Everything here is plain PyTorch: the reference has
no Pallas kernel for the scan.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .. import device as _device
from .common import Spec, model_dtype, rms_norm, stacked, tied_unembed

Params = Dict[str, Any]


def _dims(cfg):
    """(d_inner, heads, groups, state, conv channels) of a mamba layer."""
    d_in, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    return d_in, cfg.ssm_nheads, G, N, d_in + 2 * G * N


def mamba_layer_layout(cfg, lead=()):
    """One mamba layer (the reference's ``init_mamba_layer``); ``in_proj``
    emits [z (d_in), x (d_in), B (G*N), C (G*N), dt (H)]."""
    d = cfg.d_model
    d_in, H, G, N, conv_dim = _dims(cfg)
    K = cfg.ssm_conv
    return {
        "in_proj": Spec(lead + (d, 2 * d_in + 2 * G * N + H), "dense", d),
        "conv_w": Spec(lead + (K, conv_dim), "normal", K),
        "conv_b": Spec(lead + (conv_dim,), "zeros"),
        "A_log": Spec(lead + (H,), "a_log", dtype="float32"),
        "D": Spec(lead + (H,), "ones", dtype="float32"),
        "dt_bias": Spec(lead + (H,), "dt_bias", dtype="float32"),
        "norm": Spec(lead + (d_in,), "ones"),
        "out_proj": Spec(lead + (d_in, d), "dense", d_in),
        "ln": Spec(lead + (d,), "ones"),
    }


def param_layout(cfg) -> Params:
    d = cfg.d_model
    return {"embed": Spec((cfg.vocab_size, d), "embed"),
            "layers": mamba_layer_layout(cfg, (cfg.num_layers,)),
            "final_norm": Spec((d,), "ones")}


# ---------------------------------------------------------------------------
# Projections shared by the full and step paths
# ---------------------------------------------------------------------------


def _split_proj(cfg, layer, u):
    """u (..., d) -> z (d_in), xBC (d_in + 2GN), dt_raw (H), by slices
    (``jnp.split`` takes indices, ``torch.split`` sizes)."""
    d_in, _, G, N, _ = _dims(cfg)
    zxbcdt = u @ layer["in_proj"]
    cut = 2 * d_in + 2 * G * N
    return zxbcdt[..., :d_in], zxbcdt[..., d_in:cut], zxbcdt[..., cut:]


def _split_xbc(cfg, xBC):
    d_in, _, G, N, _ = _dims(cfg)
    return (xBC[..., :d_in], xBC[..., d_in:d_in + G * N],
            xBC[..., d_in + G * N:])


def _conv_full(layer, xBC):
    """Causal depthwise conv over (B, L, conv_dim), in fp32, then SiLU,
    rounded to xBC's dtype."""
    w = layer["conv_w"].float()                 # (K, conv_dim)
    K, L = w.shape[0], xBC.shape[1]
    pads = F.pad(xBC.float(), (0, 0, K - 1, 0))
    out = pads[:, 0:L] * w[0]
    for i in range(1, K):
        out = out + pads[:, i:i + L] * w[i]
    return F.silu(out + layer["conv_b"].float()).to(xBC.dtype)


def _segsum(x):
    """Stable segment sum: x (..., T) -> (..., T, T) with [i, j] =
    sum(x[j+1 .. i]) for j <= i and -inf above the diagonal."""
    T = x.shape[-1]
    xx = x.unsqueeze(-1).expand(*x.shape, T)          # [i, j] = x[i]
    ones = torch.ones((T, T), dtype=torch.bool, device=x.device)
    xx = torch.where(torch.tril(ones, -1), xx, torch.zeros_like(xx))
    seg = torch.cumsum(xx, dim=-2)
    return torch.where(torch.tril(ones), seg,
                       torch.full_like(seg, float("-inf")))


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """Chunked SSD scan.

    x (b, l, h, p), dt (b, l, h), A (h,) negative, Bm / Cm (b, l, g, n);
    returns y (b, l, h, p) fp32 and the final state (b, h, p, n) fp32.  A
    length above ``chunk`` that is not a multiple of it is padded at the
    tail to one with dt = 0 and x = B = C = 0, which leaves the state
    unchanged (exp(0 · A) = 1 and no input), and the padded rows of y are
    dropped; the reference asserts instead (ROADMAP C9).  Lengths the
    reference accepts take no padding.  The reference's 4-operand einsums
    are written as pairwise products in a fixed order, so the
    intermediates' sizes do not depend on a contraction planner."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, l)
    pad = -l % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // Q
    rep = h // g

    xc = x.reshape(b, nc, Q, h, p).float()
    dtc = dt.reshape(b, nc, Q, h)
    # head h reads group h // rep
    Bc = Bm.reshape(b, nc, Q, g, n).repeat_interleave(rep, dim=3).float()
    Cc = Cm.reshape(b, nc, Q, g, n).repeat_interleave(rep, dim=3).float()

    dA = dtc * A                                   # (b, nc, Q, h)
    dA_cs = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]

    # (1) intra-chunk (quadratic) term: (C·B) * L, then with x*dt
    Lm = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))          # (b,c,h,Q,Q)
    cb = torch.einsum("bcqhn,bcshn->bchqs", Cc, Bc) * Lm
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", cb, xdt)

    # (2) per-chunk output states: B scaled by the decay to the chunk's end
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)     # (b,c,Q,h)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Bc * decay_states[..., None], xdt)

    # (3) inter-chunk recurrence, sequential over the chunks
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])               # (b, c, h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                  # (b,c,h,p,n)

    # (4) inter-chunk contribution: C · state, scaled by the decay so far
    y_off = (torch.einsum("bcqhn,bchpn->bcqhp", Cc, prev_states)
             * torch.exp(dA_cs)[..., None])
    return (y_diag + y_off).reshape(b, l + pad, h, p)[:, :l], carry


# ---------------------------------------------------------------------------
# One layer: full sequence and single step
# ---------------------------------------------------------------------------


def _dt_A(layer, dt_raw):
    dt = F.softplus(dt_raw.float() + layer["dt_bias"])
    return dt, -torch.exp(layer["A_log"])


def apply_mamba_full(cfg, layer, hid, init_state=None):
    """hid (B, L, d) -> (hid', final SSM state (B, H, P, N) fp32)."""
    d_in, H, G, N, _ = _dims(cfg)
    u = rms_norm(hid, layer["ln"])
    z, xBC, dt_raw = _split_proj(cfg, layer, u)
    x, Bm, Cm = _split_xbc(cfg, _conv_full(layer, xBC))
    b, l = x.shape[:2]
    x = x.reshape(b, l, H, cfg.ssm_headdim)
    dt, A = _dt_A(layer, dt_raw)
    y, final = ssd_chunked(x, dt, A, Bm.reshape(b, l, G, N),
                           Cm.reshape(b, l, G, N), chunk=cfg.ssm_chunk,
                           init_state=init_state)
    y = y + x.float() * layer["D"][:, None]
    y = y.reshape(b, l, d_in).to(hid.dtype)
    y = rms_norm(y * F.silu(z), layer["norm"])
    return hid + y @ layer["out_proj"], final


def apply_mamba_step(cfg, layer, hid, conv_state, ssm_state):
    """hid (B, 1, d); conv_state (B, K-1, conv_dim); ssm_state (B, H, P, N)
    -> (hid', new conv state, new SSM state fp32), both new tensors (the
    caller's states are never written)."""
    d_in, H, G, N, _ = _dims(cfg)
    u = rms_norm(hid, layer["ln"])
    z, xBC, dt_raw = _split_proj(cfg, layer, u[:, 0])
    window = torch.cat([conv_state.float(), xBC[:, None].float()], dim=1)
    conv_out = ((window * layer["conv_w"].float()).sum(dim=1)
                + layer["conv_b"].float())
    new_conv = window[:, 1:].to(conv_state.dtype)
    x, Bm, Cm = _split_xbc(cfg, F.silu(conv_out).to(hid.dtype))
    b = x.shape[0]
    x = x.reshape(b, H, cfg.ssm_headdim).float()
    Bm = Bm.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()
    Cm = Cm.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()
    dt, A = _dt_A(layer, dt_raw)                                 # (b, H)
    ssm = (ssm_state.float() * torch.exp(dt * A)[..., None, None]
           + (dt[..., None] * x)[..., None] * Bm[:, :, None, :])
    y = (ssm @ Cm[..., None])[..., 0] + x * layer["D"][:, None]
    y = y.reshape(b, 1, d_in).to(hid.dtype)
    y = rms_norm(y * F.silu(z[:, None]), layer["norm"])
    return hid + y @ layer["out_proj"], new_conv, ssm


def conv_tail(cfg, layer, h):
    """The last K-1 pre-conv inputs of a prompt (zero-padded on the left
    when it is shorter): the conv state a decode continues from."""
    K = cfg.ssm_conv
    _, xBC, _ = _split_proj(cfg, layer, rms_norm(h, layer["ln"]))
    return F.pad(xBC, (0, 0, max(K - 1 - h.shape[1], 0), 0))[:, -(K - 1):]


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------


def forward(cfg, params, batch):
    """batch["tokens"] (B, S) -> final hidden states (B, S, d)."""
    h = params["embed"][batch["tokens"].long()]
    for i in range(cfg.num_layers):
        h = apply_mamba_full(cfg, stacked(params["layers"], i), h)[0]
    return rms_norm(h, params["final_norm"])


def init_cache(cfg, batch_size: int, max_len: int = 0, *, device="cuda"):
    """O(1) state (``max_len`` is ignored): conv (L, B, K-1, conv_dim) in
    the model dtype, ssm (L, B, H, P, N) fp32, and ``length``."""
    dev = _device.resolve(device)
    _, H, _, N, conv_dim = _dims(cfg)
    L = cfg.num_layers
    return {"conv": torch.zeros((L, batch_size, cfg.ssm_conv - 1, conv_dim),
                                dtype=model_dtype(cfg), device=dev),
            "ssm": torch.zeros((L, batch_size, H, cfg.ssm_headdim, N),
                               dtype=torch.float32, device=dev),
            "length": torch.zeros((batch_size,), dtype=torch.int32,
                                  device=dev)}


def prefill(cfg, params, batch, max_len: int = 0):
    """Run the prompt batch["tokens"] (B, S): the last position's logits
    (B, 1, V) fp32 and a new cache holding each layer's conv tail and final
    SSM state."""
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    h = params["embed"][tokens]
    convs, ssms = [], []
    for i in range(cfg.num_layers):
        layer = stacked(params["layers"], i)
        convs.append(conv_tail(cfg, layer, h))
        h, final = apply_mamba_full(cfg, layer, h)
        ssms.append(final)
    cache = {"conv": torch.stack(convs).to(model_dtype(cfg)),
             "ssm": torch.stack(ssms),
             "length": torch.full((B,), S, dtype=torch.int32,
                                  device=h.device)}
    h = rms_norm(h[:, -1:], params["final_norm"])
    return tied_unembed(params, h), cache


def _step_once(cfg, params, conv, ssm, tok_col):
    """One token (B,) through every layer: (logits (B, 1, V), new conv,
    new ssm), the states freshly stacked."""
    h = params["embed"][tok_col][:, None]
    convs, ssms = [], []
    for i in range(cfg.num_layers):
        h, cs, ss = apply_mamba_step(cfg, stacked(params["layers"], i), h,
                                     conv[i], ssm[i])
        convs.append(cs)
        ssms.append(ss)
    logits = tied_unembed(params, rms_norm(h, params["final_norm"]))
    return logits, torch.stack(convs), torch.stack(ssms)


def decode_step(cfg, params, cache, tokens):
    """Extend by tokens (B, T).  T = 1 is the recurrent step; T > 1 (the
    speculative verify) runs token by token and returns ``checkpoints``
    {"conv": (T, L, B, ...), "ssm": (T, L, B, ...)}, the states after each
    token, each its own tensor.  The input cache is not written."""
    tokens = tokens.long()
    T = tokens.shape[1]
    conv, ssm = cache["conv"], cache["ssm"]
    logits, conv_ck, ssm_ck = [], [], []
    for t in range(T):
        lg, conv, ssm = _step_once(cfg, params, conv, ssm, tokens[:, t])
        logits.append(lg)
        conv_ck.append(conv)
        ssm_ck.append(ssm)
    out = {"conv": conv, "ssm": ssm, "length": cache["length"] + T}
    if T > 1:
        out["checkpoints"] = {"conv": torch.stack(conv_ck),
                              "ssm": torch.stack(ssm_ck)}
    return torch.cat(logits, dim=1), out
