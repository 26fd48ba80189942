"""Plain PyTorch versions of the package's CUDA kernels.

The CPU path of the wrappers, and the ground truth the kernels are held
against on the card (``chip_smoke.py``, the ``cuda``-marked tests).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def migrate_blocks_ref(pool, src, dst):
    """pool: (L, num_blocks, ...); copy blocks src[i] -> dst[i] along axis 1,
    in place.  The source blocks are gathered before any destination is
    written, so overlapping maps behave like the functional
    ``x.at[dst].set(x[src])``."""
    src = torch.as_tensor(src, dtype=torch.long, device=pool.device)
    dst = torch.as_tensor(dst, dtype=torch.long, device=pool.device)
    pool[:, dst] = pool[:, src]
    return pool


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                        window=0):
    """Attention of a T-token extension over paged KV.

    q:            (B, H, D) single-query decode, or (B, T, H, D) multi-query
    k/v_pages:    (num_blocks, block_size, KH, D)
    block_tables: (B, max_blocks) int32, padded with any valid id
    lengths:      (B,) valid token counts INCLUDING the T new positions
                  (whose K/V are already written into the pages); query t
                  attends to positions <= p = lengths - T + t
    window:       > 0: query t attends only to positions > p - window
    returns       same shape and dtype as q
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, T, H, D = q.shape
    _, bs, KH, _ = k_pages.shape
    G = H // KH
    S = block_tables.shape[1] * bs
    tables = block_tables.long()

    # gather each sequence's KV contiguously
    k = k_pages[tables].reshape(B, S, KH, D).float()
    v = v_pages[tables].reshape(B, S, KH, D).float()
    qg = q.reshape(B, T, KH, G, D).float() * (D ** -0.5)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    t_idx = torch.arange(T, device=q.device)
    limit = lengths.long()[:, None] - T + t_idx[None, :]          # (B, T)
    pos = torch.arange(S, device=q.device)[None, None, :]
    mask = pos <= limit[:, :, None]
    if window:
        mask = mask & (pos > limit[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    out = out.reshape(B, T, H, D).to(q.dtype)
    return out[:, 0] if squeeze else out


def flash_attention_ref(q, k, v, *, causal, prefix_len=0, window=0):
    """Full-sequence attention, in fp32, returned in q's dtype.

    q: (B, Sq, H, D); k/v: (B, Sk, KH, D), query head h reading KV head
    h // (H // KH).  Causal (Sq == Sk): query i sees keys j <= i, and every
    key j < ``prefix_len`` (a bidirectional prefix); with a ``window`` > 0
    only keys j > i - window among them.  Non-causal: every query sees
    every key, and ``prefix_len`` has no effect.
    """
    B, Sq, H, D = q.shape
    s, _ = _flash_scores(q, k, causal, prefix_len, window)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _flash_scores(q, k, causal, prefix_len, window=0):
    """Scaled, masked fp32 scores (B, KH, G, Sq, Sk) of ``flash_attention``,
    and the mask (Sq, Sk) or None."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, D).float() * (D ** -0.5)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if not causal:
        return s, None
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = (q_pos >= k_pos) | (k_pos < prefix_len)
    if window:
        mask = mask & (q_pos - k_pos < window)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def flash_attention_lse_ref(q, k, v, *, causal, prefix_len=0):
    """``flash_attention_ref`` and each row's log-sum-exp of the scaled,
    masked scores: (out in q's dtype, lse (B, H, Sq) fp32), the pair the
    CUDA forward writes under autograd."""
    B, Sq, H, _ = q.shape
    s, _ = _flash_scores(q, k, causal, prefix_len)
    return (flash_attention_ref(q, k, v, causal=causal,
                                prefix_len=prefix_len),
            torch.logsumexp(s, dim=-1).reshape(B, H, Sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal, prefix_len=0):
    """Gradients (dq, dk, dv) of ``flash_attention_ref``, each in its
    input's dtype, written out step by step in fp32 as the CUDA backward
    computes them: P = exp(S - lse) from the forward's log-sum-exp
    (B, H, Sq), delta = rowsum(dO * O), dV = P^T dO, dP = dO V^T,
    dS = P * (dP - delta), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), with
    dK and dV summed over the query heads of each KV head."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5
    s, mask = _flash_scores(q, k, causal, prefix_len)
    p = torch.exp(s - lse.float().reshape(B, KH, G, Sq, 1))
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dog = do.float().reshape(B, Sq, KH, G, D)
    delta = (dog * o.float().reshape(B, Sq, KH, G, D)).sum(-1)  # (B,Sq,KH,G)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.float().reshape(B, Sq, KH, G, D)) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
