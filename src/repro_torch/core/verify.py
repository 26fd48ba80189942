"""Lossless speculative-decoding verification (Leviathan et al. 2023).

Batched rejection sampling: given draft tokens, draft distributions and the
target's distributions over the same positions (+ one bonus position), accept
a prefix of the draft and sample a correction/bonus token such that the
committed tokens are distributed EXACTLY as target-only decoding.  Random
numbers come from a caller's ``torch.Generator``.
"""
from __future__ import annotations

import torch

from ..distributed.sharding import full_dim, whole


def _commit(draft_tokens, n_accepted, next_token):
    """(B, g+1) committed tokens: accepted prefix, then next_token, then -1."""
    B, g = draft_tokens.shape
    pos = torch.arange(g + 1, device=draft_tokens.device)[None, :]
    padded = torch.cat([draft_tokens, draft_tokens.new_zeros((B, 1))], dim=1)
    n = n_accepted[:, None]
    return torch.where(pos < n, padded,
                       torch.where(pos == n, next_token[:, None],
                                   torch.full_like(padded, -1)))


def verify_rejection(gen, draft_tokens, draft_probs, target_probs):
    """Batched rejection-sampling verification.

    gen:          torch.Generator on the tensors' device
    draft_tokens: (B, g) int — tokens proposed by the draft model
    draft_probs:  (B, g, V) — draft distribution at each proposal position
    target_probs: (B, g+1, V) — target distribution at the same g positions
                  plus the bonus position.

    Returns dict with
      n_accepted: (B,) number of draft tokens accepted (0..g)
      next_token: (B,) the correction (on rejection) or bonus (all accepted)
      tokens:     (B, g+1) committed tokens = accepted prefix + next_token,
                  positions beyond n_accepted+1 are -1
    """
    B, g = draft_tokens.shape
    dt = draft_tokens.long()
    p_tok = torch.gather(target_probs[:, :g], 2, dt[..., None])[..., 0]
    q_tok = torch.gather(draft_probs, 2, dt[..., None])[..., 0]
    u = torch.rand((B, g), generator=gen, device=draft_probs.device)
    accept = u * q_tok < p_tok  # == u < p/q, robust to q == 0
    n_accepted = torch.cumprod(accept.long(), dim=1).sum(dim=1)   # (B,)

    # distribution of the next token: the bonus distribution if all g were
    # accepted, else the normalised residual max(p - q, 0) at the first
    # rejected position
    idx = n_accepted.clamp(max=g - 1)[:, None, None]
    V = target_probs.shape[-1]
    p_rej = torch.gather(target_probs[:, :g], 1, idx.expand(B, 1, V))[:, 0]
    q_rej = torch.gather(draft_probs, 1, idx.expand(B, 1, V))[:, 0]
    residual = (p_rej - q_rej).clamp(min=0.0)
    res_sum = residual.sum(dim=-1, keepdim=True)
    # numerical guard: if the residual is empty (p == q exactly), use p
    residual = torch.where(res_sum > 1e-9, residual / res_sum.clamp(min=1e-9),
                           p_rej)
    next_dist = torch.where((n_accepted == g)[:, None], target_probs[:, g],
                            residual)
    next_token = torch.multinomial(next_dist, 1, generator=gen)[:, 0]
    return {"n_accepted": n_accepted, "next_token": next_token,
            "tokens": _commit(dt, n_accepted, next_token)}


def verify_greedy(draft_tokens, target_logits):
    """Greedy verification: accept while draft token == target argmax.

    target_logits: (B, g+1, V).  Deterministic — greedy spec decoding emits
    exactly the target's greedy sequence."""
    # the (B, g+1) decisions are made whole (DTensor has no rule for a
    # cumulative product)
    dt = whole(draft_tokens).long()
    g = dt.shape[1]
    tgt = whole(full_dim(target_logits, -1).argmax(dim=-1))  # (B, g+1)
    n_accepted = torch.cumprod((tgt[:, :g] == dt).long(), dim=1).sum(dim=1)
    next_token = torch.gather(tgt, 1, n_accepted[:, None])[:, 0]
    return {"n_accepted": n_accepted, "next_token": next_token,
            "tokens": _commit(dt, n_accepted, next_token)}
