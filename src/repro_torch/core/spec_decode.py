"""Draft-then-verify speculative decoding over paged KV pools.

Cache-synchronisation invariant (holds before and after every step): both
pools hold K/V for tokens x_0..x_{N-1} of each sequence, and
``last_tokens`` = x_N is committed but in NEITHER pool.  The draft chain
consumes the full (gamma+1)-token chunk [x_N, d_1..d_gamma] — one extra
draft step per round — so both pools advance in lockstep and rollback is
free: the host advances each sequence's length by n_accepted+1, and the
stale slots beyond it are never attended (the attention masks
pos <= query position) and are overwritten by the next step's writes.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.registry import ModelAPI
from .verify import verify_greedy, verify_rejection


class SpecResult(NamedTuple):
    tokens: torch.Tensor       # (B, g+1) committed, -1 padded
    n_accepted: torch.Tensor   # (B,)
    n_committed: torch.Tensor  # (B,) == n_accepted + 1
    tcache: Any
    dcache: Any
    last_token: torch.Tensor   # (B,) newly sampled token (not yet in pools)


def _sample(gen, logits):
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=gen)[:, 0]


def make_paged_spec_step(target: ModelAPI, draft: ModelAPI, *,
                         sampling: str = "greedy", temperature: float = 1.0):
    """Build ``spec_step(gen, tparams, dparams, tpages, dpages, tables,
    lengths, last_tokens, gamma) -> SpecResult``.

    ``lengths`` is the per-sequence materialised token count N.  Both models
    write the (gamma+1)-token chunk at positions N..N+gamma through the SAME
    block tables, which the caller has grown to cover N + gamma + 1
    positions.  sampling: "greedy" (accept on argmax match) or "rejection"
    (lossless stochastic verification)."""
    if not (target.supports_paged and draft.supports_paged):
        raise NotImplementedError(
            "paged speculative decoding needs attention-family target and "
            "draft models")

    def spec_step(gen, tparams, dparams, tpages, dpages, tables, lengths,
                  last_tokens, gamma: int):
        # the draft chain: gamma+1 single-token paged steps
        tok, pos = last_tokens, lengths
        toks, probs = [], []
        for _ in range(gamma + 1):
            logits, dpages = draft.decode_step_paged(dparams, dpages,
                                                     tok[:, None], tables, pos)
            lg = logits[:, 0] / temperature
            if sampling == "greedy":
                tok = lg.argmax(dim=-1)
            else:
                probs.append(torch.softmax(lg, dim=-1))
                tok = torch.multinomial(probs[-1], 1, generator=gen)[:, 0]
            toks.append(tok)
            pos = pos + 1
        draft_tokens = torch.stack(toks[:gamma], dim=1)            # (B, g)

        # the target verifies [last, d_1..d_g] in one paged extension
        chunk = torch.cat([last_tokens[:, None].long(), draft_tokens], dim=1)
        t_logits, tpages = target.decode_step_paged(tparams, tpages, chunk,
                                                    tables, lengths)
        t_logits = t_logits / temperature
        if sampling == "greedy":
            res = verify_greedy(draft_tokens, t_logits)
        else:
            res = verify_rejection(gen, draft_tokens,
                                   torch.stack(probs[:gamma], dim=1),
                                   torch.softmax(t_logits, dim=-1))
        n_acc = res["n_accepted"]
        return SpecResult(tokens=res["tokens"], n_accepted=n_acc,
                          n_committed=n_acc + 1, tcache=tpages, dcache=dpages,
                          last_token=res["next_token"])

    return spec_step


def make_paged_ar_step(target: ModelAPI, *, sampling: str = "greedy",
                       temperature: float = 1.0):
    """Plain autoregressive decode step over the paged pool (the gamma=0
    arm): ``ar_step(gen, tparams, tpages, tables, lengths, last_tokens)
    -> (next tokens, tpages)``."""

    def ar_step(gen, tparams, tpages, tables, lengths, last_tokens):
        logits, tpages = target.decode_step_paged(tparams, tpages,
                                                  last_tokens[:, None],
                                                  tables, lengths)
        lg = logits[:, 0] / temperature
        nxt = lg.argmax(dim=-1) if sampling == "greedy" else _sample(gen, lg)
        return nxt, tpages

    return ar_step
