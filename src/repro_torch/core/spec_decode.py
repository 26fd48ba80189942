"""Draft-then-verify speculative decoding, over paged KV pools and over
dense caches.

Cache-synchronisation invariant (holds before and after every step): both
caches hold K/V for tokens x_0..x_{N-1} of each sequence, and
``last_tokens`` = x_N is committed but in NEITHER cache.  The draft chain
consumes the full (gamma+1)-token chunk [x_N, d_1..d_gamma] — one extra
draft step per round — so both caches advance in lockstep and rollback is
free: each sequence's length advances by n_accepted+1 (on the host for the
pools, in the dense caches' ``length``), and the stale slots beyond it are
never attended (the attention masks pos <= query position) and are
overwritten by the next step's writes.  An SSM state has no positions to
mask: an ssm or hybrid model restores it from per-token checkpoints
(:func:`_rollback_ssm_cache`), the analogue of KV truncation.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..distributed.sharding import full_dim
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
    lengths, last_tokens, gamma, positions=None) -> SpecResult``.

    ``lengths`` is the per-sequence materialised token count N.  Both models
    write the (gamma+1)-token chunk at positions N..N+gamma through the SAME
    block tables, which the caller has grown to cover N + gamma + 1
    positions.  ``positions`` (gamma+1, B), row i = N + i, may carry the
    draft chain's starts as inputs (a captured step passes them, so that
    every operand of its model calls is one of the step's inputs, which
    outlive the graph's replays); without it the chain counts them on the
    device.  sampling: "greedy" (accept on argmax match) or "rejection"
    (lossless stochastic verification)."""
    if not (target.supports_paged and draft.supports_paged):
        raise NotImplementedError(
            "paged speculative decoding needs attention-family target and "
            "draft models")

    def spec_step(gen, tparams, dparams, tpages, dpages, tables, lengths,
                  last_tokens, gamma: int, positions=None):
        # the draft chain: gamma+1 single-token paged steps
        tok, pos = last_tokens, lengths
        toks, probs = [], []
        for i in range(gamma + 1):
            if positions is not None:
                pos = positions[i]
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


def _select_ckpt(x, idx):
    """x (T, L, B, ...) per-step checkpoints -> (L, B, ...): sequence b's
    state at step idx[b]."""
    idx = idx.long().clamp(0, x.shape[0] - 1)
    rows = torch.arange(x.shape[2], device=x.device)
    return x[idx, :, rows].transpose(0, 1)       # (B, L, ...) -> (L, B, ...)


def _rollback_ssm_cache(cache_ext, base_cache, n_keep):
    """Restore conv / ssm from checkpoint n_keep - 1 (the state after the
    first n_keep chunk tokens; n_keep >= 1, the chunk starts with the last
    committed token).  Attention parts (a hybrid's) roll back by length
    alone.  The returned cache has no ``checkpoints``."""
    ck = cache_ext["checkpoints"]
    out = {k: v for k, v in cache_ext.items() if k != "checkpoints"}
    out["conv"] = _select_ckpt(ck["conv"], n_keep - 1)
    out["ssm"] = _select_ckpt(ck["ssm"], n_keep - 1)
    out["length"] = (base_cache["length"] + n_keep).to(torch.int32)
    return out


def make_spec_step(target: ModelAPI, draft: ModelAPI, *,
                   sampling: str = "greedy", temperature: float = 1.0):
    """Build ``spec_step(gen, tparams, dparams, tcache, dcache, last_tokens,
    gamma) -> SpecResult`` over dense caches (``decode_step``).

    Both caches hold N tokens (their ``length``); the draft consumes the
    (gamma+1)-token chunk, the target verifies it in one extension, and
    both caches come back with length N + n_accepted + 1.  Attention
    caches roll back by that length alone (their k / v tensors are updated
    in place); an ssm or hybrid target restores its conv / SSM state from
    the extension's per-token ``checkpoints``, and an ssm draft from the
    state after each of its chain steps, each at n_keep - 1 per sequence.
    A hybrid draft is refused, as in the reference."""
    t_is_ssm = target.cfg.family in ("ssm", "hybrid")
    d_is_ssm = draft.cfg.family == "ssm"
    if draft.cfg.family == "hybrid":
        raise NotImplementedError("use a pure-ssm or attention draft model")

    def spec_step(gen, tparams, dparams, tcache, dcache, last_tokens,
                  gamma: int):
        tok, toks, probs, conv_ck, ssm_ck = last_tokens, [], [], [], []
        for _ in range(gamma + 1):
            logits, dcache = draft.decode_step(dparams, dcache, tok[:, None])
            lg = logits[:, 0] / temperature
            if sampling == "greedy":
                tok = full_dim(lg, -1).argmax(dim=-1)
            else:
                probs.append(torch.softmax(lg, dim=-1))
                tok = torch.multinomial(probs[-1], 1, generator=gen)[:, 0]
            toks.append(tok)
            if d_is_ssm:
                conv_ck.append(dcache["conv"])
                ssm_ck.append(dcache["ssm"])
        draft_tokens = torch.stack(toks[:gamma], dim=1)            # (B, g)

        chunk = torch.cat([last_tokens[:, None].long(), draft_tokens], dim=1)
        t_logits, tcache_ext = target.decode_step(tparams, tcache, chunk)
        t_logits = t_logits / temperature
        if sampling == "greedy":
            res = verify_greedy(draft_tokens, t_logits)
        else:
            res = verify_rejection(gen, draft_tokens,
                                   torch.stack(probs[:gamma], dim=1),
                                   torch.softmax(t_logits, dim=-1))
        n_acc = res["n_accepted"]
        n_keep = 1 + n_acc      # chunk tokens kept: x_N + accepted drafts
        length = (tcache["length"] + n_keep).to(torch.int32)
        if t_is_ssm:
            tcache_new = _rollback_ssm_cache(tcache_ext, tcache, n_keep)
        else:
            tcache_new = {k: v for k, v in tcache_ext.items()
                          if k != "checkpoints"}
            tcache_new["length"] = length
        dcache_new = {**dcache, "length": length}
        if d_is_ssm:
            dcache_new["conv"] = _select_ckpt(torch.stack(conv_ck),
                                              n_keep - 1)
            dcache_new["ssm"] = _select_ckpt(torch.stack(ssm_ck), n_keep - 1)
        return SpecResult(tokens=res["tokens"], n_accepted=n_acc,
                          n_committed=n_acc + 1, tcache=tcache_new,
                          dcache=dcache_new, last_token=res["next_token"])

    return spec_step


def make_ar_step(target: ModelAPI, *, sampling: str = "greedy",
                 temperature: float = 1.0):
    """Plain autoregressive decode step over a dense cache (the gamma=0
    arm): ``ar_step(gen, tparams, tcache, last_tokens) -> (next tokens,
    tcache)``."""

    def ar_step(gen, tparams, tcache, last_tokens):
        logits, tcache = target.decode_step(tparams, tcache,
                                            last_tokens[:, None])
        lg = logits[:, 0] / temperature
        nxt = lg.argmax(dim=-1) if sampling == "greedy" else _sample(gen, lg)
        return nxt, tcache

    return ar_step
