"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the timed path served in full, drawn from the seed with the
longest among them, goes through the plain reference once: each prompt
with its served tokens.  Every served token is greedy, so the reference's
logit of that token should be its best; the number compared is the widest
gap, over every served token of the sample, by which the served token's
logit lies below the reference's best at that position
(``max_logit_gap``).  A configuration may compare another reading of the
same gaps where the widest does not separate the program from the control
(``correct.number`` in its file, against ``correct.limit``):
``p99_logit_gap``, the 99th percentile over every served token, or
``mean_logit_gap``.  Every reading is printed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import reference

SAMPLE = 8     # requests compared per run, the longest among them


def sample(streams: Dict[int, list], prompts: Dict[int, np.ndarray],
           seed: int, k: int = SAMPLE) -> List[int]:
    """The longest served request (prompt + output) and k - 1 others drawn
    from ``seed``, in request order."""
    ids = sorted(streams)
    if not ids:
        return []
    longest = max(ids, key=lambda r: (len(prompts[r]) + len(streams[r]), r))
    rest = [r for r in ids if r != longest]
    rng = np.random.default_rng([int(seed), 2])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[i] for i in pick])


def sequences(ids, streams, prompts) -> Tuple[list, list]:
    """Each prompt with its served tokens but the last (the input that
    predicts every served token), and where the predictions start."""
    seqs, starts = [], []
    for r in ids:
        p, s = prompts[r], streams[r]
        seqs.append(torch.as_tensor(np.concatenate([p, s[:-1]]),
                                    dtype=torch.long))
        starts.append(len(p) - 1)
    return seqs, starts


def gaps(ref_logits: Sequence[torch.Tensor],
         chosen: Sequence[Sequence[int]]) -> torch.Tensor:
    """(best logit - logit of the chosen token) at every position, fp32."""
    out = []
    for lg, toks in zip(ref_logits, chosen):
        t = torch.as_tensor(list(toks), dtype=torch.long, device=lg.device)
        out.append(lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out).float().cpu()


def readings(g: torch.Tensor) -> Dict[str, float]:
    """The numbers a configuration may compare, from every gap."""
    return {"max_logit_gap": float(g.max()),
            "p99_logit_gap": float(torch.quantile(g, 0.99)),
            "mean_logit_gap": float(g.mean()),
            "mismatch_share": float((g > 0).float().mean())}


def decide(rule: dict, readings: Dict[str, float], n_tok: int) -> bool:
    """``correct``: some tokens were compared, and the configuration's
    reading (``rule["number"]``) lies at or under its ``rule["limit"]``.
    The control's readings go through this same decision."""
    return bool(n_tok > 0 and readings.get(rule["number"], float("inf"))
                <= float(rule["limit"]))


def served_readings(params, sizes, ids, streams, prompts
                    ) -> Tuple[Dict[str, float], int]:
    """(the served tokens' readings under the reference, tokens
    compared)."""
    seqs, starts = sequences(ids, streams, prompts)
    ref = reference.logits(params, sizes, seqs, starts)
    return (readings(gaps(ref, [streams[r] for r in ids])),
            sum(len(streams[r]) for r in ids))


def control_readings(params, sizes, ids, streams, prompts
                     ) -> Dict[str, float]:
    """The control's readings: the reference again in float8, and the
    gaps, under the float32 reference, of the tokens it puts first at each
    position of the same sequences."""
    seqs, starts = sequences(ids, streams, prompts)
    ref = reference.logits(params, sizes, seqs, starts)
    low = reference.logits(params, sizes, seqs, starts, precision="fp8")
    return readings(gaps(ref, [lg.argmax(dim=-1).tolist() for lg in low]))
