"""Arithmetic over what a run saw, shared by the metric readers.

Every end-to-end number is taken over all of the window: a rate over all
its work and all its time, a tail over all its requests.
"""
from __future__ import annotations

import statistics
from typing import Iterable, List, Optional


def percentile(values: Iterable[float], q: int) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics, the ends
    included), or None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[q - 1]


def p95(values: Iterable[float]) -> Optional[float]:
    return percentile(values, 95)


def spread(values: List[float]) -> float:
    """Interquartile distance as a share of the median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def in_window(run, t: float) -> bool:
    return run.window_open <= t < run.window_close


def window_tokens(run, rec) -> List[float]:
    return [t for t in rec.token_times if in_window(run, t)]


def output_tok_s(run) -> float:
    n = sum(len(window_tokens(run, r)) for r in run.requests.values())
    return n / run.seconds


def window_requests(run):
    return [r for r in run.requests.values() if r.in_window]


def ttft_s(run) -> List[float]:
    """Due time to first token of each request due in the window; one with
    no first token waited until the run stopped."""
    return [(r.token_times[0] if r.token_times else run.end) - r.due
            for r in window_requests(run)]


def tpot_s(run) -> List[float]:
    """(last - first) / (tokens - 1) of each request's tokens inside the
    window, over requests with two or more there."""
    out = []
    for r in run.requests.values():
        ts = window_tokens(run, r)
        if len(ts) >= 2:
            out.append((ts[-1] - ts[0]) / (len(ts) - 1))
    return out


def token_gaps_s(run) -> List[float]:
    """Every gap between two consecutive output tokens of one request, both
    inside the window, over all requests: what a streaming user waits
    between tokens (tokens a step commits together are 0 apart)."""
    out = []
    for r in run.requests.values():
        ts = window_tokens(run, r)
        out += [b - a for a, b in zip(ts[:-1], ts[1:])]
    return out


def queue_wait_s(run) -> List[float]:
    """Due time to the start of the step that ran the request's first
    prefill chunk, over requests due in the window."""
    return [(r.admitted if r.admitted >= 0 else run.end) - r.due
            for r in window_requests(run)]


def window_steps(run):
    """Steps that ended inside the window."""
    return [s for s in run.steps if in_window(run, s.t_end)]


def _mean_step_ms(steps) -> Optional[float]:
    if not steps:
        return None
    return 1e3 * sum(s.t_end - s.t_start for s in steps) / len(steps)


def decode_step_ms(run) -> Optional[float]:
    """Wall time of the window's pure-decode steps over their count."""
    return _mean_step_ms([s for s in window_steps(run) if s.pure_decode])


def mixed_step_ms(run) -> Optional[float]:
    """Wall time of the window's steps that run a prefill chunk beside
    decode rows, over their count."""
    return _mean_step_ms([s for s in window_steps(run)
                          if s.kind == "decode" and s.batch > 0
                          and s.prefill_tokens > 0])


def useful_flops(run) -> float:
    """The target's flops for the prompt positions prefilled and the
    output tokens served inside the window (2 per weight a token
    multiplies by, plus attention over its context); the first output
    token comes with the prompt's last position, so output token i >= 1
    counts the position prompt_len + i - 1.  Draft work, rejected tokens,
    padding and recomputation are overhead and count nothing.  A token's
    flops are the target's architecture module's ``token_flops``."""
    m, token_flops = run.target_sizes, run.arch.token_flops
    total = 0.0
    for s in window_steps(run):
        for _, first, n in s.chunks:
            total += sum(token_flops(m, p + 1)
                         for p in range(first, first + n))
        for rid, first, n in s.served:
            plen = run.requests[rid].prompt_len
            total += sum(token_flops(m, plen + i)
                         for i in range(max(first, 1), first + n))
    return total
