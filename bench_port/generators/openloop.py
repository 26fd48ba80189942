"""The general open-loop generator: every mix whose requests are fixed in
advance is a data file for it.

A traffic file gives (beside ``"generator": "openloop"``):

* ``arrivals``: ``"poisson"``;
* ``prompt`` and ``output``: lognormal lengths (``mu``, ``sigma``, ``min``,
  ``max``), drawn as the port's ``sharegpt`` preset draws them
  (``lib/traffic.draw``);
* ``prompt_ids``: ``"uniform"`` over the vocabulary;
* ``base_seed``: the seed of the fixed schedule;
* optional ``phases``: ``[{"seconds": s, "rate_scale": x}, ...]``, cycled
  from the start of the traffic: the offered rate is the cell's times the
  phase's scale;
* optional ``prefix``: ``{"count": n, "length": L}``: ``n`` shared prefixes
  of ``L`` tokens; request ``i`` of a span starts with prefix ``i mod n``
  and its drawn prompt length follows as its own suffix;
* optional ``sessions``: ``{"turns": k, "gap_s": g}``: each scheduled
  request opens a session whose turn ``j`` falls due ``j * g`` seconds
  later, its prompt the previous turn's prompt, a reply of the previous
  turn's output length and a new drawn prompt length.

Every seed offers the same work: a fixed trace is replayed.  The lead-in
and the measured window each get a fixed schedule (arrival times, prompt
and output lengths, in that order, drawn from ``base_seed``: the window's
at ``base_seed``, the lead-in's at ``base_seed + 1``; a phase piece ``k``
past the first at ``[seed of its span, k]``), sized by the rate and the
span; ``--seed`` draws every token id.  Gaps are scaled to fill their span
exactly: exponential spacings scaled to a fixed count are Poisson arrivals
conditioned on that count.  A window holds a few dozen requests of
heavy-tailed lengths, so a shuffled order made the work inside the window
swing by a third from seed to seed (PERF.md); replayed in one order, runs
differ by what the program does, not by what is asked.
"""
from __future__ import annotations

from typing import List

import numpy as np

from bench_port.lib.traffic import TrafficRequest, draw, lengths


def _span(traffic, rate, span_s, seed):
    """Arrival offsets in [0, span_s), prompt and output lengths of one
    span's fixed schedule."""
    n = max(int(round(rate * span_s)), 1)
    gaps, prompts, outputs = draw(traffic, rate, n, seed)
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return starts * (span_s / gaps.sum()), prompts, outputs


def _pieces(phases, start, span_s):
    """(start, seconds, rate scale) of the phase pieces covering [start,
    start + span_s); one piece at scale 1 without phases."""
    if not phases:
        return [(start, span_s, 1.0)]
    cycle = sum(float(p["seconds"]) for p in phases)
    out, t, end = [], start, start + span_s
    while t < end - 1e-9:
        into, acc = t % cycle, 0.0
        for p in phases:
            acc += float(p["seconds"])
            if into < acc - 1e-9:
                step = min(acc - into, end - t)
                out.append((t, step, float(p["rate_scale"])))
                t += step
                break
    return out


def _schedule(traffic, rate, start, span_s, seed):
    """(arrival, prompt length, output length) of a span, by arrival."""
    rows = []
    for k, (t0, sec, scale) in enumerate(
            _pieces(traffic.get("phases"), start, span_s)):
        offsets, prompts, outputs = _span(traffic, rate * scale, sec,
                                          seed if k == 0 else [seed, k])
        rows += [(t0 + float(t), int(p), int(o))
                 for t, p, o in zip(offsets, prompts, outputs)]
    return rows


def generate(traffic: dict, *, rate: float, lead_in_s: float,
             seconds: float, seed: int, vocab: int
             ) -> List[TrafficRequest]:
    """The run's requests, by arrival: the lead-in's schedule over [0,
    lead_in_s), then the window's over [lead_in_s, lead_in_s + seconds).
    Token ids are drawn from ``seed``, uniform over the vocabulary."""
    if traffic["arrivals"] != "poisson":
        raise ValueError(f"unknown arrival process {traffic['arrivals']!r}")
    if traffic["prompt_ids"] != "uniform":
        raise ValueError(f"unknown prompt ids {traffic['prompt_ids']!r}")
    base = int(traffic["base_seed"])
    ids = np.random.default_rng([int(seed), 1])
    pre = traffic.get("prefix")
    prefixes = ([ids.integers(0, vocab, size=int(pre["length"]),
                              dtype=np.int64) for _ in range(int(pre["count"]))]
                if pre else [])
    sess = traffic.get("sessions")
    end = lead_in_s + seconds
    spans = [(0.0, lead_in_s, base + 1)] if lead_in_s > 0 else []
    spans.append((lead_in_s, seconds, base))
    rows = []
    for start, span_s, span_seed in spans:
        sched = _schedule(traffic, rate, start, span_s, span_seed)
        turns = (np.random.default_rng([span_seed, 11]) if sess else None)
        for i, (t, plen, olen) in enumerate(sched):
            prompt = ids.integers(0, vocab, size=plen, dtype=np.int64)
            if prefixes:
                prompt = np.concatenate([prefixes[i % len(prefixes)], prompt])
            rows.append((t, prompt, olen))
            for j in range(1, int(sess["turns"]) if sess else 1):
                p, o = traffic["prompt"], traffic["output"]
                user = lengths(turns, p["mu"], p["sigma"], 1, p["min"],
                               p["max"])[0]
                nxt = lengths(turns, o["mu"], o["sigma"], 1, o["min"],
                              o["max"])[0]
                prompt = np.concatenate([
                    prompt, ids.integers(0, vocab, size=olen, dtype=np.int64),
                    ids.integers(0, vocab, size=int(user), dtype=np.int64)])
                olen = int(nxt)
                if t + j * float(sess["gap_s"]) < end:
                    rows.append((t + j * float(sess["gap_s"]), prompt, olen))
    rows.sort(key=lambda r: r[0])
    return [TrafficRequest(i, t, prompt, olen, lead_in_s <= t < end)
            for i, (t, prompt, olen) in enumerate(rows)]
