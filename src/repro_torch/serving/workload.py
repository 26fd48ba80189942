"""Workload generation: arrival processes + dataset length distributions.

The paper's datasets (ShareGPT / Alpaca / SpecBench) and the Azure trace are
not available offline; we synthesise length distributions matched to the
shapes reported in Figure 8 (lognormal fits) and a dynamic request-rate trace
shaped like Figure 10.  Acceptance quality per request is drawn from a Beta
distribution (harder requests accept fewer draft tokens).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .request import Request

# (prompt mu, prompt sigma, output mu, output sigma, alpha_a, alpha_b,
#  slo_ttft) — lognormal parameters matched to Figure 8's reported
# input/output shapes; slo_ttft is the per-dataset first-token deadline (s)
# used for SLO-attainment / goodput accounting (AdaSpec-style serving SLOs:
# interactive chat gets a tighter deadline than the mixed benchmark).
DATASETS = {
    # chat: long-ish prompts, medium outputs, moderate acceptance
    "sharegpt": dict(p_mu=5.4, p_sigma=0.9, o_mu=5.2, o_sigma=0.8,
                     a_a=6.0, a_b=3.0, slo_ttft=1.0),
    # instruction: short prompts, short outputs
    "alpaca": dict(p_mu=3.6, p_sigma=0.7, o_mu=4.2, o_sigma=0.8,
                   a_a=5.0, a_b=3.0, slo_ttft=0.5),
    # mixed six-task benchmark: broad spread, hardest for the draft
    "specbench": dict(p_mu=5.0, p_sigma=1.2, o_mu=5.0, o_sigma=1.0,
                      a_a=4.0, a_b=3.0, slo_ttft=1.5),
    # templated serving (shared system prompt / few-shot header): the
    # length parameters describe the per-request SUFFIX; every prompt is
    # template_len shared tokens + a drawn suffix.  The prefix-sharing
    # workload: identical prefix blocks per request are exactly what
    # copy-on-write prefix caching reclaims.
    "templated": dict(p_mu=3.6, p_sigma=0.7, o_mu=4.2, o_sigma=0.8,
                      a_a=5.0, a_b=3.0, slo_ttft=0.5, template_len=512),
    # multi-turn chat sessions: each turn's prompt is the full conversation
    # history (initial pasted context + alternating user/assistant tokens),
    # re-submitted after a think-time gap.  p_* describe the per-turn USER
    # message; o_* the assistant response; context_len the turn-0 system
    # prompt / pasted context; think_s the mean think-time between turns.
    # The host-KV-offload workload: between turns a session's prefix blocks
    # go cold and are evicted from a tight device pool — warm-turn TTFT
    # then hinges on whether the evicted history is restorable.
    "sessions": dict(p_mu=4.0, p_sigma=0.6, o_mu=4.0, o_sigma=0.5,
                     a_a=6.0, a_b=3.0, slo_ttft=1.0, context_len=768,
                     turns=6, think_s=8.0),
    # bimodal mix of long-prompt/short-decode (document QA: prefill-bound)
    # and short-prompt/long-decode (generation: decode-bound) traffic — the
    # disaggregation workload.  Colocated replicas interleave both regimes
    # on one chunk budget: resident long decodes eat the budget's decode
    # slots and the KV pool, so long prompts queue behind them and p99 TTFT
    # collapses.  A split fleet prefills on replicas that shed their decode
    # work and decodes on replicas that never see a prompt.  qa_frac is the
    # long-prompt share; the qa_*/gen_* pairs parameterise the two modes.
    # qa_frac=0.25: one document-QA prompt per three long generations —
    # enough long decodes to clog a colocated fleet's batch slots, enough
    # prompts for the disaggregated prefill pool to matter (the regime the
    # --only disagg grid and launch/serve.py examples are tuned to)
    "mixed": dict(p_mu=5.0, p_sigma=1.0, o_mu=4.5, o_sigma=0.9,
                  a_a=5.0, a_b=3.0, slo_ttft=1.0, qa_frac=0.25,
                  qa_p_mu=7.0, qa_p_sigma=0.5, qa_o_mu=3.2, qa_o_sigma=0.5,
                  gen_p_mu=3.8, gen_p_sigma=0.5, gen_o_mu=6.1,
                  gen_o_sigma=0.4),
}


def dataset_slo(dataset: str, slo: "float | None" = None) -> "float | None":
    """Resolve the TTFT deadline: explicit override (<=0 disables) or the
    per-dataset default."""
    if slo is not None:
        return slo if slo > 0 else None
    return DATASETS[dataset].get("slo_ttft")


def _lengths(rng, mu, sigma, n, lo, hi):
    x = rng.lognormal(mu, sigma, size=n)
    return np.clip(x, lo, hi).astype(int)


def poisson_requests(rate_qps: float, n: int, *, dataset: str = "sharegpt",
                     seed: int = 0, max_prompt: int = 2048,
                     max_output: int = 1024,
                     slo: "float | None" = None) -> List[Request]:
    """Poisson arrivals at a static rate."""
    rng = np.random.default_rng(seed)
    d = DATASETS[dataset]
    deadline = dataset_slo(dataset, slo)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    arrivals = np.cumsum(gaps)
    prompts = _lengths(rng, d["p_mu"], d["p_sigma"], n, 4, max_prompt)
    outputs = _lengths(rng, d["o_mu"], d["o_sigma"], n, 4, max_output)
    alphas = rng.beta(d["a_a"], d["a_b"], size=n)
    return [Request(i, float(arrivals[i]), int(prompts[i]), int(outputs[i]),
                    float(alphas[i]), slo=deadline) for i in range(n)]


def dynamic_rate_trace(duration_s: float = 120.0, *, low: float = 2.0,
                       high: float = 30.0, period_s: float = 40.0,
                       seed: int = 0) -> "RateTrace":
    """Figure-10-like trace: alternating low/high phases with ramps."""
    rng = np.random.default_rng(seed)
    ts, rates = [], []
    t = 0.0
    while t < duration_s:
        phase = (t // period_s) % 2
        base = low if phase == 0 else high
        jitter = rng.uniform(0.8, 1.2)
        ts.append(t)
        rates.append(base * jitter)
        t += period_s / 8
    return RateTrace(np.asarray(ts), np.asarray(rates))


def bursty_trace(*, base: float = 4.0, spike: float = 40.0,
                 base_s: float = 20.0, spike_s: float = 15.0,
                 drain_s: float = 25.0, drain: "float | None" = None,
                 jitter: float = 0.1, knot_s: float = 1.0,
                 seed: int = 0) -> "RateTrace":
    """Regime-shift arrival trace: baseline -> spike -> drain.

    The autoscaler workload: a steady ``base`` qps phase, an abrupt
    ``spike`` qps burst of ``spike_s`` seconds (the regime shift a static
    fleet must over-provision for), then a ``drain`` phase (default
    ``base / 2``) long enough for an elastic fleet to scale back down.
    Knots every ``knot_s`` seconds carry seeded multiplicative jitter of
    +-``jitter`` so the phases are noisy but exactly reproducible."""
    if drain is None:
        drain = base / 2.0
    rng = np.random.default_rng(seed)
    ts, rates = [], []
    t = 0.0
    total = base_s + spike_s + drain_s
    while t < total:
        if t < base_s:
            r = base
        elif t < base_s + spike_s:
            r = spike
        else:
            r = drain
        ts.append(t)
        rates.append(r * rng.uniform(1.0 - jitter, 1.0 + jitter))
        t += knot_s
    return RateTrace(np.asarray(ts), np.asarray(rates))


def surge_trace(*, base: float = 6.0, surge_mult: float = 3.0,
                base_s: float = 8.0, surge_s: float = 30.0,
                recover_s: float = 12.0, jitter: float = 0.05,
                knot_s: float = 1.0, seed: int = 0) -> "RateTrace":
    """Sustained-overload trace: baseline -> ``surge_mult``x plateau ->
    recovery at baseline.

    The brownout workload.  Unlike ``bursty_trace`` (a short spike an
    elastic fleet absorbs by scaling), the surge plateau is LONG —
    ``surge_s`` seconds at ``surge_mult`` times baseline, deliberately past
    the fleet's capacity — so the only question is *how* service degrades:
    collapse (every class's tail blows up together) or a controlled
    brownout (cheap capabilities shed first, interactive traffic protected).
    Knots every ``knot_s`` seconds carry seeded jitter, exactly
    reproducible."""
    rng = np.random.default_rng(seed)
    ts, rates = [], []
    t = 0.0
    total = base_s + surge_s + recover_s
    while t < total:
        if t < base_s or t >= base_s + surge_s:
            r = base
        else:
            r = base * surge_mult
        ts.append(t)
        rates.append(r * rng.uniform(1.0 - jitter, 1.0 + jitter))
        t += knot_s
    return RateTrace(np.asarray(ts), np.asarray(rates))


# per-class service contract of the surge workload: (mix weight, TTFT SLO
# seconds, hard end-to-end deadline seconds).  interactive is tight and
# deadline-bound; batch is loose; best_effort carries an SLO for accounting
# but no hard deadline (it is capped/shed by the brownout ladder instead)
SURGE_CLASSES = {
    "interactive": (0.40, 0.5, 8.0),
    "batch": (0.40, 3.0, 20.0),
    "best_effort": (0.20, 6.0, None),
}


def surge_requests(n: int, *, trace: "RateTrace | None" = None,
                   rate_qps: "float | None" = None,
                   dataset: str = "alpaca", seed: int = 0,
                   max_prompt: int = 2048, max_output: int = 1024,
                   classes: "dict | None" = None) -> List[Request]:
    """Mixed-priority-class arrivals for the overload benchmark.

    Arrivals follow ``trace`` (thinning) when given, else a static Poisson
    at ``rate_qps``.  Each request draws a priority class from the
    ``classes`` mix (default ``SURGE_CLASSES``) which fixes its TTFT SLO
    and hard deadline.  Everything is seeded: two calls with the same
    arguments produce identical streams."""
    rng = np.random.default_rng(seed)
    d = DATASETS[dataset]
    spec = classes if classes is not None else SURGE_CLASSES
    names = list(spec)
    probs = np.asarray([spec[c][0] for c in names], dtype=float)
    probs = probs / probs.sum()
    if trace is not None:
        rmax = float(trace.rates.max())
        arrivals: List[float] = []
        t = 0.0
        while len(arrivals) < n:
            t += rng.exponential(1.0 / rmax)
            if rng.uniform() < trace.rate_at(t) / rmax:
                arrivals.append(t)
    else:
        if rate_qps is None:
            raise ValueError("surge_requests needs a trace or a rate_qps")
        arrivals = list(np.cumsum(rng.exponential(1.0 / rate_qps, size=n)))
    prompts = _lengths(rng, d["p_mu"], d["p_sigma"], n, 4, max_prompt)
    outputs = _lengths(rng, d["o_mu"], d["o_sigma"], n, 4, max_output)
    alphas = rng.beta(d["a_a"], d["a_b"], size=n)
    picks = rng.choice(len(names), size=n, p=probs)
    out = []
    for i in range(n):
        cls = names[int(picks[i])]
        _, slo, deadline = spec[cls]
        out.append(Request(i, float(arrivals[i]), int(prompts[i]),
                           int(outputs[i]), float(alphas[i]), slo=slo,
                           priority=cls, deadline=deadline))
    return out


def cancellation_storm(requests: List[Request], *, frac: float = 0.15,
                       start: float = 0.0, end: float = 10.0,
                       seed: int = 0) -> List[tuple]:
    """Pre-generated client-cancellation schedule: seeded ``frac`` sample
    of the requests arriving before ``end``, each cancelled at a seeded
    time in ``[max(start, arrival), end)``.

    This is the WORKLOAD-level storm: explicit ``(t, req_id)`` pairs
    handed to ``ServingCluster(cancels=...)``, so two bench cells that
    differ only in control policy (brownout on vs off) cancel the SAME
    requests at the SAME instants.  The dynamic in-flight variant —
    victims drawn from whatever happens to be live — is the fault-spec
    ``cancelstorm:`` grammar (serving/faults.py), composable with
    crash/straggler chaos."""
    if not 0.0 < frac <= 1.0:
        raise ValueError("storm frac must be in (0, 1]")
    if end <= start:
        raise ValueError("storm window must have end > start")
    rng = np.random.default_rng(seed)
    cands = [r for r in requests if r.arrival < end]
    if not cands:
        return []
    k = min(max(int(round(frac * len(cands))), 1), len(cands))
    idx = rng.choice(len(cands), size=k, replace=False)
    out = []
    for i in sorted(int(j) for j in idx):
        r = cands[i]
        lo = max(start, r.arrival + 1e-6)
        hi = max(end, lo + 1e-6)
        out.append((float(rng.uniform(lo, hi)), r.req_id))
    return sorted(out)


@dataclass
class RateTrace:
    times: np.ndarray
    rates: np.ndarray

    def rate_at(self, t: float) -> float:
        i = int(np.searchsorted(self.times, t, side="right")) - 1
        return float(self.rates[max(i, 0)])

    def sample_requests(self, n: int, *, dataset: str = "sharegpt",
                        seed: int = 0, max_prompt: int = 2048,
                        max_output: int = 1024,
                        slo: "float | None" = None) -> List[Request]:
        """Non-homogeneous Poisson via thinning."""
        rng = np.random.default_rng(seed)
        d = DATASETS[dataset]
        deadline = dataset_slo(dataset, slo)
        rmax = float(self.rates.max())
        arrivals: List[float] = []
        t = 0.0
        while len(arrivals) < n:
            t += rng.exponential(1.0 / rmax)
            if rng.uniform() < self.rate_at(t) / rmax:
                arrivals.append(t)
        prompts = _lengths(rng, d["p_mu"], d["p_sigma"], n, 4, max_prompt)
        outputs = _lengths(rng, d["o_mu"], d["o_sigma"], n, 4, max_output)
        alphas = rng.beta(d["a_a"], d["a_b"], size=n)
        return [Request(i, arrivals[i], int(prompts[i]), int(outputs[i]),
                        float(alphas[i]), slo=deadline) for i in range(n)]


def templated_requests(rate_qps: float, n: int, *, dataset: str = "templated",
                       template_len: "int | None" = None,
                       num_templates: int = 1, seed: int = 0,
                       max_prompt: int = 2048, max_output: int = 1024,
                       vocab: int = 32000,
                       slo: "float | None" = None) -> List[Request]:
    """Poisson arrivals whose prompts share common template prefixes.

    Every request's ``prompt_tokens`` is one of ``num_templates`` distinct
    ``template_len``-token system prompts (each drawn once from ``seed``;
    the per-request template id is a seeded uniform draw) followed by a
    per-request suffix whose length follows the dataset's prompt
    distribution — the canonical prefix-caching workload, and with
    ``num_templates > 1`` the sticky-routing workload: an affinity router
    can partition the template population across replicas so each
    replica's cache specialises, where load-only routing scatters every
    template onto every replica.  ``template_len=0`` produces fully
    disjoint prompts of the same shape (the caching-off control arm).
    Token ids are synthesised (the simulated tier only hashes them; the
    real tier can cap ``vocab`` to the model's)."""
    rng = np.random.default_rng(seed)
    d = DATASETS[dataset]
    if template_len is None:
        template_len = d.get("template_len", 0)
    deadline = dataset_slo(dataset, slo)
    # num_templates == 1 keeps the historical draw order byte-identical
    templates = [rng.integers(0, vocab, size=template_len).tolist()
                 for _ in range(max(num_templates, 1))]
    tids = (rng.integers(0, num_templates, size=n)
            if num_templates > 1 else np.zeros(n, dtype=int))
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    arrivals = np.cumsum(gaps)
    suffixes = _lengths(rng, d["p_mu"], d["p_sigma"], n, 4,
                        max(max_prompt - template_len, 4))
    outputs = _lengths(rng, d["o_mu"], d["o_sigma"], n, 4, max_output)
    alphas = rng.beta(d["a_a"], d["a_b"], size=n)
    out = []
    for i in range(n):
        sfx = rng.integers(0, vocab, size=int(suffixes[i])).tolist()
        toks = templates[int(tids[i])] + sfx
        out.append(Request(i, float(arrivals[i]), len(toks),
                           int(outputs[i]), float(alphas[i]),
                           prompt_tokens=toks, slo=deadline))
    return out


def mixed_requests(rate_qps: float, n: int, *, dataset: str = "mixed",
                   qa_frac: "float | None" = None, seed: int = 0,
                   max_prompt: int = 2048, max_output: int = 1024,
                   slo: "float | None" = None) -> List[Request]:
    """Poisson arrivals from a bimodal long-prompt / long-decode mix.

    Each request is independently a document-QA request (probability
    ``qa_frac``: long prompt, short answer — prefill-bound) or a generation
    request (short prompt, long completion — decode-bound).  The
    disaggregation workload: on a colocated fleet the resident long decodes
    consume the chunked-prefill token budget and KV pool on every replica,
    queueing the long prompts behind them; a disaggregated fleet prefills
    where no decode lives and decodes where no prompt lands."""
    rng = np.random.default_rng(seed)
    d = DATASETS[dataset]
    deadline = dataset_slo(dataset, slo)
    if qa_frac is None:
        qa_frac = d.get("qa_frac", 0.5)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    arrivals = np.cumsum(gaps)
    is_qa = rng.uniform(size=n) < qa_frac
    qa_p = _lengths(rng, d["qa_p_mu"], d["qa_p_sigma"], n, 4, max_prompt)
    qa_o = _lengths(rng, d["qa_o_mu"], d["qa_o_sigma"], n, 4, max_output)
    gen_p = _lengths(rng, d["gen_p_mu"], d["gen_p_sigma"], n, 4, max_prompt)
    gen_o = _lengths(rng, d["gen_o_mu"], d["gen_o_sigma"], n, 4, max_output)
    alphas = rng.beta(d["a_a"], d["a_b"], size=n)
    return [Request(i, float(arrivals[i]),
                    int(qa_p[i]) if is_qa[i] else int(gen_p[i]),
                    int(qa_o[i]) if is_qa[i] else int(gen_o[i]),
                    float(alphas[i]), slo=deadline) for i in range(n)]


def session_requests(n_sessions: int, *, turns: "int | None" = None,
                     rate_qps: float = 0.5, think_s: "float | None" = None,
                     context_len: "int | None" = None,
                     dataset: str = "sessions", seed: int = 0,
                     vocab: int = 32000, max_user: int = 512,
                     max_output: int = 256,
                     slo: "float | None" = None) -> List[Request]:
    """Multi-turn chat sessions with think-time returns and history-growing
    prompts.

    Session starts are Poisson at ``rate_qps``.  Each session opens with a
    ``context_len``-token pasted context (system prompt / document) plus a
    user message; every later turn re-submits the FULL history — previous
    prompt, the synthesised assistant response (``o_*``-distributed length),
    and a fresh user message — after an exponential think-time gap (mean
    ``think_s``, floored at 1s so a turn rarely returns before its
    predecessor finishes).  Turn k's prompt therefore extends turn k-1's
    prompt exactly, which makes warm turns the canonical prefix-restore
    workload: registered history blocks match byte-for-byte, while the gap
    gives a tight device pool time to evict them.

    ``Request.session``/``Request.turn`` tag each request for warm/cold
    TTFT splits; req_ids are assigned in global arrival order."""
    rng = np.random.default_rng(seed)
    d = DATASETS[dataset]
    turns = int(turns if turns is not None else d.get("turns", 6))
    think = float(think_s if think_s is not None else d.get("think_s", 8.0))
    ctx_len = int(context_len if context_len is not None
                  else d.get("context_len", 768))
    deadline = dataset_slo(dataset, slo)
    starts = np.cumsum(rng.exponential(1.0 / rate_qps, size=n_sessions))
    rows = []   # (arrival, session, turn, prompt_tokens, output_len, alpha)
    for sid in range(n_sessions):
        history = rng.integers(0, vocab, size=ctx_len).tolist()
        t = float(starts[sid])
        alpha = float(rng.beta(d["a_a"], d["a_b"]))
        for k in range(turns):
            user_len = int(_lengths(rng, d["p_mu"], d["p_sigma"],
                                    1, 4, max_user)[0])
            prompt = history + rng.integers(0, vocab, size=user_len).tolist()
            out_len = int(_lengths(rng, d["o_mu"], d["o_sigma"],
                                   1, 4, max_output)[0])
            rows.append((t, sid, k, prompt, out_len, alpha))
            # the assistant's (synthesised) response joins the history the
            # next turn re-submits; the think-time gap moves the arrival
            history = prompt + rng.integers(0, vocab, size=out_len).tolist()
            t += 1.0 + float(rng.exponential(think))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    return [Request(i, arr, len(p), out, alpha, prompt_tokens=p,
                    slo=deadline, session=sid, turn=k)
            for i, (arr, sid, k, p, out, alpha) in enumerate(rows)]


def split_requests(requests: List[Request], n_replicas: int
                   ) -> List[List[Request]]:
    """Deterministically split ONE arrival stream across N replicas.

    Round-robin in arrival order (ties broken by req_id), preserving each
    request's absolute arrival time — the static-partition baseline against
    the dynamic routers in serving/router.py, and the tool for replaying the
    same global trace against fleets of different sizes."""
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    shards: List[List[Request]] = [[] for _ in range(n_replicas)]
    for i, req in enumerate(sorted(requests,
                                   key=lambda r: (r.arrival, r.req_id))):
        shards[i % n_replicas].append(req)
    return shards


def tiny_requests(n: int, *, rate_qps: float = 100.0, prompt_len: int = 16,
                  output_len: int = 8, seed: int = 0, vocab: int = 256,
                  alpha: float = 0.9, template_len: int = 0) -> List[Request]:
    """Small deterministic workload for the real-execution tier / tests.

    ``template_len > 0`` makes the first that many prompt tokens identical
    across all requests (shared system prompt), the tiny analogue of
    :func:`templated_requests` for prefix-caching tests."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    arrivals = np.cumsum(gaps)
    template = rng.integers(0, vocab,
                            size=min(template_len, prompt_len)).tolist()
    out = []
    for i in range(n):
        sfx = rng.integers(0, vocab,
                           size=prompt_len - len(template)).tolist()
        out.append(Request(i, float(arrivals[i]), prompt_len, output_len,
                           alpha, prompt_tokens=template + sfx))
    return out
