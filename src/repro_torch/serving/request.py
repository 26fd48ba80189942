"""Request and sequence lifecycle for the serving engine."""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

# Bounded per-step timeline: when timeline recording is opted in, the
# per-step dicts live in a ring of this many entries (oldest evicted
# first) instead of an unbounded list, so long benches that never read
# the timeline stop accumulating memory for it.
TIMELINE_RING_CAP = 65_536

# Priority classes in descending importance.  Admission sheds and the
# scheduler preempts lowest-class-first; within a class age order rules
# (oldest request wins), so a single-class workload behaves exactly as
# before the classes existed.
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")


def class_rank(priority: str) -> int:
    """0 = most important.  Unknown classes rank below every known one
    (they shed first) rather than raising mid-dispatch."""
    try:
        return PRIORITY_CLASSES.index(priority)
    except ValueError:
        return len(PRIORITY_CLASSES)


@dataclass
class Request:
    req_id: int
    arrival: float            # seconds
    prompt_len: int
    output_len: int
    alpha: float = 0.8        # per-token draft-acceptance quality (sim tier)
    prompt_tokens: Optional[List[int]] = None  # real tier
    slo: Optional[float] = None  # TTFT deadline (s) for goodput accounting
    session: Optional[int] = None  # multi-turn session id (sessions dataset)
    turn: int = 0             # 0 = cold first turn, >0 = warm return turn
    priority: str = "interactive"  # one of PRIORITY_CLASSES
    deadline: Optional[float] = None  # hard end-to-end budget (s past
                                      # arrival); expired requests are
                                      # reaped, not finished


@dataclass
class Sequence:
    """A request admitted to the running batch."""

    request: Request
    slot: int = -1
    generated: int = 0
    prefilled: int = 0        # prompt tokens whose KV is materialised; under
                              # chunked prefill this grows chunk by chunk
    cached_tokens: int = 0    # prompt tokens admitted from the prefix cache
                              # (shared blocks — no prefill compute needed)
    delta: int = 0            # draft-model skip length (tokens missing from
                              # the draft KV cache) — drives C_switch lookup
    prefill_done_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def prompt_remaining(self) -> int:
        """Prompt tokens still awaiting prefill (0 = decode-ready)."""
        return self.request.prompt_len - self.prefilled

    @property
    def context_len(self) -> int:
        return self.request.prompt_len + self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.request.output_len


def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolation percentile (numpy-free, deterministic).

    An empty sample returns 0.0 by contract — indistinguishable from a
    true zero-latency percentile, so table renderers must gate on the
    sample COUNT and print ``n/a`` for empty cells (see
    benchmarks/make_tables.py; edge cases pinned in
    tests/test_metrics_edges.py)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = (len(s) - 1) * q
    lo = int(k)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


@dataclass
class RequestStats:
    """Per-request record for tail-latency / SLO accounting."""

    req_id: int
    arrival: float
    ttft: float               # first-token latency (s)
    tpot: float               # time per output token after the first (s)
    tokens: int               # committed output tokens
    slo: Optional[float]      # TTFT deadline, None = no deadline
    cached_tokens: int = 0    # prompt tokens admitted from the prefix cache
    turn: int = 0             # session turn (warm/cold TTFT split)
    priority: str = "interactive"  # priority class (per-class SLO splits)

    @property
    def slo_met(self) -> bool:
        return self.slo is None or self.ttft <= self.slo


def slo_attainment_of(requests: List["RequestStats"]) -> float:
    """Fraction of deadline-carrying requests that met their TTFT SLO
    (1.0 when no request carries a deadline)."""
    with_slo = [r for r in requests if r.slo is not None]
    if not with_slo:
        return 1.0
    return sum(r.slo_met for r in with_slo) / len(with_slo)


def goodput_of(requests: List["RequestStats"], elapsed: float,
               throughput: float) -> float:
    """Tokens/s counting only requests that met their TTFT SLO (AdaSpec-style
    goodput; falls back to raw throughput when no per-request stats exist).

    Zero/negative ``elapsed`` returns 0.0 by contract (no time base — the
    rate is undefined, not perfect); renderers must treat a cell with no
    finished requests as ``n/a``, not 0 (pinned in
    tests/test_metrics_edges.py)."""
    if elapsed <= 0:
        return 0.0
    if not requests:
        return throughput
    return sum(r.tokens for r in requests if r.slo_met) / elapsed


@dataclass
class Metrics:
    """Aggregated per-run serving metrics."""

    total_tokens: int = 0
    elapsed: float = 0.0
    latencies: List[float] = field(default_factory=list)   # per-request e2e
    ttfts: List[float] = field(default_factory=list)
    timeline: List[dict] = field(default_factory=list)     # per-step records
    requests: List[RequestStats] = field(default_factory=list)
    switch_count: int = 0
    offload_events: int = 0
    reload_events: int = 0
    blocks_allocated: int = 0              # cumulative free-list acquisitions
    prefix: dict = field(default_factory=dict)  # prefix-cache counters
    host: dict = field(default_factory=dict)    # host KV tier counters
                                                # (spills/restores/latency)
    fault_injected_s: float = 0.0  # extra seconds injected by straggler
                                   # fault windows (latency multiplier)
    cancelled: List[dict] = field(default_factory=list)  # client-cancelled
                                   # requests: {req_id, at, priority, slo}
    expired: List[dict] = field(default_factory=list)    # deadline-reaped
                                   # requests: {req_id, at, priority, slo}
    spec: dict = field(default_factory=dict)  # per-gamma speculation
                                   # aggregates (see note_spec_step)

    def use_timeline_ring(self, cap: int = TIMELINE_RING_CAP) -> None:
        """Bound the per-step timeline to a ring of ``cap`` entries.

        Called by the engine when timeline recording is opted in; existing
        entries are preserved (newest-first survival on overflow)."""
        if not isinstance(self.timeline, deque):
            self.timeline = deque(self.timeline, maxlen=cap)

    def note_spec_step(self, batch: int, gamma: int, committed: int,
                       latency: float, *, forced_off: bool = False,
                       restarted: bool = False) -> None:
        """Fold one engine step's (batch, gamma, n_accepted) observation —
        the same tuple the MAB planner sees — into per-gamma aggregates.

        ``committed`` is total committed tokens for the step; with
        speculation on, each sequence commits its accepted draft tokens
        plus one verified token, so accepted = committed - batch."""
        sp = self.spec
        if not sp:
            sp.update(steps=0, spec_steps=0, forced_off_steps=0, restarts=0,
                      per_gamma={})
        sp["steps"] += 1
        if forced_off:
            sp["forced_off_steps"] += 1
        if restarted:
            sp["restarts"] += 1
        if gamma > 0:
            sp["spec_steps"] += 1
        g = sp["per_gamma"].setdefault(
            gamma, {"steps": 0, "proposed": 0, "accepted": 0,
                    "committed": 0, "latency_s": 0.0})
        g["steps"] += 1
        g["committed"] += committed
        g["latency_s"] += latency
        if gamma > 0:
            g["proposed"] += gamma * batch
            g["accepted"] += max(committed - batch, 0)

    def spec_summary(self) -> dict:
        """Speculation aggregates for ``summary()`` — acceptance rate per
        gamma, spec-off step fraction, and speculation restart count."""
        sp = self.spec
        steps = sp.get("steps", 0)
        per_gamma = {}
        for gamma in sorted(sp.get("per_gamma", {})):
            g = sp["per_gamma"][gamma]
            row = {
                "steps": g["steps"],
                "committed_tokens": g["committed"],
                "latency_per_committed_s": round(
                    g["latency_s"] / g["committed"], 6)
                if g["committed"] else 0.0,
            }
            if gamma > 0:
                row["acceptance_rate"] = round(
                    g["accepted"] / g["proposed"], 4) if g["proposed"] \
                    else 0.0
            per_gamma[str(gamma)] = row
        return {
            "steps": steps,
            "spec_step_fraction": round(sp.get("spec_steps", 0) / steps, 4)
            if steps else 0.0,
            "spec_off_step_fraction": round(
                1.0 - sp.get("spec_steps", 0) / steps, 4) if steps else 0.0,
            "forced_off_steps": sp.get("forced_off_steps", 0),
            "restarts": sp.get("restarts", 0),
            "per_gamma": per_gamma,
        }

    def record_finish(self, seq: Sequence, now: float) -> None:
        """Stamp a completed sequence into the per-request stats."""
        first = seq.first_token_at if seq.first_token_at is not None else now
        ttft = first - seq.request.arrival
        tpot = (now - first) / max(seq.generated - 1, 1)
        self.requests.append(RequestStats(
            req_id=seq.req_id, arrival=seq.request.arrival, ttft=ttft,
            tpot=tpot, tokens=seq.generated, slo=seq.request.slo,
            cached_tokens=seq.cached_tokens, turn=seq.request.turn,
            priority=seq.request.priority))

    @property
    def throughput(self) -> float:
        return self.total_tokens / self.elapsed if self.elapsed else 0.0

    @property
    def mean_latency(self) -> float:
        return sum(self.latencies) / len(self.latencies) if self.latencies else 0.0

    @property
    def mean_ttft(self) -> float:
        return sum(self.ttfts) / len(self.ttfts) if self.ttfts else 0.0

    @property
    def tpots(self) -> List[float]:
        return [r.tpot for r in self.requests]

    def ttft_percentile(self, q: float) -> float:
        return percentile([r.ttft for r in self.requests] or self.ttfts, q)

    def tpot_percentile(self, q: float) -> float:
        return percentile(self.tpots, q)

    @property
    def p99_ttft(self) -> float:
        return self.ttft_percentile(0.99)

    @property
    def slo_attainment(self) -> float:
        return slo_attainment_of(self.requests)

    @property
    def goodput(self) -> float:
        return goodput_of(self.requests, self.elapsed, self.throughput)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prefix-cache lookups that admitted shared blocks."""
        if not self.prefix or not self.prefix.get("queries"):
            return 0.0
        return self.prefix["hits"] / self.prefix["queries"]

    def summary(self) -> dict:
        out = self._base_summary()
        if self.prefix:
            out.update({
                "prefix_hit_rate": round(self.prefix_hit_rate, 4),
                "prefix_saved_tokens": self.prefix.get("saved_tokens", 0),
                "prefix_shared_blocks": self.prefix.get("shared_blocks", 0),
                "prefix_forks": self.prefix.get("forks", 0),
                "prefix_evictions": self.prefix.get("evictions", 0),
            })
        if self.host:
            out.update({
                "host_spills": int(self.host.get("spills", 0)),
                "host_restores": int(self.host.get("restores", 0)),
                "host_spill_s": round(self.host.get("spill_s", 0.0), 4),
                "host_restore_s": round(self.host.get("restore_s", 0.0), 4),
            })
        if self.fault_injected_s:
            out["fault_injected_s"] = round(self.fault_injected_s, 4)
        if self.cancelled or self.expired:
            out["cancelled"] = len(self.cancelled)
            out["expired"] = len(self.expired)
        if self.spec:
            out["spec"] = self.spec_summary()
        return out

    def _base_summary(self) -> dict:
        return {
            "throughput_tok_s": round(self.throughput, 2),
            "mean_latency_s": round(self.mean_latency, 4),
            "mean_ttft_s": round(self.mean_ttft, 4),
            "p50_ttft_s": round(self.ttft_percentile(0.50), 4),
            "p95_ttft_s": round(self.ttft_percentile(0.95), 4),
            "p99_ttft_s": round(self.ttft_percentile(0.99), 4),
            "p50_tpot_s": round(self.tpot_percentile(0.50), 5),
            "p99_tpot_s": round(self.tpot_percentile(0.99), 5),
            "slo_attainment": round(self.slo_attainment, 4),
            "goodput_tok_s": round(self.goodput, 2),
            "total_tokens": self.total_tokens,
            "elapsed_s": round(self.elapsed, 3),
            "switches": self.switch_count,
            "offloads": self.offload_events,
            "reloads": self.reload_events,
            "blocks_allocated": self.blocks_allocated,
        }
