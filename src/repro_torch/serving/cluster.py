"""Multi-replica serving cluster on a shared virtual event clock.

``ServingCluster`` owns N independent :class:`ServingEngine` replicas — each
with its own :class:`ContinuousBatchingScheduler`, MAB planner and
:class:`ElasticMemoryManager` — plus one :class:`Router` that dispatches a
single global arrival stream across them.  This is the fleet tier the paper
motivates ("dynamic request rates from millions of users"): per-replica
planners adapt their speculative length *independently* to the load each
replica actually sees.

Event-clock semantics
---------------------
Every engine advances its own virtual clock as it executes steps; the
cluster interleaves them with a classic discrete-event loop:

  1. the next *engine* event is ``min over replicas of peek_next_event()``;
  2. the next *arrival* event is the head of the global request stream;
  3. whichever is earlier happens: an arrival is admitted (or shed), routed
     (based on replica state observed *now*) and submitted, or the
     earliest-clock replica executes one ``step()``.

Because a replica is only stepped when it holds the minimum clock, replica
timelines interleave correctly in virtual time, and routing decisions see
queue/KV state no newer than the arrival instant — the same information a
real front-end would have.

Control plane (serving/controlplane.py)
---------------------------------------
Every cluster owns a :class:`ControlPlane` (telemetry-only by default).
After each replica step the plane consumes the replica's freshly finished
request stats (the EWMA TTFT/TPOT predictors and the forecast-residual
bias); at each arrival the cluster consults, in order:

  * the **autoscaler** — may ``add_replica`` (a fresh engine joins at the
    current virtual time) or ``drain_replica`` (the least-loaded replica
    stops receiving traffic, finishes its running work, then retires);
  * the **admission controller** — may *shed* the arrival at the door when
    even the best replica's predicted TTFT is hopeless (recorded in
    ``ClusterMetrics.shed``, never as an SLO miss of admitted traffic);
  * the **router** — dispatches over the routable (non-draining) replicas.

Determinism: engines, router tie-breaks, telemetry, controllers and
workload generation are all seeded/deterministic, so a cluster run is
exactly reproducible — two runs of the same config produce byte-identical
routing decisions (golden-value tested against the reference in
tests/test_torch_cluster.py).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from .controlplane import (BrownoutController, ControlPlane,
                           DecodePoolAutoscaler, HandoffPricer)
from .engine import ServingEngine
from .faults import FaultInjector, RetryPolicy
from .request import (Metrics, Request, RequestStats, goodput_of, percentile,
                      slo_attainment_of)
from .router import Router

# replica lifecycle states.  FAILED is distinct from DRAINING: a draining
# replica finishes the work it owns; a failed replica's in-flight work is
# LOST (its blocks are gone) and must be re-dispatched elsewhere.
ACTIVE, DRAINING, RETIRED, FAILED = "active", "draining", "retired", "failed"

# replica roles (disaggregated mode; COLOCATED is the classic do-everything
# replica of a non-disaggregated cluster)
PREFILL, DECODE, COLOCATED = "prefill", "decode", "colocated"


@dataclass
class ClusterMetrics:
    """Aggregate + per-replica metrics for one cluster run."""

    per_replica: List[Metrics]
    elapsed: float = 0.0              # virtual makespan across replicas
    assignments: Dict[int, int] = field(default_factory=dict)  # req -> replica
    shed: List[dict] = field(default_factory=list)   # rejected at the door
    autoscale_events: List[dict] = field(default_factory=list)
    replica_states: List[str] = field(default_factory=list)
    replica_spans: List[tuple] = field(default_factory=list)  # (start, end)
    replica_roles: List[str] = field(default_factory=list)
    handoffs: List[dict] = field(default_factory=list)  # prefill->decode
    handoffs_declined: int = 0        # pricer chose colocated fallback
    handoff_transfer_s: float = 0.0   # total modelled interconnect time
    handoff_fallbacks: int = 0        # adoptions that re-prefilled locally
    handoff_failures: int = 0         # injected transfer failures
    handoff_timeouts: int = 0         # injected transfer timeouts
    handoff_retries: int = 0          # transfer retries after a fault
    handoff_aborts: int = 0           # retry budget exhausted -> colocated
    # fault tolerance (serving/faults.py): one dict per replica crash with
    # at/replica/lost/detected_at/recovered_at stamps
    crashes: List[dict] = field(default_factory=list)
    requeues: int = 0                 # crashed requests re-submitted
    retries: int = 0                  # retry attempts scheduled
    failed_requests: List[dict] = field(default_factory=list)  # budget spent
    # overload lifecycle (brownout ladder + request cancellation)
    brownout_events: List[dict] = field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return sum(m.total_tokens for m in self.per_replica)

    @property
    def throughput(self) -> float:
        return self.total_tokens / self.elapsed if self.elapsed else 0.0

    @property
    def latencies(self) -> List[float]:
        return [x for m in self.per_replica for x in m.latencies]

    @property
    def ttfts(self) -> List[float]:
        return [x for m in self.per_replica for x in m.ttfts]

    @property
    def mean_latency(self) -> float:
        lat = self.latencies
        return sum(lat) / len(lat) if lat else 0.0

    @property
    def mean_ttft(self) -> float:
        t = self.ttfts
        return sum(t) / len(t) if t else 0.0

    @property
    def requests(self) -> List[RequestStats]:
        return [r for m in self.per_replica for r in m.requests]

    def ttft_percentile(self, q: float) -> float:
        reqs = self.requests
        return percentile([r.ttft for r in reqs] or self.ttfts, q)

    def tpot_percentile(self, q: float) -> float:
        return percentile([r.tpot for r in self.requests], q)

    @property
    def p99_ttft(self) -> float:
        return self.ttft_percentile(0.99)

    @property
    def slo_attainment(self) -> float:
        """Attainment of ADMITTED deadline-carrying traffic (shed requests
        are accounted separately — see ``slo_attainment_offered``)."""
        return slo_attainment_of(self.requests)

    @property
    def offered_slo_count(self) -> int:
        """Deadline-carrying requests in the offered load: finished ones
        plus shed ones — the sample count behind
        ``slo_attainment_offered`` (renderer gate)."""
        return (sum(1 for r in self.requests if r.slo is not None)
                + sum(1 for s in self.shed if s.get("slo") is not None))

    @property
    def slo_attainment_offered(self) -> Optional[float]:
        """Attainment over the OFFERED load: shed deadline-carrying
        requests count as misses (the honest fleet-level number).

        ``None`` when the offered load carries no deadline samples at all
        (e.g. every request shed before any deadline-carrying one
        finished) — n/a by contract, never a fake-perfect ratio
        (tests/test_metrics_edges.py convention)."""
        with_slo = [r for r in self.requests if r.slo is not None]
        shed_slo = sum(1 for s in self.shed if s.get("slo") is not None)
        total = len(with_slo) + shed_slo
        if total == 0:
            return None
        return sum(r.slo_met for r in with_slo) / total

    @property
    def shed_count(self) -> int:
        return len(self.shed)

    @property
    def cancelled(self) -> List[dict]:
        """Client-cancelled requests across the fleet."""
        return [c for m in self.per_replica for c in m.cancelled]

    @property
    def expired(self) -> List[dict]:
        """Deadline-reaped requests across the fleet."""
        return [e for m in self.per_replica for e in m.expired]

    def class_summary(self) -> Dict[str, dict]:
        """Per-priority-class lifecycle accounting: every offered request
        lands in exactly one terminal bucket (finished / shed / cancelled /
        expired / failed), plus per-class TTFT-SLO attainment of finished
        traffic (None when the class carries no deadline samples — n/a by
        contract, never a fake-perfect ratio)."""
        classes: Dict[str, dict] = {}

        def bucket(cls: str) -> dict:
            return classes.setdefault(cls, {
                "finished": 0, "shed": 0, "cancelled": 0, "expired": 0,
                "failed": 0, "offered": 0,
                "slo_samples": 0, "slo_met": 0})

        for r in self.requests:
            b = bucket(r.priority)
            b["finished"] += 1
            if r.slo is not None:
                b["slo_samples"] += 1
                b["slo_met"] += int(r.slo_met)
        for s in self.shed:
            bucket(s.get("priority", "interactive"))["shed"] += 1
        for c in self.cancelled:
            bucket(c.get("priority", "interactive"))["cancelled"] += 1
        for e in self.expired:
            bucket(e.get("priority", "interactive"))["expired"] += 1
        for f in self.failed_requests:
            bucket(f.get("priority", "interactive"))["failed"] += 1
        for b in classes.values():
            b["offered"] = (b["finished"] + b["shed"] + b["cancelled"]
                            + b["expired"] + b["failed"])
            b["slo_attainment"] = (round(b["slo_met"] / b["slo_samples"], 4)
                                   if b["slo_samples"] else None)
        return classes

    @property
    def goodput(self) -> float:
        """Fleet tokens/s from requests that met their TTFT SLO."""
        return goodput_of(self.requests, self.elapsed, self.throughput)

    @property
    def prefix_hit_rate(self) -> float:
        """Aggregate prefix-cache hit rate across the fleet."""
        q = sum(m.prefix.get("queries", 0) for m in self.per_replica)
        h = sum(m.prefix.get("hits", 0) for m in self.per_replica)
        return h / q if q else 0.0

    @property
    def mttd(self) -> Optional[float]:
        """Mean time-to-detect across crashes (crash -> detector firing).
        ``None`` when no crash was detected — n/a by contract, never a
        fake-free 0.0 (tests/test_metrics_edges.py convention)."""
        ds = [c["detected_at"] - c["at"] for c in self.crashes
              if c.get("detected_at") is not None]
        return sum(ds) / len(ds) if ds else None

    @property
    def mttr(self) -> Optional[float]:
        """Mean time-to-recover across crashes (crash -> last lost request
        re-dispatched).  ``None`` when no crash completed recovery."""
        rs = [c["recovered_at"] - c["at"] for c in self.crashes
              if c.get("recovered_at") is not None]
        return sum(rs) / len(rs) if rs else None

    @property
    def recovery_seconds(self) -> Optional[float]:
        """Total virtual seconds spent in crash recovery windows; ``None``
        when no crash recovered (n/a, not free)."""
        rs = [c["recovered_at"] - c["at"] for c in self.crashes
              if c.get("recovered_at") is not None]
        return sum(rs) if rs else None

    @property
    def peak_replicas(self) -> int:
        """Most replicas simultaneously non-retired at any arrival/step."""
        if not self.replica_spans:
            return len(self.per_replica)
        events = []
        for start, end in self.replica_spans:
            events.append((start, 1))
            events.append((end, -1))
        peak = cur = 0
        for _, d in sorted(events, key=lambda e: (e[0], -e[1])):
            cur += d
            peak = max(peak, cur)
        return peak

    @property
    def replica_seconds(self) -> float:
        """Total replica-occupancy (virtual seconds summed over replicas)
        — the capacity cost an autoscaled fleet actually paid."""
        return sum(max(end - start, 0.0)
                   for start, end in self.replica_spans)

    def replica_counts(self) -> List[int]:
        """Requests routed to each replica."""
        n = len(self.per_replica)
        counts = [0] * n
        for idx in self.assignments.values():
            counts[idx] += 1
        return counts

    def per_replica_summary(self) -> List[dict]:
        """Per-replica breakdown: the control-plane observability surface."""
        counts = self.replica_counts()
        out = []
        for i, m in enumerate(self.per_replica):
            # a replica that completed zero requests (retired mid-drain,
            # or every request it saw was shed upstream) has NO latency
            # samples: percentile() would report a fake-perfect 0.0 and
            # slo_attainment a fake-perfect 1.0.  n/a by contract instead
            # (tests/test_metrics_edges.py) — `finished` is the gate.
            n = len(m.requests)
            row = {
                "replica": i,
                "state": (self.replica_states[i]
                          if i < len(self.replica_states) else ACTIVE),
                "role": (self.replica_roles[i]
                         if i < len(self.replica_roles) else COLOCATED),
                "requests": counts[i],
                "finished": n,
                "tok_s": round(m.throughput, 2),
                "p99_ttft_s": round(m.ttft_percentile(0.99), 4) if n else None,
                "slo_attainment": round(m.slo_attainment, 4) if n else None,
                "offloads": m.offload_events,
            }
            if m.prefix:
                row["prefix_hit_rate"] = round(m.prefix_hit_rate, 4)
            out.append(row)
        return out

    def spec_summary(self) -> dict:
        """Fleet-wide speculation aggregates: fold every replica's raw
        per-gamma counters into one Metrics and reuse its formatting, so
        cluster and single-engine summaries agree by construction."""
        merged = Metrics()
        for m in self.per_replica:
            sp = m.spec
            if not sp:
                continue
            ms = merged.spec
            if not ms:
                ms.update(steps=0, spec_steps=0, forced_off_steps=0,
                          restarts=0, per_gamma={})
            for k in ("steps", "spec_steps", "forced_off_steps", "restarts"):
                ms[k] += sp.get(k, 0)
            for gamma, g in sp.get("per_gamma", {}).items():
                t = ms["per_gamma"].setdefault(
                    gamma, {"steps": 0, "proposed": 0, "accepted": 0,
                            "committed": 0, "latency_s": 0.0})
                for k in t:
                    t[k] += g[k]
        return merged.spec_summary()

    def summary(self) -> dict:
        out = {
            "replicas": len(self.per_replica),
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
            "per_replica_tok_s": [round(m.throughput, 2)
                                  for m in self.per_replica],
            "per_replica_requests": self.replica_counts(),
            "per_replica": self.per_replica_summary(),
            "switches": sum(m.switch_count for m in self.per_replica),
            "offloads": sum(m.offload_events for m in self.per_replica),
            "reloads": sum(m.reload_events for m in self.per_replica),
            "blocks_allocated": sum(m.blocks_allocated
                                    for m in self.per_replica),
        }
        if self.shed or self.autoscale_events:
            out["shed_count"] = self.shed_count
            offered = self.slo_attainment_offered
            out["offered_slo_count"] = self.offered_slo_count
            out["slo_attainment_offered"] = (
                round(offered, 4) if offered is not None else None)
        if self.autoscale_events:
            out["peak_replicas"] = self.peak_replicas
            out["replica_seconds"] = round(self.replica_seconds, 3)
            out["autoscale"] = {
                "adds": sum(1 for e in self.autoscale_events
                            if e["kind"] == "add"),
                "drains": sum(1 for e in self.autoscale_events
                              if e["kind"] == "drain"),
                "retires": sum(1 for e in self.autoscale_events
                               if e["kind"] == "retire"),
            }
        if (self.handoffs or self.handoffs_declined
                or self.handoff_failures or self.handoff_timeouts
                or self.handoff_aborts):
            out["disagg"] = {
                "handoffs": len(self.handoffs),
                "declined": self.handoffs_declined,
                "transfer_s": round(self.handoff_transfer_s, 4),
                "adopt_fallbacks": self.handoff_fallbacks,
            }
            if (self.handoff_failures or self.handoff_timeouts
                    or self.handoff_aborts):
                out["disagg"].update({
                    "transfer_failures": self.handoff_failures,
                    "transfer_timeouts": self.handoff_timeouts,
                    "transfer_retries": self.handoff_retries,
                    "transfer_aborts": self.handoff_aborts,
                })
        if self.crashes or self.requeues or self.failed_requests:
            mttd, mttr = self.mttd, self.mttr
            out["faults"] = {
                "crashes": len(self.crashes),
                "requests_lost": sum(c["lost"] for c in self.crashes),
                "requeues": self.requeues,
                "retries": self.retries,
                "failed_requests": len(self.failed_requests),
                "mttd_s": round(mttd, 4) if mttd is not None else None,
                "mttr_s": round(mttr, 4) if mttr is not None else None,
            }
        cancelled, expired = self.cancelled, self.expired
        multi_class = len({r.priority for r in self.requests}
                          | {s.get("priority", "interactive")
                             for s in self.shed}) > 1
        if cancelled or expired or self.brownout_events or multi_class:
            out["cancelled"] = len(cancelled)
            out["expired"] = len(expired)
            out["per_class"] = self.class_summary()
        if self.brownout_events:
            out["brownout"] = {
                "transitions": len(self.brownout_events),
                "max_stage": max(e["stage"] for e in self.brownout_events),
                "stages_entered": sorted({e["to"]
                                          for e in self.brownout_events}),
            }
        if any(m.spec for m in self.per_replica):
            out["spec"] = self.spec_summary()
        if any(m.prefix for m in self.per_replica):
            out["prefix_saved_tokens"] = sum(
                m.prefix.get("saved_tokens", 0) for m in self.per_replica)
            out["prefix_hits"] = sum(
                m.prefix.get("hits", 0) for m in self.per_replica)
            out["prefix_hit_rate"] = round(self.prefix_hit_rate, 4)
        return out


class ServingCluster:
    def __init__(self, replicas: Sequence[ServingEngine], router: Router,
                 *, control: Optional[ControlPlane] = None,
                 replica_factory: Optional[
                     Callable[[int], ServingEngine]] = None,
                 roles: Optional[Sequence[str]] = None,
                 pricer: Optional[HandoffPricer] = None,
                 decode_autoscaler: Optional[DecodePoolAutoscaler] = None,
                 faults: Optional[FaultInjector] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 handoff_max_retries: int = 2,
                 brownout: Optional[BrownoutController] = None,
                 cancels: Optional[Sequence[tuple]] = None):
        if not replicas:
            raise ValueError("cluster needs at least one replica")
        self.replicas = list(replicas)
        self.faults = faults
        # fleet brownout ladder + pre-scheduled client cancellations
        # ((t, req_id) pairs — e.g. workload.cancellation_storm); both None
        # by default, leaving the event order byte-identical to before
        self.brownout = brownout
        self.cancels = list(cancels) if cancels else []
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy()
        self.handoff_max_retries = handoff_max_retries
        for i, eng in enumerate(self.replicas):
            eng.replica_id = i
            eng.faults = faults
        self.router = router
        self.control = control if control is not None else ControlPlane()
        # headroom-based routers share the cluster's telemetry book
        if getattr(router, "control", None) is None:
            router.control = self.control
        self.replica_factory = replica_factory
        self.state: List[str] = [ACTIVE] * len(self.replicas)
        # disaggregated mode: arrivals land on the PREFILL pool; once a
        # request's prompt is fully materialised its KV blocks may migrate
        # to a DECODE replica (priced per-handoff by `pricer`).  roles=None
        # is the classic colocated cluster, unchanged.
        self.disaggregated = roles is not None
        if roles is not None:
            roles = list(roles)
            if len(roles) != len(self.replicas):
                raise ValueError("roles must match replicas")
            bad = set(roles) - {PREFILL, DECODE}
            if bad:
                raise ValueError(f"unknown roles {sorted(bad)}")
            if PREFILL not in roles:
                raise ValueError("disaggregated cluster needs >=1 prefill "
                                 "replica")
            self.roles: List[str] = roles
        else:
            self.roles = [COLOCATED] * len(self.replicas)
        self.pricer = pricer
        if self.disaggregated and self.pricer is None:
            self.pricer = HandoffPricer(self.control)
        self.decode_autoscaler = decode_autoscaler
        self.assignments: Dict[int, int] = {}
        self.shed: List[dict] = []
        self.autoscale_events: List[dict] = []
        self.handoffs: List[dict] = []
        self.handoff_transfer_s = 0.0
        self._handoff_considered: set = set()
        self._starts = [e.clock for e in self.replicas]
        self._retired_at: Dict[int, float] = {}
        self._record_timeline = False
        # observability seam: attach_trace wires one TraceRecorder through
        # every replica, the brownout controller and the fault injector
        self.trace = None
        # fault-tolerance state: timed control events (crash / corrupt /
        # detect / retry) interleave with engine steps and arrivals on the
        # shared virtual clock.  All empty without a fault plan, so the
        # fault-free path is byte-identical to pre-fault-layer behaviour.
        self._control_events: List[tuple] = []  # heap (t, seq, kind, payload)
        self._ctl_seq = 0
        self.crashes: List[dict] = []
        self.requeues = 0
        self.retries = 0
        self.failed_requests: List[dict] = []
        self.brownout_events: List[dict] = []
        self._attempts: Dict[int, int] = {}     # req_id -> retry attempts
        self.handoff_failures = 0
        self.handoff_timeouts = 0
        self.handoff_retries = 0
        self.handoff_aborts = 0

    # ------------------------------------------------------------------
    # observability seam
    # ------------------------------------------------------------------
    def attach_trace(self, trace) -> None:
        """Wire one :class:`observability.TraceRecorder` through the whole
        fleet: every replica (engine + scheduler + block manager), the
        brownout controller and the fault injector.  Replicas added later
        (autoscale, crash replacement) inherit it via ``add_replica``."""
        self.trace = trace
        for e in self.replicas:
            e.attach_trace(trace)
        if self.brownout is not None:
            self.brownout.trace = trace
        if self.faults is not None:
            self.faults.trace = trace

    def _tracer(self):
        tr = self.trace
        return tr if (tr is not None and tr.enabled) else None

    # ------------------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.state if s == ACTIVE)

    def _pool(self, role: str, *, state: Optional[str] = None) -> List[int]:
        """Replica indices with ``role`` (optionally filtered by state)."""
        return [i for i in range(len(self.replicas))
                if self.roles[i] == role
                and (state is None or self.state[i] == state)]

    def routable_replicas(self) -> List[ServingEngine]:
        """Replicas the router may dispatch to: active only — draining
        replicas finish their assigned work but accept nothing new.

        Disaggregated mode scopes dispatch to the PREFILL pool (decode
        replicas receive work only through the KV-handoff path), falling
        back to the whole fleet if every prefill replica is gone.

        A fully drained fleet (the operator drained everything by hand)
        still has to land arrivals somewhere deterministic: fall back to
        the draining replicas, and past that to the whole fleet — a
        retired engine is just an idle engine wearing a control-plane
        label, and serving there beats crashing the router.  A FAILED
        replica is NEVER a candidate at any fallback tier: routing there
        would strand the request forever (a crashed engine never steps
        again)."""
        idxs = [i for i in range(len(self.replicas))
                if self.state[i] != FAILED]
        if self.disaggregated:
            pre = [i for i in self._pool(PREFILL) if self.state[i] != FAILED]
            cand = ([i for i in pre if self.state[i] == ACTIVE]
                    or [i for i in pre if self.state[i] != RETIRED])
            if cand:
                return [self.replicas[i] for i in cand]
            # no prefill replica left at all: serve colocated on whatever
            # remains rather than dropping the arrival
        out = [i for i in idxs if self.state[i] == ACTIVE]
        out = out or [i for i in idxs if self.state[i] != RETIRED]
        return [self.replicas[i] for i in (out or idxs)]

    # ------------------------------------------------------------------
    # elastic fleet surface
    # ------------------------------------------------------------------
    def add_replica(self, now: float, *, role: Optional[str] = None) -> int:
        """Bring a fresh replica online at virtual time ``now`` (its clock
        starts there — no retroactive work) and open it for routing.  In
        disaggregated mode ``role`` selects the pool it joins (default
        prefill — the pool classic autoscaling serves)."""
        if self.replica_factory is None:
            raise RuntimeError("cluster has no replica_factory")
        rid = len(self.replicas)
        eng = self.replica_factory(rid)
        eng.replica_id = rid
        eng.clock = max(eng.clock, now)
        eng.record_timeline = self._record_timeline
        if self._record_timeline:
            eng.metrics.use_timeline_ring()
        eng.faults = self.faults
        if self.trace is not None:
            eng.attach_trace(self.trace)
        # birth counts as a heartbeat: a replica that never steps must not
        # look crash-silent to the failure detector from t=0
        self.control.detector.heartbeat(rid, eng.clock)
        self.replicas.append(eng)
        self.state.append(ACTIVE)
        if role is None:
            role = PREFILL if self.disaggregated else COLOCATED
        self.roles.append(role)
        self._starts.append(eng.clock)
        self.autoscale_events.append(
            {"kind": "add", "at": now, "replica": rid, "role": role})
        tr = self._tracer()
        if tr is not None:
            tr.instant("fleet", "replica_add", now,
                       args={"replica": rid, "role": role})
        return rid

    def drain_replica(self, idx: int, now: float) -> None:
        """Stop routing to replica ``idx``; it finishes every request it
        already owns (pending + waiting + running) and then retires —
        draining never drops work."""
        if self.state[idx] != ACTIVE:
            return
        self.state[idx] = DRAINING
        # stateful routers (sticky affinity homes) must forget this replica
        # NOW: a stale home entry would keep steering its templates at a
        # replica that accepts no new traffic
        self.router.note_replica_dead(self.replicas[idx].replica_id)
        self.autoscale_events.append(
            {"kind": "drain", "at": now, "replica": idx})
        tr = self._tracer()
        if tr is not None:
            tr.instant("fleet", "replica_drain", now, args={"replica": idx})
        self._maybe_retire(idx, now)

    def _maybe_retire(self, idx: int, now: float) -> None:
        if self.state[idx] == DRAINING and not self.replicas[idx].has_work():
            # the request queues are empty but the host KV tier's transfer
            # queues may not be: flush them as part of the drain-to-retire
            # transition, otherwise pending spills/restores are silently
            # dropped and their pinned HostKVStore records leak forever
            # (invariant I6 must hold across drain)
            self.replicas[idx].flush_host_transfers()
            self.state[idx] = RETIRED
            self._retired_at[idx] = max(now, self.replicas[idx].clock)
            self.autoscale_events.append(
                {"kind": "retire", "at": self._retired_at[idx],
                 "replica": idx})
            tr = self._tracer()
            if tr is not None:
                tr.instant("fleet", "replica_retire", self._retired_at[idx],
                           args={"replica": idx})

    # ------------------------------------------------------------------
    # fault tolerance: crash / detect / retry control events
    # ------------------------------------------------------------------
    def _schedule_ctl(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._control_events,
                       (t, self._ctl_seq, kind, payload))
        self._ctl_seq += 1

    def _dispatch_ctl(self, t: float, kind: str, payload) -> None:
        if kind == "crash":
            self._on_crash(payload, t)
        elif kind == "corrupt":
            self._on_corrupt(payload, t)
        elif kind == "detect":
            self._on_detect(payload, t)
        elif kind == "retry":
            self._on_retry(payload, t)
        elif kind == "cancelstorm":
            self._on_cancelstorm(payload, t)
        elif kind == "cancel":
            self._on_cancel(payload, t)
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown control event {kind!r}")

    def _on_crash(self, fault, now: float) -> None:
        """Fail replica ``fault.replica`` at virtual time ``now``.  The
        crash takes effect at the first scheduling point at or after the
        fault time (engine steps are atomic).  All in-flight work is lost
        and re-dispatched after DETECTION — recovery runs off the
        missed-heartbeat signal, not the injector's ground truth."""
        idx = fault.replica
        if idx >= len(self.replicas) or self.state[idx] in (RETIRED, FAILED):
            return
        eng = self.replicas[idx]
        self.state[idx] = FAILED
        # sticky routers must forget this replica immediately, same as the
        # drain path (PrefixAffinityRouter re-homes its templates)
        self.router.note_replica_dead(eng.replica_id)
        lost = eng.force_fail()
        for req in lost:
            # a prompt that finished prefill on the crashed replica but was
            # never handed off must become a candidate again on its
            # recovery replica
            self._handoff_considered.discard(req.req_id)
        self._retired_at[idx] = now    # occupancy span ends at the crash
        rec = {"at": now, "replica": idx, "lost": len(lost),
               "detected_at": None, "recovered_at": None,
               "pending": {r.req_id for r in lost}, "_requests": lost}
        self.crashes.append(rec)
        tr = self._tracer()
        if tr is not None:
            tr.instant("fleet", "crash", now,
                       args={"replica": idx, "lost": len(lost)})
        self._schedule_ctl(now + self.control.detector.timeout_s,
                           "detect", rec)

    def _on_detect(self, rec: dict, now: float) -> None:
        """The failure detector confirms a silent replica and kicks off
        recovery: replace the replica (when a factory exists) and schedule
        every lost request's retry with exponential backoff."""
        idx = rec["replica"]
        if idx not in self.control.detector.suspects(
                now, [self.replicas[idx].replica_id]):
            # stepped since the fault was scheduled (cannot happen for a
            # FAILED replica, defensive): poll again one timeout later
            self._schedule_ctl(now + self.control.detector.timeout_s,
                               "detect", rec)
            return
        rec["detected_at"] = now
        tr = self._tracer()
        if tr is not None:
            tr.instant("fleet", "detect", now,
                       args={"replica": rec["replica"]})
        if self.replica_factory is not None:
            # replace-on-crash reuses the elastic add path (autoscale event
            # stream records it like any scale-up)
            role = self.roles[idx] if self.disaggregated else None
            self.add_replica(now, role=role)
        if not rec["pending"]:
            rec["recovered_at"] = now
        for req in rec["_requests"]:
            self._schedule_retry(req, rec, now)

    def _schedule_retry(self, req: Request, rec: dict, now: float) -> None:
        attempt = self._attempts.get(req.req_id, 0) + 1
        self._attempts[req.req_id] = attempt
        if self.retry_policy.exhausted(attempt):
            # budget spent: the request is surfaced as FAILED in metrics —
            # never silently dropped
            self.failed_requests.append(
                {"req_id": req.req_id, "at": now, "attempts": attempt - 1,
                 "priority": req.priority})
            tr = self._tracer()
            if tr is not None:
                tr.req_end(req.req_id, now, "failed",
                           attempts=attempt - 1, priority=req.priority)
            rec["pending"].discard(req.req_id)
            if not rec["pending"] and rec["recovered_at"] is None:
                rec["recovered_at"] = now
            return
        self.retries += 1
        # jitter (opt-in on the policy) draws from the injector's dedicated
        # retry stream — the corruption RNG never sees these draws
        rng = self.faults.retry_rng if self.faults is not None else None
        self._schedule_ctl(now + self.retry_policy.backoff(attempt, rng=rng),
                           "retry", (req, rec))

    def _on_retry(self, payload, now: float) -> None:
        """Re-dispatch one crashed request through the router.  Admission
        control is NOT re-consulted: the request was already admitted once
        and shedding it now would drop accepted work.  It restarts from
        its prompt (re-prefill); greedy decode makes the committed stream
        byte-identical to a fault-free run."""
        req, rec = payload
        self.requeues += 1
        tr = self._tracer()
        if tr is not None:
            # close the stall span opened at the crash at the retry instant
            # (the engine's re-submit then folds into this queue stage)
            tr.req_stage(req.req_id, now, "queue")
            tr.instant("fleet", "requeue", now, args={"req": req.req_id})
        self.submit(req, now=now)
        rec["pending"].discard(req.req_id)
        if not rec["pending"] and rec["recovered_at"] is None:
            rec["recovered_at"] = now

    def _on_corrupt(self, fault, now: float) -> None:
        """Corrupt host-KV records on one replica (checksum catches them
        at restore time; the prefix cold-re-prefills)."""
        idx = fault.replica
        if idx >= len(self.replicas):
            return
        hs = getattr(self.replicas[idx].scheduler.bm, "host_store", None)
        if hs is not None and self.faults is not None:
            self.faults.corrupt_host_records(hs, fault)

    def _on_cancelstorm(self, storm, now: float) -> None:
        """A cancellation storm fires: sample victims from the requests in
        flight NOW (seeded) and schedule each one's cancel inside the storm
        window."""
        if self.faults is None:
            return
        live = {rid for i, e in enumerate(self.replicas)
                if self.state[i] != FAILED
                for rid in e.inflight_req_ids()}
        for t, rid in self.faults.pick_cancel_victims(storm, live):
            self._schedule_ctl(max(t, now), "cancel", rid)

    def _on_cancel(self, req_id: int, now: float) -> None:
        """Client-cancel one request on whichever replica owns it (the
        assignment book tracks handoffs).  A no-op when the request already
        finished, was shed, or its replica failed — cancellation is
        idempotent and never invents accounting."""
        idx = self.assignments.get(req_id)
        if idx is None or idx >= len(self.replicas) \
                or self.state[idx] == FAILED:
            return
        eng = self.replicas[idx]
        if eng.cancel_request(req_id):
            # its dispatch forecast will never resolve — drop the record so
            # the residual estimator never folds a phantom sample
            self.control.tel(eng.replica_id)._forecasts.pop(req_id, None)

    # ------------------------------------------------------------------
    def submit(self, req: Request, now: Optional[float] = None) -> int:
        """Route one request and enqueue it on the chosen replica."""
        if now is None:
            now = req.arrival
        routable = self.routable_replicas()
        pos = self.router.route(req, routable, now=now)
        eng = routable[pos]
        self.control.note_dispatch(eng, req, now)
        eng.submit(req)
        self.assignments[req.req_id] = eng.replica_id
        return eng.replica_id

    def _handle_arrival(self, req: Request) -> Optional[int]:
        """Autoscale -> admission -> route, at the arrival instant.
        Returns the replica id, or None when the request was shed."""
        self.control.begin_arrival()
        try:
            return self._handle_arrival_inner(req)
        finally:
            self.control.end_arrival()

    def _handle_arrival_inner(self, req: Request) -> Optional[int]:
        now = req.arrival
        scaler = self.control.autoscaler
        admission = self.control.admission
        min_forecast = None
        if scaler is not None or admission is not None \
                or self.brownout is not None:
            routable = self.routable_replicas()
            min_forecast = min(self.control.forecast_ttft(e, req, now)
                               for e in routable)
        if scaler is not None:
            # in disaggregated mode the classic TTFT-attainment autoscaler
            # governs the PREFILL pool only (TTFT is a prefill-side
            # property once decode is offloaded); the decode pool has its
            # own controller below
            if self.disaggregated:
                scaled = self._pool(PREFILL)
            else:
                scaled = list(range(len(self.replicas)))
            active = [i for i in scaled if self.state[i] == ACTIVE]
            loads = [self.replicas[i].load for i in active]
            n_alive = sum(1 for i in scaled if self.state[i] != RETIRED)
            action = scaler.decide(now, len(active), loads,
                                   min_forecast, req.slo, n_alive=n_alive)
            if action == "up" and self.replica_factory is not None:
                self.add_replica(
                    now, role=PREFILL if self.disaggregated else None)
            elif action == "down" and len(active) > 1:
                idx = min(active,
                          key=lambda i: (self.replicas[i].load, i))
                self.drain_replica(idx, now)
            if action is not None:
                # the routable set changed: a fresh replica is dispatchable
                # immediately, and a drained one no longer is — the
                # admission decision must see the post-action fleet (a
                # drained replica's low forecast must not keep the door
                # open for traffic it can no longer take)
                min_forecast = min(self.control.forecast_ttft(e, req, now)
                                   for e in self.routable_replicas())
        if self.decode_autoscaler is not None and self.disaggregated:
            dec_active = self._pool(DECODE, state=ACTIVE)
            snaps = [self.control.snapshot(self.replicas[i], now)
                     for i in dec_active]
            n_alive = sum(1 for i in self._pool(DECODE)
                          if self.state[i] != RETIRED)
            d_action = self.decode_autoscaler.decide(now, snaps,
                                                     n_alive=n_alive)
            if d_action == "up" and self.replica_factory is not None:
                self.add_replica(now, role=DECODE)
            elif d_action == "down" and len(dec_active) > 1:
                idx = min(dec_active,
                          key=lambda i: (self.replicas[i].load, i))
                self.drain_replica(idx, now)
        # brownout top-rung shedding fires before classic admission: at that
        # rung the ladder has already decided the fleet is saturated, and
        # its class ordering (best_effort first, interactive never) must not
        # be overridden by the class-blind forecast check below
        if self.brownout is not None and min_forecast is not None \
                and self.brownout.should_shed(req, min_forecast):
            self.shed.append({"req_id": req.req_id, "at": now,
                              "slo": req.slo, "priority": req.priority,
                              "by": "brownout"})
            self.control.note_shed(now)
            tr = self._tracer()
            if tr is not None:
                # a shed request never enters the system: fleet instant
                # only, no request lane (keeps span balance clean)
                tr.instant("fleet", "shed", now,
                           args={"req": req.req_id, "by": "brownout",
                                 "priority": req.priority})
            return None
        if admission is not None and min_forecast is not None \
                and admission.should_shed(req, min_forecast):
            self.shed.append({"req_id": req.req_id, "at": now,
                              "slo": req.slo, "priority": req.priority})
            self.control.note_shed(now)
            tr = self._tracer()
            if tr is not None:
                tr.instant("fleet", "shed", now,
                           args={"req": req.req_id, "by": "admission",
                                 "priority": req.priority})
            return None
        return self.submit(req, now=now)

    # ------------------------------------------------------------------
    # disaggregated prefill/decode handoff
    # ------------------------------------------------------------------
    def _consider_handoffs(self, src_idx: int) -> None:
        """After a prefill replica's step: migrate each freshly completed
        prompt to the decode pool iff the priced transfer wins.

        A sequence is a candidate exactly once, at the step its prefill
        completes and before it decodes a single token (the KV image is
        whole-prompt, nothing speculative in flight).  Declined candidates
        decode where they prefilled — the colocated fallback — and are
        never reconsidered, so pricing is a one-shot decision made on the
        same telemetry snapshot routing would see."""
        src = self.replicas[src_idx]
        now = src.clock
        dsts = self._pool(DECODE, state=ACTIVE)
        if not dsts:
            return
        extracted = 0
        for seq in list(src.scheduler.running):
            if (seq.prompt_remaining != 0 or seq.done
                    or seq.generated != 0):
                continue
            rid = seq.req_id
            if rid in self._handoff_considered:
                continue
            self._handoff_considered.add(rid)
            # KV-headroom gate: a destination must be able to host the
            # whole prompt ON TOP of the handoffs already in flight to it.
            # On memory-tight profiles the decode pool saturates long
            # before the prefill pool — migrating past its capacity would
            # trade one replica's queue for another's preempt/recompute
            # thrash, so a prompt no decode replica can host simply decodes
            # where it prefilled (the colocated fallback, never worse).
            plen = max(seq.request.prompt_len, 1)
            hosts = [i for i in dsts if self.replicas[i].scheduler.bm
                     .can_allocate(plen + sum(
                         item[2].prompt_len
                         for item in self.replicas[i]._handoffs))]
            if not hosts:
                if self.pricer is not None:
                    self.pricer.declined += 1
                continue
            dst_i = min(hosts, key=lambda i: (
                self.control.forecast_ttft(self.replicas[i], None, now),
                self.replicas[i].load, i))
            dst = self.replicas[dst_i]
            if self.pricer is not None and not self.pricer.decide(
                    src, dst, seq.request, now):
                continue
            transfer_s = (self.pricer.transfer_seconds(
                src, seq.request.prompt_len) if self.pricer else 0.0)
            # injected transfer faults: each failed/timed-out attempt
            # wastes interconnect time; past the retry cap the sequence
            # simply decodes where it prefilled (the colocated fallback,
            # which is never worse) — candidacy was already
            # consumed, so it is not reconsidered
            waste = 0.0
            aborted = False
            if self.faults is not None:
                attempts = 0
                while True:
                    fault = self.faults.next_handoff_fault(now + waste)
                    if fault is None:
                        break
                    if fault.mode == "timeout":
                        waste += transfer_s * fault.timeout_factor
                        self.handoff_timeouts += 1
                    else:
                        waste += transfer_s
                        self.handoff_failures += 1
                    attempts += 1
                    if attempts > self.handoff_max_retries:
                        aborted = True
                        break
                    self.handoff_retries += 1
                self.handoff_transfer_s += waste
            if aborted:
                self.handoff_aborts += 1
                continue
            payload = src.extract_for_handoff(seq)
            dst.accept_handoff(seq.request,
                               t_ready=now + waste + transfer_s,
                               payload=payload)
            tr = self._tracer()
            if tr is not None:
                # KV migration: the request rides the interconnect until
                # t_ready, when adoption opens its decode stage on dst
                tr.req_stage(rid, now, "transfer", src.replica_id)
                tr.instant("fleet", "handoff", now,
                           args={"req": rid, "src": src.replica_id,
                                 "dst": dst.replica_id,
                                 "transfer_s": transfer_s, "waste_s": waste})
            self.control.note_handoff(src, dst, rid)
            self.assignments[rid] = dst.replica_id
            self.handoff_transfer_s += transfer_s
            self.handoffs.append(
                {"req_id": rid, "at": now, "src": src.replica_id,
                 "dst": dst.replica_id,
                 "transfer_s": round(transfer_s, 6)})
            extracted += 1
        if (extracted and src.scheduler.num_waiting
                and not src.scheduler.num_running):
            # the handoff emptied the running set while requests sat in the
            # waiting queue (admission had failed against blocks the
            # migrated sequences held): an idle engine only retries
            # admission on its next arrival, and with none pending it
            # would deadlock — retry NOW against the freed pool.  If the
            # head still cannot be admitted the step is a no-op and the
            # replica is stuck exactly as a colocated one would be.
            src.step()

    # ------------------------------------------------------------------
    # fleet brownout ladder
    # ------------------------------------------------------------------
    def _apply_brownout(self, now: float) -> None:
        """Evaluate the ladder (when a check is due) and push the current
        rung's knobs to every live replica.  Application is idempotent —
        the same stage re-applied is a no-op — and covers replicas added
        after the last transition (a crash-replacement engine must inherit
        the fleet's degradation state, not join at full service)."""
        bo = self.brownout
        if bo is None or not bo.due(now):
            return
        live = [i for i in range(len(self.replicas))
                if self.state[i] not in (RETIRED, FAILED)]
        snaps = [self.control.snapshot(self.replicas[i], now) for i in live]
        ev = bo.evaluate(now, snaps)
        if ev is not None:
            self.brownout_events.append(ev)
        cap = bo.output_cap_for("best_effort")
        for i in live:
            e = self.replicas[i]
            e.spec_forced_off = bo.spec_off
            e.best_effort_cap = cap
            if e.memmgr is not None:
                e.memmgr.force_offload = bo.offload_draft

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return any(e.has_work() for e in self.replicas)

    def peek_next_event(self) -> Optional[float]:
        evs = [t for t in (e.peek_next_event() for e in self.replicas)
               if t is not None]
        return min(evs) if evs else None

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *, max_steps: int = 5_000_000,
            record_timeline: bool = False) -> ClusterMetrics:
        """Discrete-event loop: route arrivals / step the earliest replica.

        ``record_timeline`` opts in to per-step timeline dicts on every
        replica (ring-bounded); off by default — long benches that never
        read them pay nothing."""
        self._record_timeline = record_timeline
        for e in self.replicas:
            e.record_timeline = record_timeline
            if record_timeline:
                e.metrics.use_timeline_ring()
        pending = sorted(requests, key=lambda r: (r.arrival, r.req_id))
        self._starts = [e.clock for e in self.replicas]
        if self.faults is not None:
            for i, e in enumerate(self.replicas):
                self.control.detector.heartbeat(e.replica_id, e.clock)
            for t, kind, payload in self.faults.timed_events():
                self._schedule_ctl(t, kind, payload)
        # pre-scheduled client cancellations (workload.cancellation_storm):
        # explicit (t, req_id) pairs, so brownout-on/off cells of a bench
        # grid cancel the SAME requests at the SAME instants
        for t, rid in self.cancels:
            self._schedule_ctl(float(t), "cancel", int(rid))
        pi = 0
        steps = 0
        while steps < max_steps:
            # a FAILED replica never steps again: its events are gone
            evs = [(t, i) for i, t in
                   enumerate(e.peek_next_event() for e in self.replicas)
                   if t is not None and self.state[i] != FAILED]
            t_engine = min(evs)[0] if evs else float("inf")
            t_arrival = (pending[pi].arrival if pi < len(pending)
                         else float("inf"))
            # timed control events (crash / corrupt / detect / retry) fire
            # ahead of engine steps and arrivals at the same instant; the
            # heap is empty without a fault plan, leaving the fault-free
            # event order byte-identical to the pre-fault-layer loop
            if self._control_events and \
                    self._control_events[0][0] <= min(t_engine, t_arrival):
                t, _, kind, payload = heapq.heappop(self._control_events)
                self._dispatch_ctl(t, kind, payload)
                steps += 1
                continue
            if pi < len(pending) and t_arrival <= t_engine:
                self._handle_arrival(pending[pi])
                pi += 1
                continue
            if not evs:
                break
            _, idx = min(evs)
            self.replicas[idx].step()
            if self.disaggregated and self.roles[idx] == PREFILL:
                self._consider_handoffs(idx)
            self.control.observe_step(self.replicas[idx])
            self._apply_brownout(self.replicas[idx].clock)
            self._maybe_retire(idx, self.replicas[idx].clock)
            steps += 1

        per = [e.finalize_metrics(self._starts[i])
               for i, e in enumerate(self.replicas)]
        makespan = max((e.clock - self._starts[i]
                        for i, e in enumerate(self.replicas)
                        if e.metrics.total_tokens or e.clock > self._starts[i]),
                       default=0.0)
        end = max((e.clock for e in self.replicas), default=0.0)
        spans = [(self._starts[i],
                  self._retired_at.get(i, max(end, self._starts[i])))
                 for i in range(len(self.replicas))]
        # externally visible crash records: drop the internal request
        # objects / pending sets so the list is JSON-serialisable
        crashes = [{k: v for k, v in c.items()
                    if k not in ("pending", "_requests")}
                   for c in self.crashes]
        return ClusterMetrics(per_replica=per, elapsed=makespan,
                              assignments=dict(self.assignments),
                              shed=list(self.shed),
                              autoscale_events=list(self.autoscale_events),
                              replica_states=list(self.state),
                              replica_spans=spans,
                              replica_roles=list(self.roles),
                              handoffs=list(self.handoffs),
                              handoffs_declined=(self.pricer.declined
                                                 if self.pricer else 0),
                              handoff_transfer_s=self.handoff_transfer_s,
                              handoff_fallbacks=sum(
                                  e.handoffs_refused for e in self.replicas),
                              handoff_failures=self.handoff_failures,
                              handoff_timeouts=self.handoff_timeouts,
                              handoff_retries=self.handoff_retries,
                              handoff_aborts=self.handoff_aborts,
                              crashes=crashes,
                              requeues=self.requeues,
                              retries=self.retries,
                              failed_requests=list(self.failed_requests),
                              brownout_events=list(self.brownout_events))
