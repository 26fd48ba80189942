"""Deterministic fault injection for the serving cluster.

A :class:`FaultPlan` is a declarative description of failures to inject
into a `ServingCluster` run on the shared virtual clock:

- **crash**: a replica fails permanently at virtual time ``t`` — its
  in-flight work is lost, its blocks are gone (FAILED state, distinct
  from DRAINING).
- **straggler**: a transient window ``[start, end)`` during which one
  replica's step latency is multiplied by ``slowdown`` (a slow NIC, a
  noisy neighbour).  Multiple overlapping windows compound.
- **handoff**: disagg KV transfers failing or timing out during a
  window, with a per-fault count budget so capped retries can drain it.
- **corrupt**: host-KV offload records on one replica having their
  payload corrupted at time ``t`` (a bad DMA, bit rot) — caught by the
  blake2b record checksum on restore, never served.
- **cancelstorm**: a seeded fraction of the requests in flight at
  ``start`` being client-cancelled at seeded times inside
  ``[start, end)`` (a bulk client disconnect, an upstream timeout
  sweep).  Victims and times come from a dedicated RNG stream so the
  storm never perturbs corruption draws.

Everything is validated at construction and seeded, so two runs of the
same plan are byte-identical — the same determinism contract every
golden e2e in this repo relies on.

The injector itself holds only pure-function queries plus small
consume-once budgets; the cluster event loop owns the clock and asks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "CrashFault",
    "StragglerFault",
    "HandoffFault",
    "CorruptionFault",
    "CancelStorm",
    "FaultPlan",
    "RetryPolicy",
    "FaultInjector",
]


# ---------------------------------------------------------------------------
# Fault descriptors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CrashFault:
    """Replica ``replica`` fails permanently at virtual time ``at``."""

    replica: int
    at: float


@dataclass(frozen=True)
class StragglerFault:
    """Replica ``replica`` runs ``slowdown``x slower in [start, end)."""

    replica: int
    start: float
    end: float
    slowdown: float


@dataclass(frozen=True)
class HandoffFault:
    """KV handoff transfers fail during [start, end).

    ``mode`` is "fail" (transfer errors immediately, costing one
    transfer time) or "timeout" (costs ``timeout_factor`` transfer
    times before the failure surfaces).  ``count`` bounds how many
    transfer attempts this fault poisons; capped retries can therefore
    outlast it.  count <= 0 means unbounded within the window.
    """

    start: float
    end: float
    mode: str = "fail"
    count: int = 0
    timeout_factor: float = 3.0


@dataclass(frozen=True)
class CorruptionFault:
    """Corrupt ``count`` unpinned host-KV records on ``replica`` at ``at``."""

    replica: int
    at: float
    count: int = 1


@dataclass(frozen=True)
class CancelStorm:
    """Cancel ``frac`` of the in-flight requests at seeded times in
    ``[start, end)`` — a bulk client disconnect."""

    frac: float
    start: float
    end: float


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultPlan:
    """Validated, declarative collection of faults.

    Raises ``ValueError`` at construction for negative times, more than
    one crash per replica, inverted straggler windows or slowdown < 1.
    """

    crashes: Tuple[CrashFault, ...] = ()
    stragglers: Tuple[StragglerFault, ...] = ()
    handoffs: Tuple[HandoffFault, ...] = ()
    corruptions: Tuple[CorruptionFault, ...] = ()
    cancelstorms: Tuple[CancelStorm, ...] = ()

    def __post_init__(self) -> None:
        seen = set()
        for c in self.crashes:
            if c.at < 0:
                raise ValueError(f"crash time must be >= 0, got {c.at}")
            if c.replica < 0:
                raise ValueError(f"crash replica must be >= 0, got {c.replica}")
            if c.replica in seen:
                raise ValueError(
                    f"replica {c.replica} has more than one crash fault; "
                    "a crashed replica never comes back")
            seen.add(c.replica)
        for s in self.stragglers:
            if s.start < 0 or s.end < 0:
                raise ValueError(f"straggler times must be >= 0: {s}")
            if s.end <= s.start:
                raise ValueError(f"straggler window must have end > start: {s}")
            if s.slowdown < 1.0:
                raise ValueError(f"straggler slowdown must be >= 1: {s}")
        for h in self.handoffs:
            if h.start < 0 or h.end <= h.start:
                raise ValueError(f"handoff window must have 0 <= start < end: {h}")
            if h.mode not in ("fail", "timeout"):
                raise ValueError(f"handoff mode must be fail|timeout: {h}")
        for k in self.corruptions:
            if k.at < 0 or k.replica < 0 or k.count < 1:
                raise ValueError(f"corruption fault invalid: {k}")
        for cs in self.cancelstorms:
            if not 0.0 < cs.frac <= 1.0:
                raise ValueError(f"cancelstorm frac must be in (0, 1]: {cs}")
            if cs.start < 0 or cs.end <= cs.start:
                raise ValueError(
                    f"cancelstorm window must have 0 <= start < end: {cs}")

    @property
    def empty(self) -> bool:
        return not (self.crashes or self.stragglers
                    or self.handoffs or self.corruptions
                    or self.cancelstorms)

    # -- CLI spec ----------------------------------------------------------
    #
    #   crash:<replica>@<t>
    #   straggle:<replica>@<start>..<end>x<slowdown>
    #   handoff:<fail|timeout>@<start>..<end>[#<count>]
    #   corrupt:<replica>@<t>[#<count>]
    #   cancelstorm:<frac>@<start>..<end>
    #
    # joined by ';', e.g.  "crash:0@2.5;straggle:1@3..5x4;handoff:fail@2..4"

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        crashes: List[CrashFault] = []
        stragglers: List[StragglerFault] = []
        handoffs: List[HandoffFault] = []
        corruptions: List[CorruptionFault] = []
        cancelstorms: List[CancelStorm] = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            try:
                kind, rest = part.split(":", 1)
                head, at = rest.split("@", 1)
            except ValueError:
                raise ValueError(f"bad fault spec {part!r}") from None
            if kind == "crash":
                crashes.append(CrashFault(int(head), float(at)))
            elif kind == "straggle":
                window, x = at.split("x", 1)
                start, end = window.split("..", 1)
                stragglers.append(StragglerFault(
                    int(head), float(start), float(end), float(x)))
            elif kind == "handoff":
                count = 0
                if "#" in at:
                    at, c = at.split("#", 1)
                    count = int(c)
                start, end = at.split("..", 1)
                handoffs.append(HandoffFault(
                    float(start), float(end), mode=head, count=count))
            elif kind == "corrupt":
                count = 1
                if "#" in at:
                    at, c = at.split("#", 1)
                    count = int(c)
                corruptions.append(CorruptionFault(int(head), float(at), count))
            elif kind == "cancelstorm":
                start, end = at.split("..", 1)
                cancelstorms.append(CancelStorm(
                    float(head), float(start), float(end)))
            else:
                raise ValueError(f"unknown fault kind {kind!r} in {part!r}")
        return FaultPlan(tuple(crashes), tuple(stragglers),
                         tuple(handoffs), tuple(corruptions),
                         tuple(cancelstorms))


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with a cap and a hard retry budget.

    Attempt numbers are 1-based: ``backoff(1)`` is the delay before the
    first retry.  A request whose attempts exceed ``budget`` is
    surfaced as failed in metrics — never silently dropped.

    ``jitter_frac`` spreads retries by up to ±that fraction of the
    deterministic delay (thundering-herd decorrelation after a crash
    re-dispatches a whole replica's worth of work at once).  Jitter is
    strictly opt-in AND requires a caller-supplied ``rng`` — the default
    policy's schedule is a pure function of ``attempt``, which every
    golden chaos stream depends on.  The cluster threads the injector's
    dedicated ``retry_rng`` stream through, so jittered runs stay
    byte-reproducible under the same seed without perturbing any other
    fault draw.
    """

    budget: int = 3
    backoff_base: float = 0.05
    backoff_cap: float = 1.0
    jitter_frac: float = 0.0

    def __post_init__(self) -> None:
        if self.budget < 0:
            raise ValueError("retry budget must be >= 0")
        if self.backoff_base <= 0 or self.backoff_cap <= 0:
            raise ValueError("backoff base/cap must be > 0")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError("jitter_frac must be in [0, 1)")

    def backoff(self, attempt: int, *, rng=None) -> float:
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        delay = min(self.backoff_base * (2.0 ** (attempt - 1)),
                    self.backoff_cap)
        if self.jitter_frac > 0.0 and rng is not None:
            delay *= 1.0 + self.jitter_frac * float(rng.uniform(-1.0, 1.0))
        return delay

    def exhausted(self, attempt: int) -> bool:
        return attempt > self.budget


# ---------------------------------------------------------------------------
# Injector
# ---------------------------------------------------------------------------


class FaultInjector:
    """Seeded runtime view of a :class:`FaultPlan`.

    Pure queries (``latency_multiplier``) plus consume-once budgets
    (``next_handoff_fault``); timed one-shot events (crash, corruption)
    are surfaced once via :meth:`timed_events` for the cluster loop to
    schedule.  Determinism: with a fixed plan + seed, every answer is a
    pure function of the call sequence, which the virtual clock makes
    reproducible.
    """

    def __init__(self, plan: FaultPlan, seed: int = 0):
        self.plan = plan
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # dedicated streams: storm victim/time draws and retry jitter must
        # not advance the corruption RNG (or each other) — adding a storm
        # or enabling jitter leaves every other fault's draws byte-identical
        self.cancel_rng = np.random.default_rng([seed, 0xCA9C])
        self.retry_rng = np.random.default_rng([seed, 0xB0FF])
        # per-HandoffFault remaining poison budget (0 = unbounded)
        self._handoff_left = [h.count for h in plan.handoffs]
        self.stats = {"handoff_faults": 0, "corrupted_records": 0,
                      "storm_cancels": 0}
        # observability seam: the cluster's attach_trace wires this so
        # consumed faults land in the trace as fleet instants
        self.trace = None

    def _trace_instant(self, name: str, t: float, **args) -> None:
        tr = self.trace
        if tr is not None and tr.enabled:
            tr.instant("fault", name, t, args=args)

    # -- timed one-shots ---------------------------------------------------

    def timed_events(self) -> List[Tuple[float, str, object]]:
        """(time, kind, fault) for crash/corrupt/cancelstorm events,
        time-sorted.  A storm fires ONCE at its window start: victims are
        drawn from the requests in flight at that instant and their cancel
        times land inside the window."""
        evs: List[Tuple[float, str, object]] = []
        for c in self.plan.crashes:
            evs.append((c.at, "crash", c))
        for k in self.plan.corruptions:
            evs.append((k.at, "corrupt", k))
        for s in self.plan.cancelstorms:
            evs.append((s.start, "cancelstorm", s))
        evs.sort(key=lambda e: (e[0], e[1]))
        return evs

    # -- cancellation storms ----------------------------------------------

    def pick_cancel_victims(self, storm: CancelStorm,
                            live_ids) -> List[Tuple[float, int]]:
        """Seeded (cancel_time, req_id) schedule for one storm: a
        ``storm.frac`` sample (at least one when any are live) of the
        in-flight ids, each at a uniform time in the storm window."""
        ids = sorted(live_ids)
        if not ids:
            return []
        n = min(max(int(round(storm.frac * len(ids))), 1), len(ids))
        idx = self.cancel_rng.choice(len(ids), size=n, replace=False)
        times = self.cancel_rng.uniform(storm.start, storm.end, size=n)
        out = sorted((float(t), ids[int(i)]) for t, i in zip(times, idx))
        self.stats["storm_cancels"] += n
        self._trace_instant("cancelstorm", storm.start, victims=n)
        return out

    # -- stragglers --------------------------------------------------------

    def latency_multiplier(self, replica: int, t: float) -> float:
        """Product of every straggler window covering (replica, t)."""
        mult = 1.0
        for s in self.plan.stragglers:
            if s.replica == replica and s.start <= t < s.end:
                mult *= s.slowdown
        return mult

    # -- handoffs ----------------------------------------------------------

    def next_handoff_fault(self, t: float) -> Optional[HandoffFault]:
        """Consume one poisoned-transfer budget covering time ``t``.

        Returns the fault a transfer attempt at ``t`` hits, or None if
        transfers are healthy.  Each call consumes one unit of the
        matched fault's count budget (unbounded when count <= 0), so a
        capped-retry loop can outlast a bounded fault.
        """
        for i, h in enumerate(self.plan.handoffs):
            if h.start <= t < h.end:
                if h.count > 0:
                    if self._handoff_left[i] <= 0:
                        continue
                    self._handoff_left[i] -= 1
                self.stats["handoff_faults"] += 1
                self._trace_instant(f"handoff_{h.mode}", t)
                return h
        return None

    # -- corruption --------------------------------------------------------

    def corrupt_host_records(self, host_store, fault: CorruptionFault) -> int:
        """Flip payload bytes of up to ``fault.count`` unpinned records.

        Pinned records (an in-flight restore already holds them) are
        never touched — the device copy is authoritative mid-transfer.
        Selection is seeded so runs reproduce.  Returns #corrupted.
        """
        victims = [h for h in host_store.records if h not in host_store.pinned]
        if not victims:
            return 0
        n = min(fault.count, len(victims))
        idx = self.rng.choice(len(victims), size=n, replace=False)
        done = 0
        for i in sorted(int(j) for j in idx):
            if host_store.corrupt(victims[i]):
                done += 1
        self.stats["corrupted_records"] += done
        self._trace_instant("corrupt", fault.at, replica=fault.replica,
                            records=done)
        return done
