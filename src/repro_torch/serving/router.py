"""Request routers for the multi-replica serving cluster.

A :class:`Router` maps each arriving :class:`~repro_torch.serving.request.Request`
to one replica (:class:`~repro_torch.serving.engine.ServingEngine`).  Routing is a
pure function of the request, the dispatch instant ``now`` and the replicas'
*observable* state — queue depths, KV-block headroom and the control plane's
online telemetry — never of simulator internals, so the same policies
transfer to the real-execution tier unchanged.

Policies:
  * ``RoundRobinRouter``   — cycle through replicas; the static baseline.
  * ``JoinShortestQueue``  — send to the replica with the fewest unfinished
    requests (pending + waiting + running); the classic JSQ policy used by
    SLO-aware SD serving systems (SpecServe, AdaSD).
  * ``KVHeadroomRouter``   — send to the replica with the most free paged-KV
    blocks, tie-broken by queue length.  Because Nightjar's planner reacts to
    memory pressure (speculation off, draft offload), balancing *headroom*
    rather than queue depth keeps more replicas inside the speculation-
    friendly regime at moderate load.
  * ``SLOAwareRouter``     — send to the replica with the largest predicted
    TTFT *deadline headroom* (``slo - forecast``), using the control plane's
    roofline queue-delay forecast corrected by the learned residual bias.
    Equivalently: minimise predicted TTFT, which is what the deadline cares
    about — queue depth and KV headroom are only proxies for it.
  * ``PrefixAffinityRouter`` — sticky-route on a *stable* template/prefix
    content hash (serving/controlplane.py ``template_key``; the seeded blake2b
    chain over token ids, never Python's salted ``hash()``) so each
    replica's prefix cache specialises on its own templates instead of every
    replica re-caching every template.  Load-aware spillover: when the home
    replica's predicted-TTFT headroom is exhausted the request overflows to
    the best other replica, but the home mapping survives so the flow
    returns once pressure clears.

All policies are deterministic (ties broken by replica index) so cluster
runs are exactly reproducible.

The cluster passes the *routable* replica subset (draining/retired replicas
excluded) — the returned index is a position in that subset.

Construct by name with :func:`make_router`
("rr" | "jsq" | "kv" | "slo" | "affinity").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .controlplane import ControlPlane, template_key
from .engine import ServingEngine
from .request import Request


class Router:
    """Base class: pick the replica index that receives ``req``.

    ``control`` is bound by the owning ``ServingCluster`` so headroom-based
    policies share the cluster's telemetry; load-only policies ignore it.
    """

    name = "router"
    control: Optional[ControlPlane] = None

    def route(self, req: Request, replicas: Sequence[ServingEngine],
              now: float = 0.0) -> int:
        raise NotImplementedError

    def note_replica_dead(self, replica_id: int) -> None:
        """Liveness notification from the cluster: ``replica_id`` has been
        drained or retired and must never be *chosen* again.  Stateless
        routers need no bookkeeping (the cluster already excludes dead
        replicas from the routable set); stateful routers that remember
        replica ids across dispatches (sticky affinity homes) must purge
        them here — a stale id silently re-routes traffic to a corpse."""


class RoundRobinRouter(Router):
    name = "round-robin"

    def __init__(self):
        self._next = 0

    def route(self, req: Request, replicas: Sequence[ServingEngine],
              now: float = 0.0) -> int:
        idx = self._next % len(replicas)
        self._next += 1
        return idx


class JoinShortestQueue(Router):
    name = "jsq"

    def route(self, req: Request, replicas: Sequence[ServingEngine],
              now: float = 0.0) -> int:
        return min(range(len(replicas)),
                   key=lambda i: (replicas[i].load, i))


class KVHeadroomRouter(Router):
    name = "kv-headroom"

    def route(self, req: Request, replicas: Sequence[ServingEngine],
              now: float = 0.0) -> int:
        def key(i: int):
            bm = replicas[i].scheduler.bm
            # most allocatable blocks first (free + cached-reusable prefix
            # blocks, which evict on demand), then shortest queue, then index
            return (-bm.num_allocatable, replicas[i].load, i)
        return min(range(len(replicas)), key=key)


class SLOAwareRouter(Router):
    """Dispatch on predicted-TTFT deadline headroom.

    For each replica the control plane forecasts the TTFT this request
    would see there; the replica with the largest ``slo - forecast``
    headroom wins (= smallest forecast, since the deadline is the
    request's own).  Ties break on load then index.  Without a bound
    control plane it degrades to JSQ."""

    name = "slo"

    def __init__(self, control: Optional[ControlPlane] = None):
        self.control = control

    def route(self, req: Request, replicas: Sequence[ServingEngine],
              now: float = 0.0) -> int:
        if self.control is None:
            return min(range(len(replicas)),
                       key=lambda i: (replicas[i].load, i))
        return min(range(len(replicas)),
                   key=lambda i: (self.control.forecast_ttft(
                       replicas[i], req, now), replicas[i].load, i))


class PrefixAffinityRouter(Router):
    """Sticky template routing with load-aware spillover.

    The first request of a template picks its *home* replica by best
    predicted headroom (KV headroom without a control plane); subsequent
    requests with the same stable template hash return home — so the
    template's prefix blocks are cached on exactly one replica and every
    follower shares them — unless the home replica's predicted TTFT has
    blown past ``spill_slack``x the request's deadline, in which case the
    request overflows to the best other replica for this dispatch only
    (the home mapping is kept: the flow snaps back once pressure clears).
    Requests with no token ids fall through to best-headroom dispatch."""

    name = "affinity"

    def __init__(self, control: Optional[ControlPlane] = None, *,
                 window_tokens: int = 64, spill_slack: float = 2.0,
                 default_slo: Optional[float] = None):
        self.control = control
        self.window_tokens = window_tokens
        self.spill_slack = spill_slack
        self.default_slo = default_slo
        self.home: Dict[int, int] = {}       # template hash -> replica_id
        self.dead: set = set()               # drained/retired replica ids
        self.spills = 0
        self.rehomes = 0                     # templates moved off a dead home

    def note_replica_dead(self, replica_id: int) -> None:
        """Purge the sticky home map: every template homed on the drained
        replica re-homes (stickily) at its next dispatch.  Without this the
        map keeps pointing at the corpse — any caller that hands ``route``
        a replica set still containing it (an external dispatcher, or the
        cluster's fully-drained fallback tier) gets traffic routed to a
        DRAINING/RETIRED replica, and hit-rate craters because followers
        chase a cache that will never be served again."""
        self.dead.add(replica_id)
        stale = [k for k, rid in self.home.items() if rid == replica_id]
        for k in stale:
            del self.home[k]
        self.rehomes += len(stale)

    # -- pieces ---------------------------------------------------------
    def _best(self, req: Request, replicas: Sequence[ServingEngine],
              now: float) -> int:
        """Best replica for a non-sticky dispatch (position in subset)."""
        if self.control is not None:
            return min(range(len(replicas)),
                       key=lambda i: (self.control.forecast_ttft(
                           replicas[i], req, now), replicas[i].load, i))
        return min(range(len(replicas)),
                   key=lambda i: (-replicas[i].scheduler.bm.num_allocatable,
                                  replicas[i].load, i))

    def _overloaded(self, eng: ServingEngine, req: Request,
                    now: float) -> bool:
        slo = req.slo if req.slo is not None else self.default_slo
        if self.control is None or slo is None:
            return False
        return self.control.forecast_ttft(eng, req, now) \
            > slo * self.spill_slack

    # -- routing --------------------------------------------------------
    def route(self, req: Request, replicas: Sequence[ServingEngine],
              now: float = 0.0) -> int:
        # liveness first: a replica the cluster declared dead may only be
        # used when the caller's whole set is dead (nothing else to serve
        # on) — never stuck-to, never elected as a home
        live = [i for i, e in enumerate(replicas)
                if e.replica_id not in self.dead]
        if not live:
            live = list(range(len(replicas)))
        key = template_key(req.prompt_tokens, self.window_tokens)
        if key is None:
            best = self._best(req, [replicas[i] for i in live], now)
            return live[best]
        by_id = {replicas[i].replica_id: i for i in live}
        home = self.home.get(key)
        if home in by_id:
            pos = by_id[home]
            if not self._overloaded(replicas[pos], req, now):
                return pos
            # spillover: overflow this dispatch, keep the home mapping
            self.spills += 1
            if len(live) == 1:
                return pos
            others = [i for i in live if i != pos]
            best = self._best(req, [replicas[i] for i in others], now)
            return others[best]
        # first sight of this template (or its home drained/retired):
        # elect a new LIVE home by best current headroom — the new
        # mapping is sticky exactly like the first one was
        best = self._best(req, [replicas[i] for i in live], now)
        pos = live[best]
        self.home[key] = replicas[pos].replica_id
        return pos


_ROUTERS = {
    "rr": RoundRobinRouter,
    "round-robin": RoundRobinRouter,
    "jsq": JoinShortestQueue,
    "kv": KVHeadroomRouter,
    "kv-headroom": KVHeadroomRouter,
    "slo": SLOAwareRouter,
    "affinity": PrefixAffinityRouter,
}


def make_router(name: str, **kwargs) -> Router:
    try:
        cls = _ROUTERS[name]
    except KeyError:
        raise KeyError(f"unknown router {name!r}; one of {sorted(_ROUTERS)}")
    return cls(**kwargs)
