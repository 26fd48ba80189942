"""Cluster control plane: per-replica telemetry, predictive admission and
elastic replica autoscaling.

This is the fleet-control layer the Nightjar thesis implies: a serving
system that *reacts to load* should not stop at per-replica knobs
(speculation on/off, memory squeeze, batch growth) — the fleet itself must
route, admit and scale on the same signals.  Everything here observes only
replica queue state, the ``RooflineCostModel`` latency oracle and completed
request statistics — never simulator internals — so the policies transfer
to the real-execution tier unchanged (SpecServe / AdaSpec-style
deadline-headroom control).

Components
----------
``EWMA``
    A bare online exponentially weighted moving average.
``ReplicaTelemetry``
    Per-replica online estimators fed by completed-request stats: EWMA
    TTFT/TPOT plus a *forecast-residual* bias.  At dispatch time the control
    plane records the model-based TTFT forecast for the routed request; when
    the request finishes, ``observed_ttft - forecast`` updates the bias so
    the predictor self-corrects for everything the analytic term misses
    (decode interference, chunk scheduling, planner behaviour).
``ReplicaSnapshot``
    The observable state one routing/admission/scaling decision sees.
``ControlPlane``
    Owns the per-replica telemetry plus the optional admission and
    autoscale controllers; computes the predicted-TTFT queue-delay forecast
    ``max(clock - now, 0) + prefill_latency(backlog + prompt) + bias``.
``AdmissionController``
    Load shedding with hysteresis: when every replica's predicted TTFT
    exceeds ``slo * shed_factor`` the request is rejected at the door
    (counted as *shed*, not as an SLO miss of admitted traffic) and
    admission only resumes once the forecast falls back under
    ``slo * resume_factor`` — no flapping at the threshold.
``AutoscaleController``
    Elastic replica scaling on a windowed SLO-attainment signal (shed
    requests count as misses) plus a fast pressure path (every replica's
    forecast already past the deadline).  Scale-down drains the
    least-loaded replica: it stops receiving traffic, finishes its running
    work, then retires (see ``ServingCluster``).

The routers built on these signals live in serving/router.py
(``SLOAwareRouter``, ``PrefixAffinityRouter``); the elastic fleet mechanics
(``add_replica`` / ``drain_replica``) live in serving/cluster.py.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from ..configs.base import ModelConfig
from .kv_cache import CHAIN_ROOT, chain_hash
from .request import Request


# ---------------------------------------------------------------------------
# routing-stable template identity
# ---------------------------------------------------------------------------

def template_key(tokens, window_tokens: int = 64) -> Optional[int]:
    """Stable content hash of a prompt's first ``window_tokens`` tokens —
    the sticky-routing identity for prefix-affinity dispatch.

    Uses the BlockManager chain-hash scheme (``kv_cache.chain_hash``, a
    seeded blake2b chain over token ids), NEVER Python's per-process-salted
    ``hash()``: two independently
    constructed clusters — or two processes with different
    ``PYTHONHASHSEED`` — must route an identical request stream identically.
    Returns ``None`` when the request carries no token ids (nothing to be
    sticky about)."""
    if not tokens:
        return None
    return chain_hash(CHAIN_ROOT, [int(t) for t in tokens[:window_tokens]])


# ---------------------------------------------------------------------------
# online estimators
# ---------------------------------------------------------------------------


class EWMA:
    """Online exponentially weighted moving average (None until first obs)."""

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.value: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> float:
        self.value = x if self.value is None \
            else self.alpha * x + (1.0 - self.alpha) * self.value
        self.n += 1
        return self.value

    def get(self, default: float = 0.0) -> float:
        return self.value if self.value is not None else default


class ReplicaTelemetry:
    """Per-replica online predictors fed by completed-request stats.

    Three estimators drive the queue-delay forecast:
      * ``ewma_ttft`` / ``ewma_tpot`` — the replica's observed service
        levels (reporting + cost-model-free fallback);
      * ``ewma_slope`` — observed seconds of TTFT per backlog token at
        dispatch time.  The roofline prefill term is a *floor*: it prices
        the prompt FLOPs but not decode interference, batching or planner
        behaviour.  The slope estimator learns the replica's TRUE marginal
        delay per queued token from (dispatch backlog, observed TTFT)
        pairs, so the forecast tracks queue growth proportionally instead
        of by a constant additive correction;
      * ``ewma_err`` — residual of the final forecast, self-correcting
        whatever both terms above still miss.
    """

    def __init__(self, alpha: float = 0.3):
        self.ewma_ttft = EWMA(alpha)
        self.ewma_tpot = EWMA(alpha)
        self.ewma_slope = EWMA(alpha)  # seconds per dispatch-backlog token
        self.ewma_err = EWMA(alpha)    # observed_ttft - dispatch_forecast
        self._forecasts: Dict[int, Tuple[float, int]] = {}
        self._consumed = 0             # index into engine.metrics.requests

    def note_dispatch(self, req_id: int, forecast: float,
                      backlog_tokens: int) -> None:
        self._forecasts[req_id] = (forecast, backlog_tokens)

    def consume_finished(self, engine) -> List:
        """Fold the replica's newly finished requests into the estimators;
        returns the new RequestStats records (for cluster-wide windows)."""
        stats = engine.metrics.requests
        fresh = stats[self._consumed:]
        for r in fresh:
            self.ewma_ttft.update(r.ttft)
            self.ewma_tpot.update(r.tpot)
            rec = self._forecasts.pop(r.req_id, None)
            if rec is not None:
                forecast, backlog = rec
                if backlog > 0:
                    # idle dispatches (zero backlog) observe the service
                    # FLOOR, not a queue-delay slope: folding ttft/1 into
                    # the slope would teach the forecaster seconds-per-
                    # backlog-token ≈ baseline TTFT and inflate every
                    # subsequent busy forecast.  The residual bias
                    # (ewma_err) already captures the floor.
                    self.ewma_slope.update(r.ttft / backlog)
                self.ewma_err.update(r.ttft - forecast)
        self._consumed = len(stats)
        return fresh


@dataclass
class ReplicaSnapshot:
    """Observable replica state at one control decision (no sim internals)."""

    replica_id: int
    t: float                      # decision instant (virtual time)
    clock: float                  # the replica's own clock
    load: int                     # pending + waiting + running requests
    decode_count: int             # decode-ready running sequences
    prefill_backlog_tokens: int   # committed, un-materialised prompt tokens
    kv_allocatable: int           # free + cached-reusable blocks
    kv_total: int
    ewma_ttft: float
    ewma_tpot: float
    predicted_ttft: float         # forecast for a nominal next request
    draining: bool = False

    @property
    def kv_headroom_frac(self) -> float:
        return self.kv_allocatable / self.kv_total if self.kv_total else 0.0


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


class AdmissionController:
    """Predictive load shedding with hysteresis.

    Sheds an arrival when the BEST replica's predicted TTFT exceeds
    ``slo * shed_factor`` — past that point admitting the request cannot
    meet its deadline and only deepens every queue behind it (the p99
    collapse).  Once shedding starts it persists until the forecast drops
    back under ``slo * resume_factor`` (< shed_factor), so the controller
    cannot flap admit/shed around a single threshold.  Requests without a
    deadline are never shed.

    ``class_weights`` makes the thresholds priority-aware: both the shed
    and resume thresholds for a request are multiplied by its class's
    weight, and the hysteresis latch is tracked PER CLASS.  A weight below
    1.0 sheds that class earlier (best_effort first), above 1.0 later
    (interactive last); unlisted classes use weight 1.0, so a
    single-class workload with no weights behaves exactly as before."""

    def __init__(self, *, shed_factor: float = 1.5,
                 resume_factor: float = 1.0,
                 default_slo: Optional[float] = None,
                 class_weights: Optional[Dict[str, float]] = None):
        if resume_factor > shed_factor:
            raise ValueError("resume_factor must be <= shed_factor")
        if class_weights and any(w <= 0 for w in class_weights.values()):
            raise ValueError("class weights must be > 0")
        self.shed_factor = shed_factor
        self.resume_factor = resume_factor
        self.default_slo = default_slo
        self.class_weights = dict(class_weights) if class_weights else {}
        self._shedding: Dict[str, bool] = {}
        self.shed_count = 0
        self.shed_by_class: Dict[str, int] = {}

    @property
    def shedding(self) -> bool:
        """True while ANY class is latched shedding (back-compat view)."""
        return any(self._shedding.values())

    def should_shed(self, req: Request, min_forecast: float) -> bool:
        slo = req.slo if req.slo is not None else self.default_slo
        if slo is None:
            return False
        w = self.class_weights.get(req.priority, 1.0)
        cls = req.priority
        if self._shedding.get(cls, False):
            if min_forecast <= slo * self.resume_factor * w:
                self._shedding[cls] = False
                return False
        elif min_forecast > slo * self.shed_factor * w:
            self._shedding[cls] = True
        if self._shedding.get(cls, False):
            self.shed_count += 1
            self.shed_by_class[cls] = self.shed_by_class.get(cls, 0) + 1
        return self._shedding.get(cls, False)


# ---------------------------------------------------------------------------
# fleet brownout ladder
# ---------------------------------------------------------------------------

# Ordered degradation ladder.  Each rung trades a cheaper capability for
# fleet survival; the controller walks ONE rung per evaluation in either
# direction, with a cooldown between transitions, so a load spike degrades
# gracefully instead of collapsing and recovery cannot flap.
BROWNOUT_STAGES = ("normal", "spec_off", "draft_offload", "output_cap",
                   "shed")


class BrownoutController:
    """Hysteresis state machine over fleet telemetry driving the brownout
    ladder.

    Inputs per evaluation (all from ``ReplicaSnapshot`` — observable state
    only, no sim internals): the BEST replica's predicted TTFT (the same
    headroom signal admission and routing use), the fleet's minimum
    allocatable-KV headroom fraction, and optionally the deepest decode
    batch.  Pressure — best forecast past ``slo * enter_factor``, KV
    headroom under ``kv_low_frac``, or decode depth past ``decode_high`` —
    escalates one rung; calm (forecast under ``slo * exit_factor`` AND
    headroom at least ``kv_calm_frac``) de-escalates one rung.  Rungs, in
    order:

    1. ``spec_off``      — force gamma→0 fleet-wide: speculation burns KV
                           (draft slots) and verify FLOPs that overload
                           turns into pure queue delay (the Nightjar
                           gamma→0 saturation limit, applied by fiat).
    2. ``draft_offload`` — offload the draft model to host and expand the
                           KV pool into its slab (§6 squeeze), buying
                           batch growth when KV is the bottleneck.
    3. ``output_cap``    — cap ``max_new_tokens`` for best_effort traffic;
                           long tails stop starving interactive decode.
    4. ``shed``          — class-weighted admission shedding at the door:
                           best_effort always, batch when its own deadline
                           is already forecast blown, interactive never.

    Every transition is recorded in ``events`` with the signals that
    caused it, so post-hoc accounting can prove which rungs fired."""

    def __init__(self, *, slo: float = 1.0,
                 enter_factor: float = 1.5, exit_factor: float = 0.8,
                 kv_low_frac: float = 0.10, kv_calm_frac: float = 0.30,
                 decode_high: Optional[int] = None,
                 best_effort_cap: int = 32,
                 cooldown_s: float = 1.0, check_interval_s: float = 0.25):
        if slo <= 0:
            raise ValueError("brownout slo must be > 0")
        if exit_factor >= enter_factor:
            raise ValueError("exit_factor must be < enter_factor")
        if kv_calm_frac < kv_low_frac:
            raise ValueError("kv_calm_frac must be >= kv_low_frac")
        if best_effort_cap < 1:
            raise ValueError("best_effort_cap must be >= 1")
        self.slo = slo
        self.enter_factor = enter_factor
        self.exit_factor = exit_factor
        self.kv_low_frac = kv_low_frac
        self.kv_calm_frac = kv_calm_frac
        self.decode_high = decode_high
        self.best_effort_cap = best_effort_cap
        self.cooldown_s = cooldown_s
        self.check_interval_s = check_interval_s
        self.stage = 0
        self.shed_count = 0
        self.events: List[dict] = []
        self._last_transition = float("-inf")
        self._last_check = float("-inf")
        # observability seam: the cluster's attach_trace wires this so
        # every rung transition lands in the trace as a fleet instant
        self.trace = None

    # -- evaluation -----------------------------------------------------
    def due(self, now: float) -> bool:
        """Cheap prefilter: snapshots are only built when a check is due."""
        return now - self._last_check >= self.check_interval_s

    def evaluate(self, now: float,
                 snaps: List["ReplicaSnapshot"]) -> Optional[dict]:
        """One ladder decision; returns the transition event or None.
        Moves at most ONE rung per call, and never within ``cooldown_s``
        of the previous transition."""
        self._last_check = now
        if not snaps:
            return None
        best_ttft = min(s.predicted_ttft for s in snaps)
        kv_min = min(s.kv_headroom_frac for s in snaps)
        pressure = (best_ttft > self.slo * self.enter_factor
                    or kv_min < self.kv_low_frac)
        if self.decode_high is not None:
            pressure = pressure or max(s.decode_count for s in snaps) \
                > self.decode_high
        calm = (best_ttft < self.slo * self.exit_factor
                and kv_min >= self.kv_calm_frac)
        if now - self._last_transition < self.cooldown_s:
            return None
        if pressure and self.stage < len(BROWNOUT_STAGES) - 1:
            return self._move(now, self.stage + 1, best_ttft, kv_min)
        if calm and self.stage > 0:
            return self._move(now, self.stage - 1, best_ttft, kv_min)
        return None

    def _move(self, now: float, new: int, ttft: float, kv: float) -> dict:
        ev = {"at": round(now, 6), "from": BROWNOUT_STAGES[self.stage],
              "to": BROWNOUT_STAGES[new], "stage": new,
              "predicted_ttft": round(ttft, 6),
              "kv_headroom": round(kv, 6)}
        self.stage = new
        self._last_transition = now
        self.events.append(ev)
        tr = self.trace
        if tr is not None and tr.enabled:
            tr.instant("fleet", "brownout", now, args=dict(ev))
        return ev

    # -- rung queries (what the cluster applies to every live replica) --
    @property
    def stage_name(self) -> str:
        return BROWNOUT_STAGES[self.stage]

    @property
    def spec_off(self) -> bool:
        return self.stage >= BROWNOUT_STAGES.index("spec_off")

    @property
    def offload_draft(self) -> bool:
        return self.stage >= BROWNOUT_STAGES.index("draft_offload")

    def output_cap_for(self, priority: str) -> Optional[int]:
        """Token cap for new+running output of ``priority`` traffic at the
        current rung (None = uncapped)."""
        if self.stage >= BROWNOUT_STAGES.index("output_cap") \
                and priority == "best_effort":
            return self.best_effort_cap
        return None

    def should_shed(self, req: Request, min_forecast: float) -> bool:
        """Door decision at the top rung only: best_effort always sheds,
        batch sheds when its own deadline is already forecast blown,
        interactive is never brownout-shed (that is the whole point of
        the ladder)."""
        if self.stage < BROWNOUT_STAGES.index("shed"):
            return False
        if req.priority == "interactive":
            return False
        if req.priority != "best_effort":
            slo = req.slo
            if slo is None or min_forecast <= slo:
                return False
        self.shed_count += 1
        return True


# ---------------------------------------------------------------------------
# elastic autoscaling
# ---------------------------------------------------------------------------


class AutoscaleController:
    """Scale the fleet on a windowed SLO-attainment signal.

    Scale **up** (add a replica) when, over the trailing ``window_s`` of
    virtual time, attainment of deadline-carrying traffic — counting shed
    requests as misses — falls below ``up_attainment``, or immediately when
    every replica's predicted TTFT already exceeds the deadline (the fast
    pressure path; the windowed signal alone reacts one window late).

    Scale **down** (drain the least-loaded replica) when windowed attainment
    is at least ``down_attainment``, there is no pressure, and the fleet's
    unfinished-request load would comfortably fit on one fewer replica.
    Actions are separated by ``cooldown_s`` so one burst cannot thrash the
    fleet."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 window_s: float = 10.0, up_attainment: float = 0.9,
                 down_attainment: float = 0.98,
                 drain_load_per_replica: int = 8,
                 cooldown_s: float = 2.0, min_window_samples: int = 8):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.window_s = window_s
        self.up_attainment = up_attainment
        self.down_attainment = down_attainment
        self.drain_load_per_replica = drain_load_per_replica
        self.cooldown_s = cooldown_s
        # below this many window samples the attainment estimate is noise
        # (one unlucky long prompt would flip a scaling decision) — the
        # windowed signal abstains and only the pressure path may act
        self.min_window_samples = min_window_samples
        self._finished: Deque[Tuple[float, bool]] = deque()  # (t, slo_met)
        self._shed: Deque[float] = deque()
        self._last_action = float("-inf")

    # -- signal feeds ---------------------------------------------------
    def record_finish(self, t: float, slo_met: bool) -> None:
        self._finished.append((t, slo_met))

    def record_shed(self, t: float) -> None:
        self._shed.append(t)

    def _trim(self, now: float) -> None:
        lo = now - self.window_s
        while self._finished and self._finished[0][0] < lo:
            self._finished.popleft()
        while self._shed and self._shed[0] < lo:
            self._shed.popleft()

    def window_attainment(self, now: float) -> Optional[float]:
        """Attainment over the trailing window, shed counted as missed;
        None below ``min_window_samples`` (no reliable signal yet)."""
        self._trim(now)
        total = len(self._finished) + len(self._shed)
        if total < max(self.min_window_samples, 1):
            return None
        met = sum(1 for _, ok in self._finished if ok)
        return met / total

    # -- decisions ------------------------------------------------------
    def decide(self, now: float, n_active: int, loads: List[int],
               min_forecast: Optional[float], slo: Optional[float],
               n_alive: Optional[int] = None) -> Optional[str]:
        """One scaling decision at an arrival instant: 'up', 'down' or
        None.  ``loads`` are the active replicas' unfinished-request
        counts; ``min_forecast`` is the best predicted TTFT for the
        arriving request (None when unknown); ``n_alive`` counts every
        replica still doing work — active AND draining (defaults to
        ``n_active``).  The max-replica cap applies to ``n_alive``: a
        draining replica is still consuming capacity, so scaling up past
        it would put more than ``max_replicas`` engines on the hardware
        concurrently."""
        if n_alive is None:
            n_alive = n_active
        if now - self._last_action < self.cooldown_s:
            return None
        att = self.window_attainment(now)
        pressure = (slo is not None and min_forecast is not None
                    and min_forecast > slo)
        if n_alive < self.max_replicas and (
                pressure or (att is not None and att < self.up_attainment)):
            self._last_action = now
            return "up"
        if (n_active > self.min_replicas and not pressure
                and (att is None or att >= self.down_attainment)
                and sum(loads) <= self.drain_load_per_replica
                * (n_active - 1)):
            self._last_action = now
            return "down"
        return None


class DecodePoolAutoscaler:
    """Elastic scaling for the decode pool of a disaggregated fleet.

    The prefill pool scales on TTFT attainment (``AutoscaleController``:
    deadlines are a prefill-side property once decode is offloaded); the
    decode pool's failure modes are different — KV exhaustion (adoption
    fallbacks, preemption churn) and TPOT collapse under oversized decode
    batches — so it scales on those signals instead:

    Scale **up** when any active decode replica's allocatable-KV headroom
    falls under ``kv_pressure_frac``, when the pool's worst EWMA TPOT
    exceeds ``tpot_slo_s`` (if configured), or when any replica's decode
    batch exceeds ``decode_high`` (if configured).  Scale **down** when the
    pool is calm (every headroom above ``calm_kv_frac``, no TPOT/batch
    pressure) and the pool's total decode work would comfortably fit on one
    fewer replica.  Actions are separated by ``cooldown_s``."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 kv_pressure_frac: float = 0.15, calm_kv_frac: float = 0.4,
                 tpot_slo_s: Optional[float] = None,
                 decode_high: Optional[int] = None,
                 drain_decode_per_replica: int = 8,
                 cooldown_s: float = 2.0):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if calm_kv_frac < kv_pressure_frac:
            raise ValueError("calm_kv_frac must be >= kv_pressure_frac")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.kv_pressure_frac = kv_pressure_frac
        self.calm_kv_frac = calm_kv_frac
        self.tpot_slo_s = tpot_slo_s
        self.decode_high = decode_high
        self.drain_decode_per_replica = drain_decode_per_replica
        self.cooldown_s = cooldown_s
        self._last_action = float("-inf")

    def decide(self, now: float, snaps: List["ReplicaSnapshot"],
               n_alive: Optional[int] = None) -> Optional[str]:
        """One scaling decision for the decode pool: 'up', 'down' or None.
        ``snaps`` are the ACTIVE decode replicas' snapshots; ``n_alive``
        counts active + draining decode replicas (capacity cap, same
        convention as ``AutoscaleController.decide``)."""
        if not snaps:
            return None
        n_active = len(snaps)
        if n_alive is None:
            n_alive = n_active
        if now - self._last_action < self.cooldown_s:
            return None
        kv_min = min(s.kv_headroom_frac for s in snaps)
        pressure = kv_min < self.kv_pressure_frac
        if self.tpot_slo_s is not None:
            pressure = pressure or max(s.ewma_tpot for s in snaps) \
                > self.tpot_slo_s
        if self.decode_high is not None:
            pressure = pressure or max(s.decode_count for s in snaps) \
                > self.decode_high
        if pressure and n_alive < self.max_replicas:
            self._last_action = now
            return "up"
        if (n_active > self.min_replicas and not pressure
                and kv_min >= self.calm_kv_frac
                and sum(s.decode_count for s in snaps)
                <= self.drain_decode_per_replica * (n_active - 1)):
            self._last_action = now
            return "down"
        return None


# ---------------------------------------------------------------------------
# failure detection
# ---------------------------------------------------------------------------


class FailureDetector:
    """Missed-heartbeat failure detection on the shared virtual clock.

    Every stepped replica heartbeats (``observe_step``); a replica whose
    last heartbeat is more than ``timeout_s`` of virtual time old is a
    *suspect*.  The cluster confirms a crash fault only through this
    detector — recovery is driven by the observable signal (silence), not
    by the injector's ground truth, so detection latency (MTTD) is a real,
    measured component of MTTR rather than an assumed zero."""

    def __init__(self, timeout_s: float = 0.25):
        if timeout_s <= 0:
            raise ValueError("detector timeout must be > 0")
        self.timeout_s = timeout_s
        self.last_seen: Dict[int, float] = {}

    def heartbeat(self, replica_id: int, now: float) -> None:
        prev = self.last_seen.get(replica_id)
        if prev is None or now > prev:
            self.last_seen[replica_id] = now

    def silent_for(self, replica_id: int, now: float) -> float:
        """Virtual seconds since the replica's last heartbeat (0 for a
        replica never seen — birth counts as a heartbeat)."""
        last = self.last_seen.setdefault(replica_id, now)
        return max(now - last, 0.0)

    def suspects(self, now: float, replica_ids) -> List[int]:
        return [r for r in replica_ids
                if self.silent_for(r, now) >= self.timeout_s]


# ---------------------------------------------------------------------------
# handoff pricing (disaggregated prefill/decode)
# ---------------------------------------------------------------------------


class HandoffPricer:
    """Prices one prefill→decode KV migration.

    The handoff wins exactly when the predicted queue delay the request
    escapes by leaving the prefill replica exceeds the modelled time to
    move its KV blocks across the interconnect:

        saved  = forecast_ttft(src) - forecast_ttft(dst)
        cost   = kv_transfer_seconds(prompt_len) + margin_s
        accept ⇔ saved > cost

    Both forecasts come from the same ``ControlPlane`` book the routers
    and admission use (roofline floor, learned backlog slope, residual
    bias) — so pricing sharpens as telemetry accumulates.  When the
    transfer loses, the request simply decodes where it prefilled: the
    colocated fallback, never worse by construction.  A backend without a
    transfer model (``kv_transfer_seconds``) prices the move at zero —
    accept whenever any delay is saved."""

    def __init__(self, control: "ControlPlane", *, margin_s: float = 0.0):
        self.control = control
        self.margin_s = margin_s
        self.accepted = 0
        self.declined = 0

    def transfer_seconds(self, src, n_tokens: int) -> float:
        fn = getattr(src.backend, "kv_transfer_seconds", None)
        return fn(n_tokens) if fn is not None else 0.0

    def quote(self, src, dst, req: Request,
              now: float) -> Tuple[float, float]:
        """(predicted queue-delay saved, modelled transfer cost)."""
        saved = (self.control.forecast_ttft(src, None, now)
                 - self.control.forecast_ttft(dst, None, now))
        cost = self.transfer_seconds(src, req.prompt_len) + self.margin_s
        return saved, cost

    def decide(self, src, dst, req: Request, now: float) -> bool:
        saved, cost = self.quote(src, dst, req, now)
        win = saved > cost
        if win:
            self.accepted += 1
        else:
            self.declined += 1
        return win


# ---------------------------------------------------------------------------
# the control plane proper
# ---------------------------------------------------------------------------


class ControlPlane:
    """Telemetry book + optional admission/autoscale controllers.

    ``ServingCluster`` creates one per cluster (a bare, telemetry-only
    plane when no controllers are configured), feeds it after every replica
    step and consults it at every arrival.  Routers that dispatch on
    predicted headroom (``SLOAwareRouter``, ``PrefixAffinityRouter``) are
    bound to the same instance so routing, admission and scaling all see
    one consistent forecast."""

    def __init__(self, *, admission: Optional[AdmissionController] = None,
                 autoscaler: Optional[AutoscaleController] = None,
                 alpha: float = 0.3,
                 detector: Optional[FailureDetector] = None):
        self.admission = admission
        self.autoscaler = autoscaler
        self.alpha = alpha
        self.telemetry: Dict[int, ReplicaTelemetry] = {}
        self.detector = detector if detector is not None else FailureDetector()
        self._fc_cache: Optional[Dict[tuple, float]] = None

    def begin_arrival(self) -> None:
        """Open a forecast memo for one arrival decision.  Admission,
        autoscaling, routing and dispatch bookkeeping all evaluate the same
        (replica, request, now) forecasts — and no replica state changes
        while one arrival is being decided — so one computation per replica
        serves all of them.  The cluster closes the memo (``end_arrival``)
        before any engine executes."""
        self._fc_cache = {}

    def end_arrival(self) -> None:
        self._fc_cache = None

    def tel(self, replica_id: int) -> ReplicaTelemetry:
        return self.telemetry.setdefault(replica_id,
                                         ReplicaTelemetry(self.alpha))

    # -- prediction -----------------------------------------------------
    def forecast_ttft(self, engine, req: Optional[Request],
                      now: float) -> float:
        """Predicted TTFT if ``req`` were dispatched to ``engine`` at
        ``now``.

        ``max(roofline floor, learned slope * backlog)`` over the prompt
        tokens the replica is already committed to (plus this prompt), on
        top of the replica's clock lag past the arrival instant, corrected
        by the learned forecast-residual bias.  The roofline term prices
        the pure prefill FLOPs (exact before any request has completed);
        the slope term learns the replica's true marginal delay per queued
        token — decode interference included — from completed-request
        stats.  Falls back to the EWMA TTFT level when the backend exposes
        no cost model (real tier without one)."""
        key = (engine.replica_id, req.req_id if req is not None else None,
               now)
        if self._fc_cache is not None and key in self._fc_cache:
            return self._fc_cache[key]
        tel = self.tel(engine.replica_id)
        lag = max(engine.clock - now, 0.0)
        backlog = engine.prefill_backlog_tokens
        if req is not None:
            backlog += req.prompt_len
        cm = getattr(engine.backend, "cm", None)
        target = getattr(engine.backend, "target", None)
        if cm is not None and isinstance(target, ModelConfig):
            base = cm.prefill_latency(target, 1, max(backlog, 1))
        else:
            base = tel.ewma_ttft.get(0.0)
        learned = tel.ewma_slope.get(0.0) * backlog
        out = max(lag + max(base, learned) + tel.ewma_err.get(0.0), 0.0)
        if self._fc_cache is not None:
            self._fc_cache[key] = out
        return out

    def snapshot(self, engine, now: float, *,
                 draining: bool = False) -> ReplicaSnapshot:
        tel = self.tel(engine.replica_id)
        bm = engine.scheduler.bm
        return ReplicaSnapshot(
            replica_id=engine.replica_id, t=now, clock=engine.clock,
            load=engine.load, decode_count=engine.decode_count,
            prefill_backlog_tokens=engine.prefill_backlog_tokens,
            kv_allocatable=bm.num_allocatable, kv_total=bm.total_blocks,
            ewma_ttft=tel.ewma_ttft.get(0.0),
            ewma_tpot=tel.ewma_tpot.get(0.0),
            predicted_ttft=self.forecast_ttft(engine, None, now),
            draining=draining)

    # -- event feeds ----------------------------------------------------
    def note_dispatch(self, engine, req: Request, now: float) -> None:
        backlog = engine.prefill_backlog_tokens + req.prompt_len
        self.tel(engine.replica_id).note_dispatch(
            req.req_id, self.forecast_ttft(engine, req, now), backlog)

    def observe_step(self, engine) -> None:
        """Consume a replica's newly finished requests after one step."""
        self.detector.heartbeat(engine.replica_id, engine.clock)
        fresh = self.tel(engine.replica_id).consume_finished(engine)
        if self.autoscaler is not None:
            for r in fresh:
                self.autoscaler.record_finish(engine.clock, r.slo_met)

    def note_shed(self, now: float) -> None:
        if self.autoscaler is not None:
            self.autoscaler.record_shed(now)

    def note_handoff(self, src_engine, dst_engine, req_id: int) -> None:
        """A request dispatched to ``src_engine`` migrated to
        ``dst_engine`` mid-flight.  Drop its dispatch-forecast record: the
        source will never see it finish (no learning there), and folding
        its end-to-end TTFT — which includes the source's queue delay —
        into the DESTINATION's residual/slope estimators would inflate
        every decode-pool forecast and talk the pricer out of future
        handoffs (the forecast gap *is* the price signal).  Migrated
        requests still feed the destination's service-level EWMAs via
        ``consume_finished``."""
        self.tel(src_engine.replica_id)._forecasts.pop(req_id, None)
        self.tel(dst_engine.replica_id)  # ensure the book exists
