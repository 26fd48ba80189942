"""The Nightjar serving engine: a steppable driver over pluggable backends.

The driver couples the four paper components exactly as Figure 4:
  Scheduler (continuous batching)  ->  Planner (MAB, batch size as context)
  ->  Execution (AR step | speculative step)  ->  Elastic Memory Manager.

Backends:
  * SimulatedBackend (simulator.py) — analytical roofline latencies; the
    paper-scale simulated tier.
  * RealBackend (real_backend.py) — PyTorch execution over a paged-KV
    runtime (zero-copy block-table indexing, chunked prefill via
    hybrid_step), on the GPU through the package's CUDA kernels.
  * DenseSlotBackend (real_backend.py) — dense slot caches, monolithic
    prefill one prompt at a time through the flash-attention kernel.

Every tier runs the same scheduler, planner and memory-manager objects:
only the latency source differs.  The optional seams (``import_handoff``,
``export_handoff``, ``host_transfer_latency``, ...) are looked up with
``getattr``, so a backend without them plugs in too.

Steppable API (the cluster tier, serving/cluster.py, is built on this):
  * ``submit(request)``      — enqueue a request; it is admitted once the
    engine's virtual clock reaches ``request.arrival``.
  * ``peek_next_event()``    — the virtual time at which this engine next
    has work to do (its clock if anything is runnable, the earliest pending
    arrival if idle, or ``None`` when fully drained).  A cluster driver
    advances the replica with the smallest next-event time so N independent
    engine clocks interleave correctly in virtual time.
  * ``step(now=None)``       — execute ONE engine iteration and return a
    :class:`StepReport` (``None`` when there is nothing left to do).
  * ``run(requests)``        — the classic run-to-completion loop, now a
    thin wrapper: submit everything, step until drained.

Semantics of one engine step (identical to the original monolithic loop):
  1. admit arrivals; prefill the newly admitted sequences
  2. memory manager trigger check (offload/expand or contract/reload)
  3. gamma <- planner (forced 0 while the draft model is off-device)
  4. if switching 0 -> gamma>0: draft catch-up re-prefill of delta_max
     tokens (the C_switch cost, charged to the clock)
  5. execute the step; commit tokens; observe latency-per-token
"""
from __future__ import annotations

import heapq
import weakref
from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence as Seq

from ..core.bandits import Policy
from .kv_cache import OutOfBlocks
from .memory_manager import ElasticMemoryManager
from .request import Metrics, Request, Sequence
from .scheduler import ContinuousBatchingScheduler


class Backend(Protocol):
    def prefill(self, seqs: List[Sequence], *, with_draft: bool) -> float: ...

    def step(self, seqs: List[Sequence], gamma: int
             ) -> "StepOutcome": ...

    def hybrid_step(self, chunks, decode: List[Sequence], gamma: int,
                    *, with_draft: bool) -> "StepOutcome": ...

    def draft_catchup(self, seqs: List[Sequence]) -> float: ...

    def release(self, seq: Sequence) -> None: ...


@dataclass
class StepOutcome:
    n_committed: List[int]   # per sequence
    latency: float           # seconds


@dataclass
class StepReport:
    """What one ``ServingEngine.step`` call did (cluster/benchmark probe)."""

    kind: str                # "decode" (executed a batch) | "idle" (clock
                             # fast-forwarded to the next pending arrival)
    t_start: float           # engine clock when the step began
    t_end: float             # engine clock after the step
    batch: int = 0           # decode batch size B
    gamma: int = 0           # speculative length used this step
    tokens: int = 0          # committed tokens
    admitted: int = 0        # sequences admitted (prefilled) this step
    finished: int = 0        # sequences that completed this step
    prefill_tokens: int = 0  # prompt tokens prefilled (chunked mode)


class ServingEngine:
    def __init__(self, backend: Backend, scheduler: ContinuousBatchingScheduler,
                 policy: Policy, memmgr: Optional[ElasticMemoryManager] = None,
                 *, gamma_max: int = 5, replica_id: int = 0):
        self.backend = backend
        self.scheduler = scheduler
        self.policy = policy
        self.memmgr = memmgr
        self.gamma_max = gamma_max
        self.replica_id = replica_id
        self.clock = 0.0
        self.prev_gamma_effective = 0
        self.metrics = Metrics()
        # per-step timeline dicts are opt-in (run(record_timeline=True))
        # and ring-bounded — long benches that never read them no longer
        # accumulate unbounded memory
        self.record_timeline = False
        # observability seam (serving/observability.py): attach_trace wires
        # a TraceRecorder through the scheduler/block-manager; None (the
        # default) keeps every hook a single attribute check.  ``spans`` is
        # the recorder when it has a clock (wall-clock phase spans), else
        # None
        self.trace = None
        self.spans = None
        self._memmgr_traced = 0    # memmgr.events already copied to trace
        self._pending: List = []   # heap of (arrival, req_id, Request)
        # incoming prefilled requests migrating from a prefill-pool replica
        # (disaggregated mode): heap of (t_ready, req_id, Request, payload)
        self._handoffs: List = []
        self.handoffs_in = 0       # adopted with KV intact
        self.handoffs_refused = 0  # adoption fell back to local re-prefill
        # fault-injection seam (serving/faults.py): the cluster attaches a
        # FaultInjector; None means every query below is a no-op
        self.faults = None
        self.failed = False        # crashed — permanently out of service
        # brownout-ladder knobs (controlplane.BrownoutController via the
        # cluster; harmless defaults when no controller drives them)
        self.spec_forced_off = False       # stage >= spec_off: gamma -> 0
        self.best_effort_cap: Optional[int] = None  # stage >= output_cap:
                                           # max_new_tokens for best_effort

    # ------------------------------------------------------------------
    # observability seam
    # ------------------------------------------------------------------
    def attach_trace(self, trace) -> None:
        """Wire a :class:`observability.TraceRecorder` through this engine
        and the seams that emit events below it (scheduler preemptions,
        block-manager spill/restore).  A recorder with a clock also records
        the step's phase spans, here and in a backend with a ``spans``
        attribute (``RealBackend``).  The context closures read the LIVE
        clock/replica-id, so a cluster may attach before assigning replica
        ids.  ``None`` detaches everything.  The closures hold the engine
        weakly: the scheduler and block manager are the engine's own, so a
        strong reference would make a cycle that keeps the engine, and a
        real backend's weights, alive after its last user drops it."""
        self.trace = trace
        self.spans = (trace if trace is not None and trace.enabled
                      and trace.clock is not None else None)
        if hasattr(self.backend, "spans"):
            self.backend.spans = self.spans
        ctx = None
        if trace is not None:
            me = weakref.ref(self)

            def ctx():
                eng = me()
                return eng.clock, eng.replica_id
        self.scheduler.trace = trace
        self.scheduler.trace_ctx = ctx
        self.scheduler.bm.trace = trace
        self.scheduler.bm.trace_ctx = ctx

    def _tracer(self):
        """The active recorder, or None — the zero-cost gate every hook
        shares (detached OR disabled recorders both fold to None)."""
        tr = self.trace
        return tr if (tr is not None and tr.enabled) else None

    def _trace_memmgr(self, tr) -> None:
        """Copy memory-manager events (offload/expand/contract/reload) not
        yet seen into the trace; the seen-counter keeps this incremental
        without touching the manager itself."""
        evs = self.memmgr.events
        if len(evs) > self._memmgr_traced:
            # a recorder with a clock stamps the copy, not ``e.at`` (the
            # engine's own clock)
            for e in evs[self._memmgr_traced:]:
                args = {"latency": e.latency}
                args.update(e.detail)
                tr.instant("memmgr", e.kind, e.at,
                           replica=self.replica_id, args=args)
            self._memmgr_traced = len(evs)

    # ------------------------------------------------------------------
    # steppable surface
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request; admitted once the clock reaches its arrival."""
        heapq.heappush(self._pending, (req.arrival, req.req_id, req))
        tr = self._tracer()
        if tr is not None and (tr.clock is None or req.arrival <= self.clock):
            # queue time starts at arrival (e2e latency's origin).  A
            # recorder with a clock stamps the call, or, for an arrival the
            # engine's clock has not reached, the step that drains it
            self._trace_submit(tr, req)

    def _trace_submit(self, tr, req: Request) -> None:
        """Open ``req``'s queue lane; a crash-recovery resubmission of an
        already open request, or a lane already in ``queue``, folds into
        its existing lane instead."""
        tr.req_submit(req.req_id, max(req.arrival, 0.0), self.replica_id,
                      priority=req.priority, prompt_len=req.prompt_len,
                      output_len=req.output_len)

    @property
    def num_pending(self) -> int:
        """Submitted requests whose arrival the clock has not reached."""
        return len(self._pending)

    @property
    def load(self) -> int:
        """Total requests owned by this replica that are not yet finished
        admission: pending + waiting + running (router load signal)."""
        return (len(self._pending) + len(self._handoffs)
                + self.scheduler.num_waiting + self.scheduler.num_running)

    @property
    def decode_count(self) -> int:
        """Running sequences that are decode-ready (prefill complete)."""
        return sum(1 for s in self.scheduler.running
                   if s.prompt_remaining == 0)

    @property
    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens this replica has committed to but not yet
        materialised: queued prompts (waiting + submitted-pending) plus the
        un-prefilled remainder of running sequences.  Pure queue-state
        observation — the control plane's queue-delay forecast input, equally
        observable on the real tier."""
        return (sum(r.prompt_len for r in self.scheduler.waiting)
                + sum(s.prompt_remaining for s in self.scheduler.running)
                + sum(item[2].prompt_len for item in self._pending))

    def has_work(self) -> bool:
        return bool(self._pending or self._handoffs
                    or self.scheduler.num_waiting
                    or self.scheduler.num_running)

    def inflight_req_ids(self) -> List[int]:
        """Every request id this replica owns that has not finished:
        cancellation-storm victim pool (pending + handoffs + waiting +
        running)."""
        return ([item[2].req_id for item in self._pending]
                + [item[2].req_id for item in self._handoffs]
                + [r.req_id for r in self.scheduler.waiting]
                + [s.req_id for s in self.scheduler.running])

    def _next_income(self) -> Optional[float]:
        """Earliest instant at which queued income (a submitted arrival or
        an in-flight KV handoff) becomes actionable; ``None`` if neither."""
        cands = []
        if self._pending:
            cands.append(self._pending[0][0])
        if self._handoffs:
            cands.append(self._handoffs[0][0])
        return min(cands) if cands else None

    def _next_expiry(self) -> Optional[float]:
        """Earliest hard deadline among queued work (waiting requests and
        in-flight handoffs).  An otherwise-idle engine must still step at
        that instant so expired requests are reaped and accounted — they
        can never be silently stranded in the waiting queue."""
        exps = [r.arrival + r.deadline for r in self.scheduler.waiting
                if r.deadline is not None]
        exps += [item[2].arrival + item[2].deadline for item in self._handoffs
                 if item[2].deadline is not None]
        return min(exps) if exps else None

    def peek_next_event(self) -> Optional[float]:
        """Virtual time of this engine's next actionable event.

        ``None`` means drained (or stuck: waiting requests that can never be
        admitted because nothing is running and no arrivals remain — the
        run-to-completion loop historically terminated there too).  A
        deadline-carrying waiting request is never stuck: its expiry is an
        actionable event (the reap)."""
        if self.scheduler.num_running:
            return self.clock
        # with nothing running, admission is only retried when the clock
        # moves — the next chance is the next arrival / handoff landing /
        # deadline expiry
        cands = [t for t in (self._next_income(), self._next_expiry())
                 if t is not None]
        return max(self.clock, min(cands)) if cands else None

    # ------------------------------------------------------------------
    # pieces shared by the monolithic and hybrid step paths
    # ------------------------------------------------------------------
    def _drain_arrivals(self) -> None:
        sp = self.spans
        while self._pending and self._pending[0][0] <= self.clock:
            req = heapq.heappop(self._pending)[2]
            if sp is not None:
                # on the wall clock the lane opens when the engine sees the
                # arrival (a no-op where the submit already opened it)
                self._trace_submit(sp, req)
            self.scheduler.add_request(req)
        while self._handoffs and self._handoffs[0][0] <= self.clock:
            _, _, req, payload = heapq.heappop(self._handoffs)
            self._adopt_prefilled(req, payload)

    # ------------------------------------------------------------------
    # request lifecycle: cancellation + deadline reaping
    # ------------------------------------------------------------------
    def _note_lifecycle(self, req: Request, kind: str) -> None:
        """Account a cancelled/expired request — per-class, never silently
        dropped (the surge acceptance gate sums these against offered)."""
        rec = {"req_id": req.req_id, "at": round(self.clock, 6),
               "priority": req.priority, "slo": req.slo}
        (self.metrics.cancelled if kind == "cancelled"
         else self.metrics.expired).append(rec)
        tr = self._tracer()
        if tr is not None:
            tr.req_end(req.req_id, self.clock, kind, self.replica_id,
                       priority=req.priority)

    def _drop_sequence(self, seq: Sequence, kind: str) -> None:
        """Tear down ONE running sequence without finishing it: release its
        device blocks (registered prefix blocks park in the cached tier —
        their content is still valid, unlike a crash), drop any orphaned
        TTFT sample, and account the request.  Per-request granularity is
        what distinguishes this from ``force_fail`` (whole-replica); I8
        asserts nothing leaks."""
        sched = self.scheduler
        m = self.metrics
        if seq.first_token_at is not None:
            # the request never finishes: remove its orphaned TTFT sample
            # (exact float — the same arithmetic stamped it)
            try:
                m.ttfts.remove(seq.first_token_at - seq.request.arrival)
            except ValueError:
                pass
        sched.bm.release(sched._seq_key(seq))
        if seq in sched.running:
            sched.running.remove(seq)
        self.backend.release(seq)
        self._note_lifecycle(seq.request, kind)

    def cancel_request(self, req_id: int, *, reason: str = "cancelled"
                       ) -> bool:
        """Client cancellation: withdraw a request wherever it lives —
        submitted-pending, migrating handoff, waiting queue, or running
        batch — releasing every device block, CoW pin, host-KV pin and
        queue slot it holds.  Returns False when the request is unknown
        here (already finished, shed, or owned by another replica)."""
        for i, item in enumerate(self._pending):
            if item[2].req_id == req_id:
                self._pending.pop(i)
                heapq.heapify(self._pending)
                self._note_lifecycle(item[2], reason)
                return True
        for i, item in enumerate(self._handoffs):
            if item[2].req_id == req_id:
                self._handoffs.pop(i)
                heapq.heapify(self._handoffs)
                self._note_lifecycle(item[2], reason)
                return True
        for req in self.scheduler.waiting:
            if req.req_id == req_id:
                self.scheduler.waiting.remove(req)
                self._note_lifecycle(req, reason)
                return True
        for seq in list(self.scheduler.running):
            if seq.req_id == req_id:
                self._drop_sequence(seq, reason)
                return True
        return False

    def _reap_expired(self) -> int:
        """Drop every request whose hard deadline has passed — waiting
        (reaped at dispatch: never admitted), running (reaped mid-decode:
        stops burning batch slots on tokens nobody will read) and
        handoffs in transfer.  ``>=`` is load-bearing: the idle path
        fast-forwards the clock EXACTLY to the next expiry."""
        now = self.clock
        sched = self.scheduler
        reaped = 0
        for req in [r for r in sched.waiting if r.deadline is not None
                    and now >= r.arrival + r.deadline]:
            sched.waiting.remove(req)
            self._note_lifecycle(req, "expired")
            reaped += 1
        for seq in [s for s in sched.running
                    if s.request.deadline is not None
                    and now >= s.request.arrival + s.request.deadline]:
            self._drop_sequence(seq, "expired")
            reaped += 1
        if self._handoffs:
            keep = []
            for item in self._handoffs:
                req = item[2]
                if (req.deadline is not None
                        and now >= req.arrival + req.deadline):
                    self._note_lifecycle(req, "expired")
                    reaped += 1
                else:
                    keep.append(item)
            if len(keep) != len(self._handoffs):
                self._handoffs = keep
                heapq.heapify(self._handoffs)
        return reaped

    # ------------------------------------------------------------------
    # disaggregated prefill/decode handoff surface
    # ------------------------------------------------------------------
    def accept_handoff(self, req: Request, t_ready: float,
                       payload: Optional[dict] = None) -> None:
        """Receive a fully-prefilled request migrating from a prefill-pool
        replica.  ``t_ready`` is the virtual instant the KV transfer
        completes (source clock + modelled interconnect time); the request
        joins this replica's decode batch once the clock reaches it."""
        heapq.heappush(self._handoffs, (t_ready, req.req_id, req,
                                        payload or {}))

    def _adopt_prefilled(self, req: Request, payload: dict) -> None:
        """Materialise a handed-off request as a decode-ready sequence.

        The migrated KV blocks land in this replica's pool (block-table
        allocation covering the whole prompt, then the backend's
        ``import_handoff`` writes the payload on the physical tier).  If
        the pool cannot host the prompt right now, fall back to local
        re-prefill through the ordinary waiting queue — strictly the
        colocated behaviour, so a failed adoption is never worse than not
        having handed off (the request always completes)."""
        sched = self.scheduler
        seq = Sequence(request=req)
        key = sched._seq_key(seq)
        tr = self._tracer()
        try:
            sched.bm.allocate(key, max(req.prompt_len, 1))
        except OutOfBlocks:
            self.handoffs_refused += 1
            sched.add_request(req)
            if tr is not None:
                tr.instant("engine", "handoff_refused", self.clock,
                           replica=self.replica_id,
                           args={"req": req.req_id})
                tr.req_stage(req.req_id, self.clock, "queue",
                             self.replica_id)
            return
        if tr is not None:
            tr.req_stage(req.req_id, self.clock, "decode", self.replica_id)
        seq.prefilled = req.prompt_len
        seq.prefill_done_at = self.clock
        # draft-pool coverage travels with the KV: tokens the source's
        # draft never saw still need catch-up before speculating here
        seq.delta = int(payload.get("delta", 0))
        imp = getattr(self.backend, "import_handoff", None)
        if imp is not None:
            imp(seq, payload)
        sched.running.append(seq)
        self.handoffs_in += 1

    def extract_for_handoff(self, seq: Sequence) -> dict:
        """Detach a fully-prefilled, not-yet-decoded sequence for migration
        to a decode replica.  Returns the handoff payload (draft-coverage
        debt, plus the physical KV bytes on the real tier); the sequence's
        device blocks are released here — full prompt blocks stay in this
        replica's prefix cache, so repeat templates keep their affinity
        benefit even though decode happens elsewhere."""
        sched = self.scheduler
        payload: dict = {"delta": seq.delta,
                         "prompt_len": seq.request.prompt_len}
        export = getattr(self.backend, "export_handoff", None)
        if export is not None:
            payload["kv"] = export(seq)
        sched.bm.release(sched._seq_key(seq))
        if seq in sched.running:
            sched.running.remove(seq)
        self.backend.release(seq)
        return payload

    def _output_limit(self, req: Request) -> int:
        """Effective output length: ``best_effort`` requests are clipped to
        the brownout ladder's ``best_effort_cap`` when set (a capped
        request still *finishes* — shorter, not dropped)."""
        cap = self.best_effort_cap
        if cap is not None and req.priority == "best_effort":
            return min(req.output_len, cap)
        return req.output_len

    def _commit_decode(self, seqs: Seq[Sequence], n_committed: Seq[int],
                       gamma: int) -> "tuple[int, int]":
        """Commit per-sequence decode tokens; returns (sequences finished,
        tokens clipped by the best-effort output cap).  Clipped tokens are
        subtracted from the step's committed-token count by the caller —
        zero whenever no cap is active, keeping the uncapped path
        byte-identical."""
        m = self.metrics
        tr = self._tracer()
        finished = 0
        clipped = 0
        for s, n in zip(seqs, n_committed):
            if s not in self.scheduler.running:
                continue  # preempted/cancelled by an earlier commit
            limit = self._output_limit(s.request)
            raw = int(n)
            n = min(raw, max(limit - s.generated, 0))
            clipped += max(raw - n, 0)
            if n <= 0 and s.generated < limit:
                continue  # finished slot (raw <= 0) — nothing to commit
            if n > 0:
                if s.first_token_at is None:
                    s.first_token_at = self.clock
                    m.ttfts.append(self.clock - s.request.arrival)
                ok = self.scheduler.commit_tokens(s, n)
                if not ok:
                    continue  # preempted; will re-run from the queue
                if gamma == 0:
                    s.delta += n  # draft cache falls behind
            if s.generated >= limit:
                s.finished_at = self.clock
                m.latencies.append(self.clock - s.request.arrival)
                m.record_finish(s, self.clock)
                self.scheduler.finish(s)
                self.backend.release(s)
                finished += 1
                if tr is not None:
                    tr.req_end(s.req_id, self.clock, "finished",
                               self.replica_id, tokens=s.generated)
        return finished, clipped

    def _reserve_kv(self, seqs: List[Sequence], gamma: int) -> List[Sequence]:
        """Physical KV reservation (paged real backend): grow block tables to
        cover this step's gamma+1 writes BEFORE executing, so no paged write
        can ever land in another sequence's blocks.  While a reservation
        fails, the youngest running sequence (lowest class, then youngest:
        the scheduler's own guard) is preempted (recompute policy), so only
        work younger than the sequences asking is displaced; a sequence
        alone in the pool instead sits the step out with its KV kept, since
        its recompute would need the same blocks.  Backends without a
        ``reserve`` hook (simulated / dense slots) skip this entirely."""
        reserve = getattr(self.backend, "reserve", None)
        if reserve is None or not seqs:
            return seqs
        sched = self.scheduler
        while seqs:
            failed = reserve(seqs, gamma)
            if not failed:
                break
            # the reference preempts the youngest FAILED sequence: an elder
            # whose growth the younger ones' blocks block, and no sequence
            # finishes (ROADMAP C15).  The victim may be mid-prefill, outside
            # ``seqs``.
            victim = max(sched.running, key=sched._age_key)
            if len(sched.running) == 1:
                seqs = [s for s in seqs if s is not victim]
                continue
            sched.preempt(victim)
            seqs = [s for s in seqs if s in sched.running]
        return seqs

    def _drain_host_transfers(self) -> float:
        """Consume the host KV tier's transfer queues on the simulated tier
        and return the modelled restore latency (charged to the clock:
        restored blocks gate the admitted sequence's prefill, so the
        host→device copy is synchronous; spills ride the async DMA stream,
        §6.2, and cost nothing here).  Real backends drain these queues
        themselves inside their timed steps (``apply_host_transfers``), so
        this is a no-op for them."""
        bm = self.scheduler.bm
        hs = getattr(bm, "host_store", None)
        if hs is None or hasattr(self.backend, "apply_host_transfers"):
            return 0.0
        spills = bm.drain_pending_spills()
        for _, h in spills:
            if h in hs.records:
                hs.stats["spilled_blocks"] += 1
        restores = bm.drain_pending_restores()
        for h, _ in restores:
            hs.take(h)
        lat_fn = getattr(self.backend, "host_transfer_latency", None)
        lat = (lat_fn(len(spills), len(restores))
               if lat_fn is not None and restores else 0.0)
        if lat:
            hs.stats["restore_s"] += lat
        return lat

    def flush_host_transfers(self) -> float:
        """Complete every queued host-tier KV transfer *now* and charge the
        modelled latency to the engine clock.

        The step loop only drains these queues while the engine executes
        steps; a drained replica with empty request queues never steps
        again, so transfers queued by its last step's evictions (phase-5
        commit evictions land AFTER the in-step drain point) would be
        stranded — spilled payloads lost and restore-pinned
        ``HostKVStore`` records leaked.  The cluster calls this at the
        drain-to-retire transition.  Real backends move the bytes
        themselves (``apply_host_transfers``)."""
        bm = self.scheduler.bm
        if getattr(bm, "host_store", None) is None:
            return 0.0
        apply = getattr(self.backend, "apply_host_transfers", None)
        if apply is not None:
            apply()
            return 0.0
        lat = self._drain_host_transfers()
        self.clock += lat
        return lat

    def _faulty(self, dt: float) -> float:
        """Apply any straggler fault window covering (replica, clock) to a
        step latency.  The SCALED value is what the clock, timeline and
        planner all see — the policy adapting to a straggling replica is
        the desired behaviour, not a measurement artifact.  The injected
        surplus is tracked separately in ``metrics.fault_injected_s``."""
        if self.faults is None or dt <= 0:
            return dt
        mult = self.faults.latency_multiplier(self.replica_id, self.clock)
        if mult > 1.0:
            self.metrics.fault_injected_s += dt * (mult - 1.0)
            return dt * mult
        return dt

    # ------------------------------------------------------------------
    # crash surface (serving/faults.py · cluster crash recovery)
    # ------------------------------------------------------------------
    def force_fail(self) -> List[Request]:
        """Crash this replica: all in-flight work is lost, all device state
        is gone.  Returns every request this replica owned (pending,
        migrating, waiting, running) in req-id order so the cluster can
        re-dispatch them; releases every block, cancels every pending
        transfer and drops every host-store pin so nothing leaks (invariant
        I7, ``check_invariants(failed=True)``).  The host-side spill
        records themselves are irrelevant after the crash — the replica
        never serves again — but pins and queues must clear because the
        invariant checker (and the leak they model) is per-store."""
        sched = self.scheduler
        bm = sched.bm
        m = self.metrics
        lost: List[Request] = [item[2] for item in self._pending]
        self._pending.clear()
        lost += [item[2] for item in self._handoffs]
        self._handoffs.clear()
        lost += list(sched.waiting)
        sched.waiting.clear()
        for seq in list(sched.running):
            # a half-decoded sequence already contributed a TTFT sample;
            # its recovery run will contribute another from a different
            # replica — remove the orphaned sample so the crashed attempt
            # doesn't double-count (exact float: same arithmetic stamped it)
            if seq.first_token_at is not None:
                try:
                    m.ttfts.remove(seq.first_token_at - seq.request.arrival)
                except ValueError:
                    pass
            bm.release(sched._seq_key(seq))
            self.backend.release(seq)
            lost.append(seq.request)
        sched.running.clear()
        # device content is gone: unregister every cached-reusable block
        # straight back to the free list — NO spill (the payload a spill
        # would capture no longer exists), which also cancels in-flight
        # restores and unpins their host records via _unregister
        for b in list(bm.cached):
            bm.cached.pop(b, None)
            bm._unregister(b)
            bm.free.append(b)
        bm.pending_copies.clear()
        bm.pending_spills.clear()
        assert not bm.pending_restores, "restore survived its target"
        self.failed = True
        lost.sort(key=lambda r: r.req_id)
        tr = self._tracer()
        if tr is not None:
            # every lost request stalls at the crash instant; recovery
            # (cluster retry) reopens its queue span on another replica
            for r in lost:
                tr.req_stage(r.req_id, self.clock, "stall", self.replica_id)
        return lost

    def _record_timeline(self, B: int, gamma: int, tokens: int,
                         latency: float, draft_ok: bool,
                         prefill_tokens: int = 0) -> None:
        self.metrics.timeline.append({
            "t": self.clock, "B": B, "gamma": gamma,
            "tokens": tokens, "latency": latency,
            "prefill_tokens": prefill_tokens,
            "free_blocks": self.scheduler.bm.num_free,
            "cached_blocks": len(self.scheduler.bm.cached),
            "draft_resident": draft_ok,
            "waiting": self.scheduler.num_waiting,
        })

    # ------------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> Optional[StepReport]:
        """Advance the engine by one iteration of the Figure-4 loop.  With
        a clocked recorder attached the call is one ``step`` span, of kind
        ``decode``, ``mixed`` (a prefill ran) or ``idle``."""
        hybrid = self.scheduler.chunk_tokens is not None
        body = self._step_hybrid if hybrid else self._step_mono
        sp = self.spans
        if sp is None:
            return body(now)
        sp.open("step", self.replica_id)
        rep = None
        try:
            rep = body(now)
        finally:
            sp.close_step(
                "idle" if rep is None or rep.kind == "idle" else
                "mixed" if rep.prefill_tokens or (rep.admitted and not hybrid)
                else "decode")
        return rep

    def _step_mono(self, now: Optional[float]) -> Optional[StepReport]:
        """One iteration with monolithic prefill of the admitted prompts."""
        if now is not None and now > self.clock:
            self.clock = now
        m = self.metrics
        t_start = self.clock
        sp = self.spans
        if sp is not None:
            sp.open("engine.admit")

        # 1. arrivals up to now; reap expired deadlines BEFORE dispatch so
        #    a dead-on-arrival request never consumes prefill compute
        self._drain_arrivals()
        reaped = self._reap_expired()

        draft_ok = self.memmgr.can_speculate(self.clock) if self.memmgr else True
        tr = self._tracer()

        admitted = self.scheduler.schedule()
        if admitted:
            if sp is not None:
                sp.switch("engine.execute")
                if tr is not None:
                    # on the wall clock the prefill stage starts before the
                    # prefill runs (the stamp below re-enters it: a no-op)
                    for s in admitted:
                        tr.req_stage(s.req_id, self.clock, "prefill",
                                     self.replica_id)
            t_prefill0 = self.clock
            t = self.backend.prefill(admitted, with_draft=draft_ok)
            self.clock += self._faulty(t)
            for s in admitted:
                s.prefill_done_at = self.clock
                if not draft_ok:
                    s.delta = s.request.prompt_len  # draft never saw it
                if tr is not None:
                    tr.req_stage(s.req_id, t_prefill0, "prefill",
                                 self.replica_id)
                    tr.req_stage(s.req_id, self.clock, "decode",
                                 self.replica_id)

        if not self.scheduler.running:
            cands = [t for t in (self._next_income(), self._next_expiry())
                     if t is not None]
            if cands:
                # idle: fast-forward to the next arrival / handoff landing /
                # deadline expiry (expired waiting work still needs reaping)
                self.clock = max(self.clock, min(cands))
                return StepReport("idle", t_start, self.clock,
                                  admitted=len(admitted))
            if reaped:
                return StepReport("idle", t_start, self.clock)
            return None

        running = list(self.scheduler.running)
        B = len(running)
        delta_max = max((s.delta for s in running), default=0)

        # 2. elastic memory triggers
        if sp is not None:
            sp.switch("engine.memmgr")
        if self.memmgr is not None:
            self.memmgr.step(
                self.clock,
                spec_disabled=(self.prev_gamma_effective == 0),
                waiting=self.scheduler.num_waiting)
            draft_ok = self.memmgr.can_speculate(self.clock)
            if tr is not None:
                self._trace_memmgr(tr)

        # 3. arm selection (brownout stage >= spec_off forces gamma -> 0
        #    fleet-wide — the paper's MAB-disable recast as overload control)
        if sp is not None:
            sp.switch("engine.plan")
        if draft_ok and not self.spec_forced_off:
            gamma = self.policy.select(B, delta_max=delta_max)
        else:
            gamma = 0

        # 4. physical KV reservation, then switching cost (draft catch-up)
        if sp is not None:
            sp.switch("engine.reserve")
            n_run = self.scheduler.num_running
        running = self._reserve_kv(running, gamma)
        if sp is not None:
            sp.close(preempted=n_run - self.scheduler.num_running)
        if not running:
            return StepReport("idle", t_start, self.clock,
                              admitted=len(admitted))
        B = len(running)
        delta_max = max((s.delta for s in running), default=0)
        switched_on = (self.prev_gamma_effective == 0 and gamma > 0)
        if switched_on and any(s.delta > 0 for s in running):
            if sp is not None:
                sp.open("engine.catchup")
            t_catch = self.backend.draft_catchup(running)
            self.clock += self._faulty(t_catch)
            for s in running:
                s.delta = 0
            if tr is not None:
                tr.instant("engine", "draft_catchup", self.clock,
                           replica=self.replica_id,
                           args={"delta_max": delta_max, "batch": B})
            if sp is not None:
                sp.close()

        # 5. execute
        if sp is not None:
            sp.open("engine.execute")
        t_exec0 = self.clock
        out = self.backend.step(running, gamma)
        if sp is not None:
            sp.switch("engine.commit")
        out.latency = self._faulty(out.latency)
        self.clock += out.latency
        total_committed = int(sum(out.n_committed))

        finished, clipped = self._commit_decode(running, out.n_committed,
                                                gamma)
        total_committed -= clipped  # best-effort cap: tokens never written

        m.total_tokens += total_committed
        if total_committed > 0 and draft_ok:
            lpt = out.latency / total_committed
            self.policy.observe(B, gamma, lpt,
                                n_accepted=(total_committed - B) / max(B, 1)
                                if gamma else None,
                                delta_max=delta_max)
        if self.record_timeline:
            self._record_timeline(B, gamma, total_committed, out.latency,
                                  draft_ok)
        if self.record_timeline or tr is not None:
            m.note_spec_step(B, gamma, total_committed, out.latency,
                             forced_off=self.spec_forced_off or not draft_ok,
                             restarted=switched_on)
        if tr is not None:
            tr.step_span(t_exec0, self.clock, self.replica_id, batch=B,
                         gamma=gamma, tokens=total_committed,
                         accepted=max(total_committed - B, 0)
                         if gamma > 0 else 0,
                         draft_ok=draft_ok,
                         forced_off=self.spec_forced_off)
        if gamma != self.prev_gamma_effective:
            m.switch_count += 1
        self.prev_gamma_effective = gamma
        # CoW copies not consumed by a physical backend (simulated tier)
        self.scheduler.bm.drain_pending_copies()
        return StepReport("decode", t_start, self.clock, batch=B, gamma=gamma,
                          tokens=total_committed, admitted=len(admitted),
                          finished=finished)

    # ------------------------------------------------------------------
    def _step_hybrid(self, now: Optional[float] = None) -> Optional[StepReport]:
        """One iteration in chunked-prefill hybrid mode: the scheduler emits
        prefill chunks (token-budgeted) mixed with the decode batch, and one
        fused backend call executes both.  Speculation is forced off (gamma=0)
        whenever any chunk is in flight — the draft/verify machinery only runs
        on pure-decode steps, applied to the decode portion."""
        if now is not None and now > self.clock:
            self.clock = now
        m = self.metrics
        t_start = self.clock
        sp = self.spans
        if sp is not None:
            sp.open("engine.admit")

        # 1. arrivals up to now; reap expired deadlines BEFORE dispatch so
        #    a dead-on-arrival request never consumes chunk budget
        self._drain_arrivals()
        reaped = self._reap_expired()

        draft_ok = self.memmgr.can_speculate(self.clock) if self.memmgr else True
        tr = self._tracer()

        batch = self.scheduler.schedule_chunks()
        if batch.empty:
            cands = [t for t in (self._next_income(), self._next_expiry())
                     if t is not None]
            if cands:
                # idle: fast-forward to the next arrival / handoff landing /
                # deadline expiry (expired waiting work still needs reaping)
                self.clock = max(self.clock, min(cands))
                return StepReport("idle", t_start, self.clock)
            if reaped:
                return StepReport("idle", t_start, self.clock)
            return None

        # newly admitted sequences may carry a cached prefix: let the
        # backend seed its materialised-length bookkeeping (paged real
        # backend: tkv/dkv ctx = cached boundary; cached blocks are valid in
        # both pools by the registration rule)
        on_admit = getattr(self.backend, "on_admit", None)
        if on_admit is not None:
            for s in batch.admitted:
                on_admit(s)
        if tr is not None:
            for s in batch.admitted:
                # fully-cached admissions (whole prompt from the prefix
                # cache) never enter the chunk loop: straight to decode
                tr.req_stage(s.req_id, self.clock,
                             "decode" if s.prompt_remaining == 0
                             else "prefill", self.replica_id)

        # host-tier KV transfers queued during admission (spills from LRU
        # eviction, restores from match_prefix host hits) complete before
        # the fused step reads the restored prefixes
        self.clock += self._drain_host_transfers()

        decode = [s for s in batch.decode]
        B = len(decode)
        delta_max = max((s.delta for s in decode), default=0)

        # 2. elastic memory triggers
        if sp is not None:
            sp.switch("engine.memmgr")
        if self.memmgr is not None:
            self.memmgr.step(
                self.clock,
                spec_disabled=(self.prev_gamma_effective == 0),
                waiting=self.scheduler.num_waiting)
            draft_ok = self.memmgr.can_speculate(self.clock)
            if tr is not None:
                self._trace_memmgr(tr)

        # 3. arm selection — gamma only ever applies to the decode portion,
        #    and is forced to 0 while any prefill chunk is in flight or the
        #    brownout ladder has speculation disabled fleet-wide
        if sp is not None:
            sp.switch("engine.plan")
        if (batch.prefill_chunks or not draft_ok or B == 0
                or self.spec_forced_off):
            gamma = 0
        else:
            gamma = self.policy.select(B, delta_max=delta_max)

        # 4. physical KV reservation for the decode rows (chunk rows were
        #    reserved block-by-block at schedule time), then switching cost
        if sp is not None:
            sp.switch("engine.reserve")
            n_run = self.scheduler.num_running
        decode = self._reserve_kv(decode, gamma)
        # a reservation may have preempted a sequence with a chunk in this
        # batch: its blocks are gone, so its chunk does not run
        alive = {id(s) for s in self.scheduler.running}
        batch.prefill_chunks = [(s, n) for s, n in batch.prefill_chunks
                                if id(s) in alive]
        if sp is not None:
            sp.close(preempted=n_run - self.scheduler.num_running)
        B = len(decode)
        delta_max = max((s.delta for s in decode), default=0)
        switched_on = (self.prev_gamma_effective == 0 and gamma > 0)
        if switched_on and any(s.delta > 0 for s in decode):
            if sp is not None:
                sp.open("engine.catchup")
            t_catch = self.backend.draft_catchup(decode)
            self.clock += self._faulty(t_catch)
            for s in decode:
                s.delta = 0
            if tr is not None:
                tr.instant("engine", "draft_catchup", self.clock,
                           replica=self.replica_id,
                           args={"delta_max": delta_max, "batch": B})
            if sp is not None:
                sp.close()

        # 5. execute the fused step
        if sp is not None:
            sp.open("engine.execute")
        t_exec0 = self.clock
        out = self.backend.hybrid_step(batch.prefill_chunks, decode, gamma,
                                       with_draft=draft_ok)
        if sp is not None:
            sp.switch("engine.commit")
        out.latency = self._faulty(out.latency)
        self.clock += out.latency
        total_committed = int(sum(out.n_committed))

        # chunk progress: blocks were reserved at schedule time; freshly
        # completed full prompt blocks are published to the prefix cache
        for s, n in batch.prefill_chunks:
            s.prefilled += n
            if not draft_ok:
                s.delta += n  # the draft never saw these prompt tokens
            self.scheduler.note_prefill_progress(s, draft_ok=draft_ok)
            if s.prompt_remaining == 0:
                s.prefill_done_at = self.clock
                if tr is not None:
                    tr.req_stage(s.req_id, self.clock, "decode",
                                 self.replica_id)

        finished, clipped = self._commit_decode(decode, out.n_committed,
                                                gamma)
        total_committed -= clipped  # best-effort cap: tokens never written

        m.total_tokens += total_committed
        # the planner only learns from pure-decode steps: mixed-step latency
        # includes prefill work and would corrupt the latency-per-token signal
        if (total_committed > 0 and draft_ok and not batch.prefill_chunks):
            lpt = out.latency / total_committed
            self.policy.observe(B, gamma, lpt,
                                n_accepted=(total_committed - B) / max(B, 1)
                                if gamma else None,
                                delta_max=delta_max)
        if self.record_timeline:
            self._record_timeline(B, gamma, total_committed, out.latency,
                                  draft_ok,
                                  prefill_tokens=batch.prefill_tokens)
        if self.record_timeline or tr is not None:
            m.note_spec_step(B, gamma, total_committed, out.latency,
                             forced_off=self.spec_forced_off or not draft_ok,
                             restarted=switched_on)
        if tr is not None:
            tr.step_span(t_exec0, self.clock, self.replica_id, batch=B,
                         gamma=gamma, tokens=total_committed,
                         accepted=max(total_committed - B, 0)
                         if gamma > 0 else 0,
                         prefill_tokens=batch.prefill_tokens,
                         draft_ok=draft_ok,
                         forced_off=self.spec_forced_off)
        if gamma != self.prev_gamma_effective:
            m.switch_count += 1
        self.prev_gamma_effective = gamma
        # CoW copies not consumed by a physical backend (simulated tier)
        self.scheduler.bm.drain_pending_copies()
        return StepReport("decode", t_start, self.clock, batch=B, gamma=gamma,
                          tokens=total_committed, admitted=len(batch.admitted),
                          finished=finished,
                          prefill_tokens=batch.prefill_tokens)

    # ------------------------------------------------------------------
    def finalize_metrics(self, start_clock: float = 0.0) -> Metrics:
        """Stamp elapsed time + memory-manager / prefix-cache counters onto
        the metrics."""
        m = self.metrics
        m.elapsed = self.clock - start_clock
        if self.memmgr is not None:
            m.offload_events = sum(1 for e in self.memmgr.events
                                   if e.kind == "offload")
            m.reload_events = sum(1 for e in self.memmgr.events
                                  if e.kind == "reload")
        bm = self.scheduler.bm
        m.blocks_allocated = bm.stats["allocated_blocks"]
        if bm.prefix_caching:
            m.prefix = {k: bm.stats[k] for k in
                        ("queries", "hits", "saved_tokens", "shared_blocks",
                         "forks", "evictions", "restored_blocks")}
        hs = getattr(bm, "host_store", None)
        if hs is not None:
            m.host = dict(hs.stats)
        return m

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *, max_steps: int = 1_000_000,
            record_timeline: bool = False) -> Metrics:
        """Run-to-completion convenience wrapper over ``step``.

        Each call returns metrics for THIS batch of requests only (fresh
        Metrics object); the virtual clock and planner state carry over.
        ``record_timeline`` opts in to the (ring-bounded) per-step
        timeline dicts — off by default so long runs that never read them
        pay nothing."""
        self.metrics = Metrics()
        self.record_timeline = record_timeline
        if record_timeline:
            self.metrics.use_timeline_ring()
        for r in requests:
            self.submit(r)
        start_clock = self.clock
        steps = 0
        while steps < max_steps:
            if self.step() is None:
                break
            steps += 1
        return self.finalize_metrics(start_clock)
