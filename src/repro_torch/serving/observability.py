"""Flight recorder: structured tracing + metrics registry.

Two cooperating pieces:

:class:`TraceRecorder`
    Structured spans/events for one serving run.  Per-request lifecycle is
    modelled as a contiguous *stage machine*: ``queue`` from arrival, then
    ``prefill`` / ``decode`` / ``transfer`` (disaggregated KV handoff) /
    ``stall`` (preempt-recompute, crash recovery), closed by a terminal
    instant (``finished`` / ``cancelled`` / ``expired`` / ``failed``).
    Each stage transition closes the previous span, so a finished request's
    stage durations partition its end-to-end latency *by construction*
    (span-balance invariant, tests/test_torch_observability.py).  On top of the
    request lanes ride per-step engine spans (``batch``, ``gamma``,
    committed/accepted tokens — the MAB's reward surface) and fleet point
    events (brownout rung transitions, autoscale, crash/detect/recover,
    admission shed, draft offload/reload, KV spill/restore, faults).

    Without a ``clock`` the recorder runs on the callers' *virtual* clock
    (no wall-clock reads anywhere — a trace is a pure function of config +
    seed, so two same-seed runs emit byte-identical trace files).  With a
    ``clock`` (a callable returning seconds, e.g. ``time.perf_counter``)
    every event is stamped with ``clock()`` when it is recorded, whatever
    time its caller passes, and the engine and the paged backend record
    nested phase spans (:meth:`TraceRecorder.open` /
    :meth:`TraceRecorder.close`): the ``step`` span is the parent of the
    engine's ``engine.*`` phases, and ``engine.execute`` of the backend's
    ``backend.*`` phases.  Each phase is also a
    ``torch.profiler.record_function("nightjar.<name>")`` range, so a
    profiled slice holds the phases on the profiler's own clock beside the
    kernels; :meth:`TraceRecorder.align_profiler` records the offset
    between the two clocks.

    The recorder is attached via ``ServingEngine.attach_trace`` /
    ``ServingCluster.attach_trace`` (or the ``trace=`` kwarg of
    ``build_sim_engine`` / ``build_sim_cluster``).  Detached (the default)
    every hook is a single ``is None`` check — the committed token streams,
    step counts and ``Metrics.summary()`` are byte-identical to a build
    without the recorder.  Attached, memory is bounded: events live in a
    ring buffer (oldest evicted first, ``dropped`` counts evictions).

:class:`MetricsRegistry`
    Prometheus-flavoured counters / gauges / histograms with deterministic
    text exposition (``exposition``) for the real tier's scrape endpoint.

Exporters: ``export_jsonl`` (one sorted-key JSON object per line — the
input format of ``benchmarks/trace_report.py``) and ``export_chrome``
(Chrome trace-event JSON, Perfetto-viewable: replica = process, request =
thread lane, engine steps on lane 0).
"""
from __future__ import annotations

import json
import statistics
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

# request lifecycle stages (the waterfall axes) and terminal outcomes
STAGES = ("queue", "prefill", "decode", "transfer", "stall")
OUTCOMES = ("finished", "cancelled", "expired", "failed", "shed")

# ring capacities: events are ~7 small dict entries each; 256k events is a
# few tens of MB worst-case, far below the unbounded-timeline behaviour
# this layer replaces
EVENT_RING_CAP = 262_144

# default latency histogram buckets (seconds, virtual time)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _r(t: float) -> float:
    """Canonical time/duration rounding: one shared quantum so exporters,
    reports and golden tests all see the same digits."""
    return round(float(t), 9)


def _fmt_value(v) -> str:
    """Deterministic Prometheus sample rendering (repr is stable for
    floats in CPython; ints render without a decimal point)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Counter:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsRegistry:
    """Counters/gauges/histograms with Prometheus text exposition.
    Creation is memoized by name; re-registering a name as a different
    type raises."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help, buckets)

    def exposition(self) -> str:
        """Prometheus text format (deterministic: insertion order, repr
        floats).  The real tier serves this from a scrape endpoint; the
        sim tier writes it to ``--metrics-out``."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "histogram"}[type(m).__name__]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, Histogram):
                acc = 0
                for le, c in zip(m.buckets, m.counts):
                    acc += c
                    lines.append(f'{name}_bucket{{le="{_fmt_value(le)}"}} '
                                 f"{acc}")
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_fmt_value(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {_fmt_value(m.value)}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# trace recorder
# ---------------------------------------------------------------------------


class _Span:
    """An open phase span of a clocked recorder."""
    __slots__ = ("name", "id", "parent", "replica", "t0", "args", "range",
                 "profiled")

    def __init__(self, name, sid, parent, replica, t0, rng, profiled):
        self.name, self.id, self.parent = name, sid, parent
        self.replica, self.t0, self.args = replica, t0, {}
        self.range, self.profiled = rng, profiled


class TraceRecorder:
    """Bounded span/event recorder, on the virtual clock or on ``clock``.

    Every hook early-returns when ``enabled`` is False, and every
    instrumentation site guards on the recorder being attached at all —
    so a run without a recorder executes exactly the pre-recorder code
    path (the CI overhead gate pins this).
    """

    FLEET_PID = -1   # process lane for fleet-level (non-replica) events
    RANGE_PREFIX = "nightjar."   # profiler ranges of the phase spans

    def __init__(self, *, capacity: int = EVENT_RING_CAP,
                 registry: Optional[MetricsRegistry] = None,
                 enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        self.enabled = enabled
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        self.clock = clock
        # req_id -> [stage, start_t, replica]: the open stage span
        self._open: Dict[int, list] = {}
        # req_id -> arrival (for the e2e histogram at finish)
        self._arrival: Dict[int, float] = {}
        self.outcomes: Dict[int, str] = {}
        # open phase spans, innermost last
        self._spans: List[_Span] = []
        self._next_span = 0
        # (start, end) of the step spans a profiler was recording
        self._profiled_steps: List[Tuple[float, float]] = []
        if clock is not None:
            import torch
            self._range = torch.profiler.record_function
            self._profiling = torch.autograd._profiler_enabled
            # a process's first range costs ~1 ms inside its start, which
            # would stretch the first profiled range past its span: pay it
            rng = self._range(self.RANGE_PREFIX + "recorder")
            rng.__enter__()
            rng.__exit__(None, None, None)

    # -- low-level emit -------------------------------------------------
    def _emit(self, ev: dict) -> None:
        if self.events.maxlen is not None \
                and len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def open_spans(self) -> Dict[int, tuple]:
        """Still-open request stage spans (req_id -> (stage, start,
        replica)).  Empty after a drained run — the span-balance test."""
        return {rid: tuple(v) for rid, v in self._open.items()}

    def _now(self, t: float) -> float:
        """The stamp of an event a caller times ``t``: ``clock()`` when the
        recorder has a clock, else ``t``."""
        return t if self.clock is None else self.clock()

    # -- request lifecycle ----------------------------------------------
    def req_submit(self, rid: int, t: float, replica: int, *,
                   priority: str = "interactive", prompt_len: int = 0,
                   output_len: int = 0) -> None:
        """Open the ``queue`` stage at arrival (with a clock: at the call,
        which the engine makes once its clock has reached the arrival).  A resubmission (crash recovery retry) transitions the
        open stage back to ``queue`` instead of opening a second lane."""
        if not self.enabled:
            return
        if rid in self._open:
            self.req_stage(rid, t, "queue", replica)
            return
        t = _r(self._now(t))
        self._open[rid] = ["queue", t, replica]
        self._arrival[rid] = t
        self._emit({"ph": "i", "cat": "request", "name": "submit", "t": t,
                    "pid": replica, "req": rid,
                    "args": {"priority": priority, "prompt_len": prompt_len,
                             "output_len": output_len}})
        self.registry.counter(
            "requests_submitted_total",
            "requests submitted to an engine (incl. crash retries)").inc()

    def req_stage(self, rid: int, t: float, stage: str,
                  replica: Optional[int] = None, **args) -> None:
        """Close the request's open stage span and open ``stage`` at ``t``.

        Times are clamped monotonically per request (a cross-replica
        crash-recovery hop may carry a lagging clock), so stage spans are
        always contiguous and non-negative — the partition identity."""
        if not self.enabled:
            return
        t = _r(self._now(t))
        st = self._open.get(rid)
        if st is not None:
            prev_stage, t0, rep0 = st
            if t < t0:
                t = t0
            if prev_stage == stage:
                return  # idempotent re-entry (e.g. retry into queue)
            self._emit({"ph": "X", "cat": "request", "name": prev_stage,
                        "t": t0, "dur": _r(t - t0), "pid": rep0, "req": rid,
                        "args": {}})
        rep = replica if replica is not None else (st[2] if st else 0)
        self._open[rid] = [stage, t, rep]

    def req_end(self, rid: int, t: float, outcome: str,
                replica: Optional[int] = None, **args) -> None:
        """Close the request's open span and stamp its terminal outcome."""
        if not self.enabled:
            return
        t = _r(self._now(t))
        st = self._open.pop(rid, None)
        rep = replica
        if st is not None:
            stage, t0, rep0 = st
            if t < t0:
                t = t0
            self._emit({"ph": "X", "cat": "request", "name": stage,
                        "t": t0, "dur": _r(t - t0), "pid": rep0, "req": rid,
                        "args": {}})
            if rep is None:
                rep = rep0
        self.outcomes[rid] = outcome
        self._emit({"ph": "i", "cat": "request", "name": outcome, "t": t,
                    "pid": rep if rep is not None else 0, "req": rid,
                    "args": {k: (_r(v) if isinstance(v, float) else v)
                             for k, v in sorted(args.items())}})
        self.registry.counter(f"requests_{outcome}_total",
                              f"requests that ended {outcome}").inc()
        arrival = self._arrival.pop(rid, None)
        if outcome == "finished" and arrival is not None:
            self.registry.histogram(
                "request_e2e_seconds",
                "end-to-end latency of finished requests").observe(t - arrival)

    # -- engine step spans ----------------------------------------------
    def step_span(self, t0: float, t1: float, replica: int, *, batch: int,
                  gamma: int, tokens: int, accepted: int,
                  prefill_tokens: int = 0, draft_ok: bool = True,
                  forced_off: bool = False) -> None:
        """One decode (or hybrid) step on the engine lane: the
        (batch, gamma, n_accepted) tuple the planner observed.  With a
        clock the open ``step`` span takes these args and is recorded when
        the engine closes it (:meth:`close_step`)."""
        if not self.enabled:
            return
        args = {"B": batch, "gamma": gamma, "tokens": tokens,
                "accepted": accepted, "prefill_tokens": prefill_tokens,
                "draft_ok": draft_ok, "forced_off": forced_off}
        if self.clock is not None:
            if self._spans:
                self._spans[0].args.update(args)
            return
        t0, t1 = _r(t0), _r(t1)
        self._emit({"ph": "X", "cat": "engine", "name": "step", "t": t0,
                    "dur": _r(t1 - t0), "pid": replica, "args": args})
        self._count_step(gamma, batch, tokens, accepted, t1 - t0)

    def _count_step(self, gamma: int, batch: int, tokens: int,
                    accepted: int, seconds: float) -> None:
        reg = self.registry
        reg.counter("steps_total", "engine steps executed").inc()
        reg.counter("tokens_committed_total", "committed tokens").inc(tokens)
        if gamma > 0:
            reg.counter("spec_steps_total", "steps with gamma > 0").inc()
            reg.counter("draft_tokens_proposed_total",
                        "draft tokens proposed (gamma * B)").inc(gamma * batch)
            reg.counter("draft_tokens_accepted_total",
                        "draft tokens accepted by verification").inc(accepted)
        reg.gauge("batch_size", "decode batch size").set(batch)
        reg.gauge("gamma_selected", "speculative length chosen").set(gamma)
        reg.histogram("step_latency_seconds",
                      "engine step latency").observe(seconds)

    # -- phase spans (with a clock) --------------------------------------
    def open(self, name: str, replica: Optional[int] = None) -> None:
        """Open the phase span ``name`` inside the innermost open one (its
        ``parent``), on ``replica``'s lane (default: the parent's), and
        enter its profiler range ``nightjar.<name>``.  Only a recorder
        with a clock records phase spans."""
        sp = self._spans
        parent = sp[-1] if sp else None
        if replica is None:
            replica = parent.replica if parent is not None else 0
        self._next_span += 1
        rng = None
        if self._profiling():
            # the range records nothing while no profiler runs: skip it
            rng = self._range(self.RANGE_PREFIX + name)
            rng.__enter__()
        sp.append(_Span(name, self._next_span,
                        parent.id if parent is not None else None, replica,
                        self.clock(), rng, parent is None and rng is not None))

    def close(self, **args) -> None:
        """Close the innermost open span; ``args`` join its record."""
        s = self._spans.pop()
        t1 = self.clock()
        if s.range is not None:
            s.range.__exit__(None, None, None)
        a = s.args
        a.update(args)
        if s.profiled:
            self._profiled_steps.append((s.t0, t1))
        self._emit({"ph": "X", "cat": "engine" if s.parent is None
                    else s.name.split(".")[0], "name": s.name,
                    "t": _r(s.t0), "dur": _r(t1 - s.t0), "pid": s.replica,
                    "id": s.id, "parent": s.parent, "args": a})
        if s.name == "step" and "B" in a:
            self._count_step(a["gamma"], a["B"], a["tokens"], a["accepted"],
                             t1 - s.t0)

    def switch(self, name: str, **args) -> None:
        """Close the innermost span with ``args`` and open its sibling
        ``name``."""
        self.close(**args)
        self.open(name)

    def close_step(self, kind: str) -> None:
        """Close the ``step`` span, and any phase an early return of the
        step left open, with the step's ``kind`` (``decode``, ``mixed`` or
        ``idle``)."""
        while len(self._spans) > 1:
            self.close()
        self.close(kind=kind)

    def align_profiler(self, events) -> Optional[dict]:
        """Pair a stopped ``torch.profiler`` run's ``nightjar.step`` ranges
        (``events``: its ``events()``) in order with the step spans
        recorded while it ran, and record one ``clock`` instant: the offset
        from this recorder's clock to the profiler's (the median over the
        pairs), the pairs, the largest departure of a pair's start or end
        from that offset and of a pair's duration from its span's.  Returns
        the instant's args, or None without pairs."""
        import torch
        cpu = torch.autograd.DeviceType.CPU
        ranges = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6)
                        for e in events
                        if e.name == self.RANGE_PREFIX + "step"
                        and e.device_type == cpu)
        spans, self._profiled_steps = self._profiled_steps, []
        pairs = list(zip(ranges, spans))
        if not pairs:
            return None
        offset = statistics.median(r[0] - s[0] for r, s in pairs)
        skew = max(max(abs(r[0] - s[0] - offset), abs(r[1] - s[1] - offset))
                   for r, s in pairs)
        dur = max(abs((r[1] - r[0]) - (s[1] - s[0])) for r, s in pairs)
        args = {"offset_s": _r(offset), "pairs": len(pairs),
                "ranges": len(ranges), "spans": len(spans),
                "max_skew_s": _r(skew), "max_dur_diff_s": _r(dur)}
        self._emit({"ph": "i", "cat": "clock", "name": "profiler",
                    "t": _r(spans[0][0]), "pid": self.FLEET_PID,
                    "args": args})
        return args

    # -- point events ----------------------------------------------------
    def instant(self, cat: str, name: str, t: float, *,
                replica: Optional[int] = None, args: Optional[dict] = None
                ) -> None:
        """Fleet / engine / memory point event (brownout transition,
        autoscale, crash, detect, recover, shed, offload, reload, spill,
        restore, preempt, fault...) at ``t``.  A recorder with a clock
        stamps the call's ``clock()`` instead: an event copied later than
        it happened (the engine's memory-manager events) takes the time of
        the copy."""
        if not self.enabled:
            return
        self._emit({"ph": "i", "cat": cat, "name": name,
                    "t": _r(self._now(t)),
                    "pid": self.FLEET_PID if replica is None else replica,
                    "args": {k: (_r(v) if isinstance(v, float) else v)
                             for k, v in sorted((args or {}).items())}})
        self.registry.counter(f"events_{cat}_{name}_total",
                              f"{cat}/{name} events").inc()

    # -- exporters -------------------------------------------------------
    def jsonl_lines(self) -> List[str]:
        return [json.dumps(e, sort_keys=True, separators=(",", ":"))
                for e in self.events]

    def jsonl_bytes(self) -> bytes:
        """The full JSONL trace as bytes — the golden-determinism unit."""
        body = "\n".join(self.jsonl_lines())
        return (body + "\n").encode("utf-8") if body else b""

    def export_jsonl(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.jsonl_bytes())

    def chrome_events(self) -> List[dict]:
        """Chrome trace-event list: replica = process, request = thread
        lane (tid = req_id + 1), engine steps on lane 0, fleet events on
        their own process."""
        out: List[dict] = []
        pids: Dict[int, set] = {}
        for e in self.events:
            pid = e["pid"]
            rid = e.get("req")
            tid = 0 if rid is None else rid + 1
            pids.setdefault(pid, set()).add(tid)
            ts = _r(e["t"] * 1e6)
            row = {"name": e["name"], "cat": e["cat"], "pid": pid,
                   "tid": tid, "ts": ts, "args": e.get("args", {})}
            if e["ph"] == "X":
                row["ph"] = "X"
                row["dur"] = _r(e["dur"] * 1e6)
            else:
                row["ph"] = "i"
                row["s"] = "t" if rid is not None else "p"
            out.append(row)
        meta: List[dict] = []
        for pid in sorted(pids):
            pname = "fleet" if pid == self.FLEET_PID else f"replica {pid}"
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": pname}})
            for tid in sorted(pids[pid]):
                tname = "engine" if tid == 0 else f"req {tid - 1}"
                meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tid, "args": {"name": tname}})
        return meta + out

    def export_chrome(self, path: str) -> None:
        payload = {"traceEvents": self.chrome_events(),
                   "displayTimeUnit": "ms"}
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            json.dump(payload, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")

    def export(self, path: str, fmt: str = "jsonl") -> None:
        if fmt == "jsonl":
            self.export_jsonl(path)
        elif fmt == "chrome":
            self.export_chrome(path)
        else:
            raise ValueError(f"unknown trace format {fmt!r}")
