#!/usr/bin/env python3
"""One cell of ``bench_port`` run traced with the program's wall-clock
phase spans attached, and the per-layer readings those spans give.

    python3 tools/span_readings.py --workload paper7b-chat-steady \
        --seed 4000000421 --seconds 51

A run is the harness's own ``cellrun.run_cell`` with ``--trace 1`` (the
profiler over a 3-s slice of the window), with a
``TraceRecorder(clock=loop.now)`` attached to the engine after the
warm-up, so its spans share the loop's clock with ``Run.window_open`` and
each ``StepRecord``.  The profiler's ``nightjar.*`` ranges are kept out of
the harness's own reading of the slice (its breakdown labels stay as they
are) and read into ``idle_by_phase``: the device-idle seconds of the slice
under the innermost ``nightjar.*`` range at each idle instant (``outside``
where none covers it).  The line printed holds the harness's per-layer
metrics, the seven readings of the spans (``READERS``), the checks of the
spans against the harness's outside timing, the clock offset to the
profiler and the profiler's own buffer requests' share of the idle.

Needs a CUDA device for the trace; the CPU tests drive ``run`` with
``trace=False`` at tiny widths.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

PREFIX = "nightjar."
OUTSIDE = "outside"
BUFFER_REQUEST = "Activity Buffer Request"   # the profiler's own range


# ---------------------------------------------------------------------------
# idle time under host ranges
# ---------------------------------------------------------------------------


def innermost(ranges: List[Tuple[float, float, str]]
              ) -> List[Tuple[float, float, str]]:
    """Nested ranges (start, end, name) flattened into disjoint segments,
    each named by the innermost range covering it."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(ranges)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(ranges)])
    out, stack, prev = [], [], None
    for t, opening, i in marks:
        if stack and t > prev:
            out.append((prev, t, ranges[stack[-1]][2]))
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        prev = t
    return out


def idle_intervals(device: List[Tuple[float, float]], lo: float, hi: float
                   ) -> List[Tuple[float, float]]:
    """[lo, hi) less the union of the device's busy intervals."""
    from bench_port.lib import device_trace
    out, at = [], lo
    for s, e in device_trace.union(device):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def idle_under(idle: List[Tuple[float, float]],
               ranges: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle seconds by the innermost of ``ranges`` covering each idle
    instant, ``outside`` for none."""
    segs = innermost(ranges)
    starts = [s for s, _, _ in segs]
    out: Dict[str, float] = {}
    for a, b in idle:
        covered = 0.0
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
                covered += d
            k += 1
        out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a) - covered
    return out


def idle_by_phase(device, phases, lo: float, hi: float) -> Dict[str, float]:
    """``Slice.idle_by_phase``: the slice's device-idle seconds under the
    innermost ``nightjar.*`` range (named without the prefix)."""
    return idle_under(idle_intervals(device, lo, hi),
                      [(s, e, n[len(PREFIX):]) for s, e, n in phases])


# ---------------------------------------------------------------------------
# the seven readers: each takes a ``serve.Run`` with ``spans`` (the
# recorder) and ``trace`` (the slice, with ``idle_by_phase``)
# ---------------------------------------------------------------------------


class Spans:
    """A recorder's phase spans, by id and by parent."""

    def __init__(self, rec):
        self.all = [e for e in rec.events if "id" in e]
        self.kids: Dict[Optional[int], List[dict]] = {}
        for e in self.all:
            self.kids.setdefault(e["parent"], []).append(e)

    def under(self, root_id: int, name: str) -> List[dict]:
        """The spans called ``name`` at any depth under ``root_id``."""
        out, todo = [], [root_id]
        while todo:
            for e in self.kids.get(todo.pop(), ()):
                if e["name"] == name:
                    out.append(e)
                todo.append(e["id"])
        return out

    def steps(self, run, pick) -> List[Tuple[dict, object]]:
        """(step span, its StepRecord) of the window's steps that ``pick``
        takes: each span lies inside the record of the ``engine.step``
        call that made it (the loop's clock before and after the call)."""
        from bench_port.lib import stats
        recs = stats.window_steps(run)
        starts = [r.t_start for r in recs]
        out = []
        for e in self.kids.get(None, ()):
            if e["name"] != "step":
                continue
            mid = e["t"] + 0.5 * e["dur"]
            k = bisect.bisect_right(starts, mid) - 1
            if k >= 0 and recs[k].t_end >= mid and pick(recs[k]):
                out.append((e, recs[k]))
        return out


def _spans(run) -> Optional[Spans]:
    """The run's spans, or None where a reader has nothing to read: no
    recorder, no traced slice, or a recorder that dropped events."""
    rec = getattr(run, "spans", None)
    if rec is None or run.trace is None or rec.dropped:
        return None
    return Spans(rec)


def _pure_decode(rec) -> bool:
    return rec.pure_decode


def _mixed(rec) -> bool:
    return rec.kind == "decode" and rec.batch > 0 and rec.prefill_tokens > 0


def _decode_mean_ms(run, fn) -> Optional[float]:
    sp = _spans(run)
    if sp is None:
        return None
    steps = sp.steps(run, _pure_decode)
    if not steps:
        return None
    return 1e3 * sum(fn(sp, e) for e, _ in steps) / len(steps)


def mixed_position_yield(run) -> Optional[float]:
    """Σ ``positions_valid`` ÷ Σ ``positions_run`` of the target calls
    (``backend.pack`` of model ``target``) in the window's mixed steps."""
    sp = _spans(run)
    if sp is None:
        return None
    run_n = valid = 0
    for e, _ in sp.steps(run, _mixed):
        for p in sp.under(e["id"], "backend.pack"):
            if p["args"].get("model") == "target":
                run_n += p["args"]["positions_run"]
                valid += p["args"]["positions_valid"]
    return 100.0 * valid / run_n if run_n else None


def engine_host_ms_decode(run) -> Optional[float]:
    """Mean over the window's pure-decode steps of the ``step`` span less
    its ``engine.execute`` and ``engine.catchup`` children."""
    return _decode_mean_ms(run, lambda sp, e: e["dur"] - sum(
        c["dur"] for c in sp.kids.get(e["id"], ())
        if c["name"] in ("engine.execute", "engine.catchup")))


def dispatch_ms_decode(run) -> Optional[float]:
    """Mean over the window's pure-decode steps of Σ ``backend.dispatch``."""
    return _decode_mean_ms(run, lambda sp, e: sum(
        c["dur"] for c in sp.under(e["id"], "backend.dispatch")))


def sync_wait_ms_decode(run) -> Optional[float]:
    """Mean over the window's pure-decode steps of Σ ``backend.sync``."""
    return _decode_mean_ms(run, lambda sp, e: sum(
        c["dur"] for c in sp.under(e["id"], "backend.sync")))


def _queue_p95_ms(run, rec) -> Optional[float]:
    from bench_port.lib import stats
    submit, queue = {}, {}
    for e in rec.events:
        rid = e.get("req")
        if rid is None:
            continue
        if e["name"] == "submit":
            submit.setdefault(rid, e["t"])
        elif e["name"] == "queue" and e["ph"] == "X":
            queue.setdefault(rid, e["dur"])
    waits = [queue.get(r.req_id, run.end - submit.get(r.req_id, r.due))
             for r in stats.window_requests(run)]
    v = stats.p95(waits)
    return None if v is None else 1e3 * v


def queue_span_p95_ms(run) -> Optional[float]:
    """p95 over the requests due in the window of their first ``queue``
    lane span (submit to the step that admits them; one never admitted
    waits until the run stopped)."""
    if _spans(run) is None:
        return None
    return _queue_p95_ms(run, run.spans)


def _idle_share(run, pick) -> Optional[float]:
    if _spans(run) is None:
        return None
    idle = getattr(run.trace, "idle_by_phase", None)
    total = sum(idle.values()) if idle else 0.0
    if total <= 0:
        return None
    return 100.0 * sum(v for k, v in idle.items() if pick(k)) / total


def idle_in_dispatch_share(run) -> Optional[float]:
    """``idle_by_phase`` under ``backend.dispatch`` ÷ all idle of the
    slice."""
    return _idle_share(run, lambda k: k == "backend.dispatch")


def idle_in_engine_share(run) -> Optional[float]:
    """``idle_by_phase`` under the ``engine.*`` phases other than
    ``engine.execute`` ÷ all idle of the slice."""
    return _idle_share(run, lambda k: k.startswith("engine.")
                       and k != "engine.execute")


READERS = {
    "mixed_position_yield": mixed_position_yield,
    "engine_host_ms.decode": engine_host_ms_decode,
    "dispatch_ms.decode": dispatch_ms_decode,
    "sync_wait_ms.decode": sync_wait_ms_decode,
    "queue_span_p95_ms": queue_span_p95_ms,
    "idle_in_dispatch_share": idle_in_dispatch_share,
    "idle_in_engine_share": idle_in_engine_share,
}


def checks(run) -> Optional[dict]:
    """The spans against the harness's outside timing in the same run:
    the queue spans' p95 beside ``queue_wait_p95_ms``, and beside it the
    p95 from each request's due time to the end of its first queue span
    (the queue span plus the time the loop took to submit the request);
    the mean pure-decode ``step`` span beside ``decode_step_ms.steady``,
    with the largest and the median excess of a step's record over its
    span, and the harness's mean without the step of the largest; the
    least share of a window step that ran work (decode or mixed) its
    children cover."""
    from bench_port.lib import stats
    rec = getattr(run, "spans", None)
    if rec is None:
        return None
    sp = Spans(rec)
    decode = sp.steps(run, _pure_decode)
    worked = sp.steps(run, lambda r: r.kind == "decode")
    cover = [sum(c["dur"] for c in sp.kids.get(e["id"], ())) / e["dur"]
             for e, _ in worked if e["dur"] > 0]
    qw = stats.p95(stats.queue_wait_s(run))
    ended = {}
    for e in rec.events:
        if e.get("req") is not None and e["name"] == "queue" \
                and e["ph"] == "X":
            ended.setdefault(e["req"], e["t"] + e["dur"])
    due = stats.p95([ended.get(r.req_id, run.end) - r.due
                     for r in stats.window_requests(run)])
    excess = sorted((r.t_end - r.t_start) - e["dur"] for e, r in decode)
    held = sum(r.t_end - r.t_start for _, r in decode)
    return {
        "queue_wait_p95_ms": None if qw is None else 1e3 * qw,
        "queue_span_p95_ms": _queue_p95_ms(run, rec),
        "queue_from_due_p95_ms": None if due is None else 1e3 * due,
        "decode_step_ms.steady": stats.decode_step_ms(run),
        "decode_step_span_ms": (1e3 * sum(e["dur"] for e, _ in decode)
                                / len(decode)) if decode else None,
        "record_excess_ms_median_max": ([1e3 * excess[len(excess) // 2],
                                         1e3 * excess[-1]]
                                        if excess else None),
        "decode_step_ms_less_largest_excess": (
            1e3 * (held - excess[-1]) / len(decode) if decode else None),
        "min_child_cover": min(cover) if cover else None,
        "steps_matched": len(worked),
        "dropped": rec.dropped,
    }


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class _Only:
    """A stopped profiler whose ``events()`` are a chosen list."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def run(cell, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root=None):
    """``cellrun.run_cell`` with a clocked recorder on the engine from the
    end of the warm-up.  Returns (outcome, extra): extra holds the clock
    alignment and the profiler's own buffer requests' share of the slice's
    idle."""
    import torch
    from bench_port.lib import cellrun, device_trace, serve, spec
    from repro_torch.serving.observability import TraceRecorder
    extra: dict = {}
    state: dict = {}
    loop_cls, read = serve.OpenLoop, device_trace.read

    class SpannedLoop(loop_cls):
        def __init__(self, engine, requests, **kw):
            super().__init__(engine, requests, **kw)
            state["rec"] = TraceRecorder(clock=self.now)
            engine.attach_trace(state["rec"])

    def read_slice(prof, step_kinds, calls, wall_s):
        cuda = torch.autograd.DeviceType.CUDA
        events = list(prof.events())
        mine = [e for e in events if not e.name.startswith(PREFIX)]
        out = read(_Only(mine), step_kinds, calls, wall_s)
        times = [(e.time_range.start / 1e6, e.time_range.end / 1e6)
                 for e in events]
        if not times:
            return out
        lo, hi = min(s for s, _ in times), max(e for _, e in times)
        # the device's copies of host ranges (user annotations) are not
        # device work: the harness leaves its own step ranges out alike
        dev = [(e.time_range.start / 1e6, e.time_range.end / 1e6)
               for e in events if e.device_type == cuda
               and not e.name.startswith((PREFIX, device_trace.STEP_TAG))]
        cpu = [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
               for e in events if e.device_type != cuda]
        out.idle_by_phase = idle_by_phase(
            dev, [c for c in cpu if c[2].startswith(PREFIX)], lo, hi)
        idle = idle_intervals(dev, lo, hi)
        total = sum(b - a for a, b in idle)
        held = idle_under(idle, [c for c in cpu if c[2] == BUFFER_REQUEST])
        extra["buffer_request_idle_share"] = (
            100.0 * (total - held.get(OUTSIDE, 0.0)) / total if total
            else None)
        extra["clock"] = state["rec"].align_profiler(events)
        return out

    serve.OpenLoop, device_trace.read = SpannedLoop, read_slice
    try:
        out = cellrun.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                               t_process=time.time(), device=device,
                               root=root or spec.ROOT)
    finally:
        serve.OpenLoop, device_trace.read = loop_cls, read
    out.run.spans = state["rec"]
    return out, extra


def one(args) -> dict:
    import torch
    from bench_port.lib import cellrun, spec
    cell = spec.find_cell(args.workload)
    out, extra = run(cell, seed=args.seed, seconds=args.seconds, trace=True)
    res = cellrun.result(cell, out, trace=True,
                         kind=torch.cuda.get_device_name(0))
    line = {"workload": args.workload, "seed": args.seed,
            "correct": out.correct,
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "readings": {k: f(out.run) for k, f in READERS.items()},
            "checks": checks(out.run),
            "idle_by_phase": getattr(out.run.trace, "idle_by_phase", None),
            "device": res["device"]}
    if args.export:
        out.run.spans.export_jsonl(args.export)
    line.update(extra)
    return line


def main(argv=None) -> int:
    # the caches where bench_port/run.py keeps them
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_port" / sub)
    os.environ["USE_FLAX"] = "0"
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--export", default=None,
                    help="write the recorder's JSONL here")
    args = ap.parse_args(argv)
    print(json.dumps(one(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
