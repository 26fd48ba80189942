"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds of the window, read into device busy time, kernels by name and
step, the longest idle gaps by what the host was doing, and the idle time
by the program's phase.

The program's phase spans (a ``TraceRecorder`` with a clock, attached in
traced runs) are also profiler ranges named ``nightjar.<phase>``, and the
profiler copies each range onto the device's timeline.  Neither is work:
both are kept out of busy time, kernel time, the kernel count and the
gaps' labels, and the host ranges are read into ``idle_by_phase``.

The arithmetic of busy time (the union of the device operations'
intervals) is a copy of ``repro_torch.launch.profile_serve._busy_us``;
that of idle time by phase, of ``tools/span_readings.py``.  The slice is
short because every kernel of a launch-bound step is an event: a few
seconds hold some hundred thousand of them.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

TRACE_OFFSET_S = 5.0    # the slice starts this long after the window opens
TRACE_SECONDS = 3.0     # and lasts this long
STEP_TAG = "bench_port.step#"
PHASE_PREFIX = "nightjar."   # the program's phase spans as profiler ranges
OUTSIDE = "outside"          # idle time under no phase range
TOP = 10


@dataclass
class Slice:
    """What the traced slice holds, in seconds on the profiler's clock."""
    wall_s: float = 0.0
    busy_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    kernels_by_step: Dict[int, int] = field(default_factory=dict)
    kernel_s: Dict[str, float] = field(default_factory=dict)
    calls: list = field(default_factory=list)   # CallLog.rows()
    # device-idle seconds of the slice under the innermost phase range
    # (named without ``nightjar.``), ``outside`` where none covers it
    idle_by_phase: Dict[str, float] = field(default_factory=dict)


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged [start, end) intervals, sorted."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(spans) -> float:
    return sum(e - s for s, e in union(spans))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def gap_label(a: float, b: float, cpu, steps) -> str:
    """What the host did while the device sat idle over [a, b): the
    innermost host operation covering the gap's middle, inside the step
    that covers it ("python" where no operator covers it: the engine's,
    scheduler's or backend's own code)."""
    mid = 0.5 * (a + b)
    step = next((n for s, e, n in steps if s <= mid < e), None)
    inner = None
    for s, e, n in cpu:
        if s <= mid < e and (inner is None or e - s < inner[1] - inner[0]):
            inner = (s, e, n)
    where = step or "between steps"
    return f"{where}: {inner[2]}" if inner else f"{where}: python"


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
    out, at = [], lo
    for s, e in union(device):
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


def read(prof, step_kinds: Dict[int, str], calls, wall_s: float) -> Slice:
    """A stopped profiler's events read into a :class:`Slice`;
    ``step_kinds`` names each traced step by its index, ``wall_s`` is the
    slice's length on the host clock.  Idle time by phase is taken over
    the span of all the events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu, steps, phases = [], [], [], []
    lo = hi = None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        lo, hi = (s, t) if lo is None else (min(lo, s), max(hi, t))
        if e.name.startswith(PHASE_PREFIX):
            if e.device_type != cuda:
                phases.append((s, t, e.name[len(PHASE_PREFIX):]))
        elif e.name.startswith(STEP_TAG):
            if e.device_type != cuda:
                steps.append((s, t, int(e.name[len(STEP_TAG):])))
        elif e.device_type == cuda:
            dev.append((s, t, e.name))
        elif not e.name.startswith(("cuda", "cu", "ProfilerStep")):
            cpu.append((s, t, e.name))
    out = Slice(wall_s=wall_s, calls=calls)
    if lo is not None:
        out.idle_by_phase = idle_under(
            idle_intervals([(s, t) for s, t, _ in dev], lo, hi), phases)
    if not dev:
        return out
    spans = [(s, t) for s, t, _ in dev]
    merged = union(spans)
    out.busy_s = busy(spans)
    by_name: Dict[str, float] = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s)
    out.kernel_s = by_name
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    named = [(s, t, f"{step_kinds.get(i, '?')} step") for s, t, i in steps]
    gaps = [(a[1], b[0]) for a, b in zip(merged[:-1], merged[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    out.idle_gaps = [(gap_label(a, b, cpu, named), b - a)
                     for a, b in gaps[:TOP]]
    starts = sorted(s for s, _, n in dev if is_kernel(n))
    for s, t, i in steps:
        out.kernels_by_step[i] = (bisect.bisect_left(starts, t)
                                  - bisect.bisect_left(starts, s))
    return out


def warm_profiler() -> None:
    """Start and stop the profiler once during set-up: its first start
    loads and initialises the device tracing library, which takes seconds
    and would otherwise stall the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Tracer:
    """Starts the profiler at the first step boundary after
    ``start_at`` and stops it at the first boundary ``TRACE_SECONDS``
    after it started (seconds on the loop's clock); every step in
    between runs under a ``record_function`` named by its index."""

    def __init__(self, start_at: float, call_log):
        self.start_at = start_at
        self.stop_at = start_at + TRACE_SECONDS
        self.log = call_log
        self.prof = None
        self.done = False
        self.wall = (0.0, 0.0)
        self.first_step = self.last_step = None

    def on_step(self, loop, now: float) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if self.done:
            return
        if self.prof is None and now >= self.start_at:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.log.on = True
            self.first_step = len(loop.steps)
            self.wall = (time.perf_counter(), 0.0)
            self.stop_at = loop.now() + TRACE_SECONDS
            self._wrap(loop)
        elif self.prof is not None and now >= self.stop_at:
            torch.cuda.synchronize()
            self.log.on = False
            self.last_step = len(loop.steps)
            self.prof.__exit__(None, None, None)
            self.wall = (self.wall[0], time.perf_counter())
            loop.step_once = self._inner
            self.done = True

    def finish(self, loop) -> None:
        """Stop a slice the run's end left open."""
        if self.prof is not None and not self.done:
            self.on_step(loop, float("inf"))

    def _wrap(self, loop) -> None:
        import torch
        inner = loop.step_once
        self._inner = inner

        def step_once(now):
            with torch.profiler.record_function(
                    f"{STEP_TAG}{len(loop.steps)}"):
                return inner(now)

        loop.step_once = step_once

    def slice(self, loop) -> Optional[Slice]:
        """The slice read (after the run); None if it never ran."""
        if self.prof is None or not self.done:
            return None
        kinds = {st.index: ("decode" if st.pure_decode else
                            "mixed" if st.kind == "decode" else st.kind)
                 for st in loop.steps[self.first_step:self.last_step]}
        return read(self.prof, kinds, self.log.rows(),
                    self.wall[1] - self.wall[0])
