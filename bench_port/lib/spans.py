"""The program's phase spans of a traced run, as the per-layer metrics
read them.

A traced run attaches ``TraceRecorder(clock=loop.now)`` to the engine
after the warm-up (``cellrun``), so every span shares the loop's clock
with ``Run.window_open`` and each ``StepRecord``.  The recorder makes each
``engine.step`` a ``step`` span, parent of ``engine.admit``, ``.memmgr``,
``.plan``, ``.reserve``, ``.catchup``, ``.execute`` and ``.commit``;
``engine.execute`` parents the backend's ``backend.copies``, ``.pack``,
``.dispatch``, ``.sync`` and ``.unpack``.  Requests have lanes: a
``submit`` instant and a ``queue`` span to the step that admits them.

The arithmetic is a copy of ``tools/span_readings.py``'s.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Tuple

from . import stats


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


def of(run) -> Optional[Spans]:
    """The run's spans, or None where a reader has nothing to read: no
    recorder, no traced slice, or a recorder that dropped events."""
    rec = run.spans
    if rec is None or run.trace is None or rec.dropped:
        return None
    return Spans(rec)


def mixed(rec) -> bool:
    """A step that ran a prefill chunk beside decode rows."""
    return rec.kind == "decode" and rec.batch > 0 and rec.prefill_tokens > 0


def decode_mean_ms(run, fn: Callable[[Spans, dict], float]
                   ) -> Optional[float]:
    """Mean over the window's pure-decode steps of ``fn(spans, step
    span)``, in ms."""
    sp = of(run)
    if sp is None:
        return None
    steps = sp.steps(run, lambda rec: rec.pure_decode)
    if not steps:
        return None
    return 1e3 * sum(fn(sp, e) for e, _ in steps) / len(steps)


def idle_share(run, pick: Callable[[str], bool]) -> Optional[float]:
    """Share of the traced slice's idle time (``Slice.idle_by_phase``)
    under the phases ``pick`` takes."""
    if of(run) is None:
        return None
    idle = run.trace.idle_by_phase
    total = sum(idle.values()) if idle else 0.0
    if total <= 0:
        return None
    return 100.0 * sum(v for k, v in idle.items() if pick(k)) / total
