"""Switching-cost (C_switch) lookup table — paper §5.2 "Prefill Cost Modeling".

Re-enabling speculation after a disabled phase forces the draft model to
re-prefill the ``delta`` tokens it skipped.  The cost is profiled offline on a
grid of (skip length, batch size) — Table 3 of the paper — and queried at
run time with the *effective skip length* ``delta_max = max_i delta_i``.

Two constructors:
  * profile() — real tier: measures T_SD - T_base wall-clock on the actual
    models.
  * from_cost_model() — analytical tier: derives the same quantity from a
    roofline step-latency model.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple


def _geometric_grid(lo: int, hi: int) -> List[int]:
    out, v = [], max(lo, 1)
    while v <= hi:
        out.append(v)
        v *= 2
    return out


@dataclass
class CSwitchTable:
    """C_switch(delta_max, B) lookup with nearest-grid-point retrieval."""

    deltas: Tuple[int, ...]
    batches: Tuple[int, ...]
    table: Dict[Tuple[int, int], float]  # (delta, batch) -> seconds

    def lookup(self, delta_max: int, batch: int) -> float:
        d = self._nearest(self.deltas, delta_max)
        b = self._nearest(self.batches, batch)
        return self.table[(d, b)]

    @property
    def c_max(self) -> float:
        return max(self.table.values()) if self.table else 0.0

    @staticmethod
    def _nearest(grid: Sequence[int], x: int) -> int:
        i = bisect.bisect_left(grid, x)
        if i == 0:
            return grid[0]
        if i == len(grid):
            return grid[-1]
        lo, hi = grid[i - 1], grid[i]
        return lo if (x - lo) <= (hi - x) else hi

    # ------------------------------------------------------------------
    @classmethod
    def constant(cls, value: float) -> "CSwitchTable":
        return cls(deltas=(1,), batches=(1,), table={(1, 1): value})

    @classmethod
    def profile(cls, measure_fn: Callable[[int, int], float],
                deltas: Sequence[int] = (128, 256, 512),
                batches: Sequence[int] = (2, 4, 8, 16, 32, 64)) -> "CSwitchTable":
        """measure_fn(delta, batch) -> seconds of extra latency (T_SD - T_base)."""
        table = {}
        for d in deltas:
            for b in batches:
                table[(d, b)] = max(measure_fn(d, b), 0.0)
        return cls(deltas=tuple(sorted(set(deltas))),
                   batches=tuple(sorted(set(batches))), table=table)

    @classmethod
    def from_cost_model(cls, cost_model, draft_cfg,
                        deltas: Sequence[int] = (128, 256, 512, 1024, 2048),
                        batches: Sequence[int] = (2, 4, 8, 16, 32, 64, 128)
                        ) -> "CSwitchTable":
        """Analytical tier: C_switch = draft-prefill(delta, B) latency."""
        table = {}
        for d in deltas:
            for b in batches:
                table[(d, b)] = cost_model.prefill_latency(draft_cfg, b, d)
        return cls(deltas=tuple(sorted(set(deltas))),
                   batches=tuple(sorted(set(batches))), table=table)
