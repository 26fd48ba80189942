"""The Nightjar planner — Algorithm 1 of the paper, verbatim.

Per-batch-size timelines organised into exponentially growing *blocks*
(H_B = 2^(j_B - 1)) of *bins*; a bin explores with probability 1/b_B,
otherwise exploits Eq. (4):

    gamma_t = argmin_gamma { l~(B, gamma)
                             + 1[gamma_{t-1} = 0 and gamma > 0] * C_switch / gamma }

The selected arm is LOCKED for the whole bin, bounding switch count (and
hence switching regret) to O(sqrt(T)) — Appendix A.

This is host-side control logic (the paper measures arm selection at ~1e-5 s
per step); the planner state is a plain pytree of Python scalars so it can be
checkpointed and restored for fault tolerance.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .cswitch import CSwitchTable


@dataclass
class _BState:
    """Per-batch-size hierarchy state (Algorithm 1 lines 1-3)."""

    j: int = 1      # block index
    H: float = 1.0  # block duration 2^(j-1)
    b: int = 1      # bin index within block
    tau: int = 1    # round counter within bin
    gamma_curr: int = 0
    explore_bin: bool = False


@dataclass
class ArmStats:
    count: int = 0
    total: float = 0.0

    @property
    def mean(self) -> float:
        # optimistic initialisation: unseen arms look free, so exploitation
        # visits each arm at least once before trusting the estimates
        return self.total / self.count if self.count else 0.0


class NightjarPlanner:
    """Contextual MAB over speculative lengths, batch size as context."""

    name = "nightjar"

    def __init__(self, gamma_max: int, cswitch: Optional[CSwitchTable] = None,
                 *, batch_bucketing: str = "pow2", seed: int = 0,
                 use_switch_cost: bool = True):
        self.gamma_max = gamma_max
        self.cswitch = cswitch or CSwitchTable.constant(0.0)
        self.use_switch_cost = use_switch_cost
        self.batch_bucketing = batch_bucketing
        self.rng = random.Random(seed)
        self.states: Dict[int, _BState] = {}
        self.stats: Dict[Tuple[int, int], ArmStats] = {}
        self.prev_gamma: int = 0  # gamma_{t-1} (global across batch sizes)
        self.t: int = 0
        self.switch_count: int = 0

    # ------------------------------------------------------------------
    def bucket(self, batch: int) -> int:
        if self.batch_bucketing == "exact":
            return max(batch, 1)
        return 1 << max(batch - 1, 0).bit_length()  # next power of two

    def _arm_stats(self, B: int, gamma: int) -> ArmStats:
        key = (B, gamma)
        if key not in self.stats:
            self.stats[key] = ArmStats()
        return self.stats[key]

    def _eq4(self, B: int, delta_max: int, batch: int) -> int:
        """Exploitation arm: Eq. (4)."""
        best, best_val = 0, float("inf")
        for g in range(self.gamma_max + 1):
            val = self._arm_stats(B, g).mean
            if self.use_switch_cost and self.prev_gamma == 0 and g > 0:
                val += self.cswitch.lookup(delta_max, batch) / g
            if val < best_val:
                best, best_val = g, val
        return best

    # ------------------------------------------------------------------
    def select(self, batch: int, *, delta_max: int = 0) -> int:
        """Choose the speculative length for the current decoding step."""
        B = self.bucket(batch)
        st = self.states.setdefault(B, _BState())

        if st.tau == 1:  # bin start: select strategy & arm (lines 6-15)
            p = 1.0 / st.b
            if self.rng.random() < p:
                st.explore_bin = True
                st.gamma_curr = self.rng.randrange(self.gamma_max + 1)
            else:
                st.explore_bin = False
                st.gamma_curr = self._eq4(B, delta_max, batch)
        gamma = st.gamma_curr
        if gamma != self.prev_gamma:
            self.switch_count += 1
        return gamma

    def observe(self, batch: int, gamma: int, latency_per_token: float,
                *, n_accepted=None, delta_max: int = 0) -> None:
        """Record the realised loss (Eq. 1) and advance the hierarchy."""
        B = self.bucket(batch)
        st = self.states.setdefault(B, _BState())

        loss = latency_per_token
        if self.use_switch_cost and self.prev_gamma == 0 and gamma > 0:
            loss += self.cswitch.lookup(delta_max, batch) / max(gamma, 1)
        s = self._arm_stats(B, gamma)
        s.count += 1
        s.total += loss

        self.prev_gamma = gamma
        self.t += 1

        # hierarchy bookkeeping (lines 19-25)
        st.tau += 1
        if st.tau > math.sqrt(st.H):
            st.b += 1
            st.tau = 1
            if st.b > math.sqrt(st.H):
                st.j += 1
                st.H = 2.0 ** (st.j - 1)
                st.b = 1

    # ------------------------------------------------------------------
    # fault tolerance: planner state serialisation
    def state_dict(self) -> dict:
        return {
            "gamma_max": self.gamma_max,
            "prev_gamma": self.prev_gamma,
            "t": self.t,
            "switch_count": self.switch_count,
            "states": {B: vars(s).copy() for B, s in self.states.items()},
            "stats": {f"{B}:{g}": (s.count, s.total)
                      for (B, g), s in self.stats.items()},
            "rng_state": self.rng.getstate(),
        }

    def load_state_dict(self, d: dict) -> None:
        self.prev_gamma = d["prev_gamma"]
        self.t = d["t"]
        self.switch_count = d["switch_count"]
        self.states = {int(B): _BState(**s) for B, s in d["states"].items()}
        self.stats = {}
        for key, (c, tot) in d["stats"].items():
            B, g = key.split(":")
            self.stats[(int(B), int(g))] = ArmStats(count=c, total=tot)
        rs = d["rng_state"]
        # json round-trips tuples as lists
        self.rng.setstate((rs[0], tuple(rs[1]), rs[2]))
