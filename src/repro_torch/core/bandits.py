"""Baseline speculative-length policies evaluated against Nightjar.

All policies share the interface:
    select(batch, delta_max=0) -> gamma
    observe(batch, gamma, latency_per_token, n_accepted=None, delta_max=0)

Implemented (paper §7.1 baselines + §8.2.1 ablations):
  * FixedGamma        — standard SD (gamma=3) / vanilla AR (gamma=0)
  * EpsilonGreedy     — decaying-epsilon bandit, batch size as context
  * UCBBandit         — BanditSpec-style UCB, NO batch-size context
  * LinUCB            — linear contextual bandit on batch-size features
  * DSD               — linear goodput model from historical acceptance;
                        reproduces the paper's "deadlock" vulnerability
                        (disabling speculation halts data collection)
  * AdaBinGreedy      — Nightjar's scaffold WITHOUT the switch-cost term
"""
from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np

from .planner import NightjarPlanner


class Policy:
    name = "policy"

    def select(self, batch: int, *, delta_max: int = 0) -> int:
        raise NotImplementedError

    def observe(self, batch: int, gamma: int, latency_per_token: float,
                *, n_accepted: Optional[float] = None, delta_max: int = 0) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


class FixedGamma(Policy):
    def __init__(self, gamma: int):
        self.gamma = gamma
        self.name = f"fixed-{gamma}" if gamma else "ar"

    def select(self, batch: int, *, delta_max: int = 0) -> int:
        return self.gamma


class EpsilonGreedy(Policy):
    name = "eps-greedy"

    def __init__(self, gamma_max: int, *, eps0: float = 0.5, decay: float = 0.999,
                 seed: int = 0, bucketing: bool = True):
        self.gamma_max = gamma_max
        self.eps = eps0
        self.decay = decay
        self.rng = random.Random(seed)
        self.bucketing = bucketing
        self.sums: Dict[Tuple[int, int], float] = defaultdict(float)
        self.counts: Dict[Tuple[int, int], int] = defaultdict(int)

    def _bucket(self, b: int) -> int:
        return 1 << max(b - 1, 0).bit_length() if self.bucketing else 0

    def select(self, batch: int, *, delta_max: int = 0) -> int:
        B = self._bucket(batch)
        if self.rng.random() < self.eps:
            return self.rng.randrange(self.gamma_max + 1)
        means = []
        for g in range(self.gamma_max + 1):
            c = self.counts[(B, g)]
            means.append(self.sums[(B, g)] / c if c else 0.0)
        return int(np.argmin(means))

    def observe(self, batch, gamma, latency_per_token, *, n_accepted=None,
                delta_max: int = 0):
        B = self._bucket(batch)
        self.sums[(B, gamma)] += latency_per_token
        self.counts[(B, gamma)] += 1
        self.eps *= self.decay


class UCBBandit(Policy):
    """BanditSpec-style UCB over arms — static, no batch-size context."""

    name = "banditspec-ucb"

    def __init__(self, gamma_max: int, *, c: float = 0.5):
        self.gamma_max = gamma_max
        self.c = c
        self.sums = np.zeros(gamma_max + 1)
        self.counts = np.zeros(gamma_max + 1, dtype=int)
        self.t = 0

    def select(self, batch: int, *, delta_max: int = 0) -> int:
        self.t += 1
        for g in range(self.gamma_max + 1):
            if self.counts[g] == 0:
                return g
        means = self.sums / self.counts
        # latency minimisation -> lower confidence bound
        bonus = self.c * np.sqrt(np.log(self.t) / self.counts)
        return int(np.argmin(means - bonus))

    def observe(self, batch, gamma, latency_per_token, *, n_accepted=None,
                delta_max: int = 0):
        self.sums[gamma] += latency_per_token
        self.counts[gamma] += 1


class LinUCB(Policy):
    """Linear contextual UCB; context = [1, B, B^2] (normalised)."""

    name = "linucb"

    def __init__(self, gamma_max: int, *, alpha: float = 0.3, b_scale: float = 64.0):
        self.gamma_max = gamma_max
        self.alpha = alpha
        self.b_scale = b_scale
        d = 3
        self.A = [np.eye(d) for _ in range(gamma_max + 1)]
        self.bv = [np.zeros(d) for _ in range(gamma_max + 1)]

    def _x(self, batch: int) -> np.ndarray:
        z = batch / self.b_scale
        return np.array([1.0, z, z * z])

    def select(self, batch: int, *, delta_max: int = 0) -> int:
        x = self._x(batch)
        best, best_val = 0, float("inf")
        for g in range(self.gamma_max + 1):
            Ainv = np.linalg.inv(self.A[g])
            theta = Ainv @ self.bv[g]
            # lower confidence bound on latency
            val = float(theta @ x) - self.alpha * math.sqrt(float(x @ Ainv @ x))
            if val < best_val:
                best, best_val = g, val
        return best

    def observe(self, batch, gamma, latency_per_token, *, n_accepted=None,
                delta_max: int = 0):
        x = self._x(batch)
        self.A[gamma] += np.outer(x, x)
        self.bv[gamma] += latency_per_token * x


class DSD(Policy):
    """Dynamic Speculative Decoding (Liu et al. 2024): linear latency model +
    historical acceptance rate; picks argmax expected goodput.

    Faithfully reproduces the deadlock: once gamma=0 is selected, acceptance
    statistics stop updating, so the expected benefit of speculation never
    recovers (paper §9.1)."""

    name = "dsd"

    def __init__(self, gamma_max: int, *, ema: float = 0.95):
        self.gamma_max = gamma_max
        self.ema = ema
        self.alpha = 0.7  # initial per-token acceptance estimate
        # per-(bucket) linear model latency(B, gamma) ~ base(B) + slope(B)*gamma
        self.lat: Dict[Tuple[int, int], float] = {}

    def _bucket(self, b: int) -> int:
        return 1 << max(b - 1, 0).bit_length()

    def _latency(self, B: int, g: int) -> float:
        if (B, g) in self.lat:
            return self.lat[(B, g)]
        # fit from the two nearest observed gammas, else optimistic constant
        obs = sorted(gg for (bb, gg) in self.lat if bb == B)
        if len(obs) >= 2:
            g1, g2 = obs[0], obs[-1]
            l1, l2 = self.lat[(B, g1)], self.lat[(B, g2)]
            slope = (l2 - l1) / max(g2 - g1, 1)
            return l1 + slope * (g - g1)
        if len(obs) == 1:
            return self.lat[(B, obs[0])]
        return 0.0

    def select(self, batch: int, *, delta_max: int = 0) -> int:
        B = self._bucket(batch)
        best, best_gp = 0, -float("inf")
        for g in range(self.gamma_max + 1):
            # expected committed tokens per step: (1 - a^(g+1)) / (1 - a)
            a = min(self.alpha, 0.999)
            exp_tokens = (1 - a ** (g + 1)) / (1 - a) if g else 1.0
            lat = self._latency(B, g)
            gp = exp_tokens / lat if lat > 0 else exp_tokens
            if gp > best_gp:
                best, best_gp = g, gp
        return best

    def observe(self, batch, gamma, latency_per_token, *, n_accepted=None,
                delta_max: int = 0):
        B = self._bucket(batch)
        # per-step latency model uses step latency = lpt * committed tokens
        step_latency = latency_per_token * ((n_accepted or 0) + 1 if gamma else 1.0)
        key = (B, gamma)
        self.lat[key] = (self.ema * self.lat[key] + (1 - self.ema) * step_latency
                         if key in self.lat else step_latency)
        if gamma > 0 and n_accepted is not None:
            # per-token acceptance probability estimate
            rate = min(n_accepted / gamma, 1.0)
            self.alpha = self.ema * self.alpha + (1 - self.ema) * rate
        # NOTE: when gamma == 0 nothing updates alpha — the deadlock.


class AdaBinGreedy(NightjarPlanner):
    """Ablation: ADA-BINGREEDY scaffold without the C_switch term."""

    name = "ada-bingreedy"

    def __init__(self, gamma_max: int, **kw):
        kw.pop("use_switch_cost", None)
        super().__init__(gamma_max, use_switch_cost=False, **kw)


def make_policy(name: str, gamma_max: int, *, cswitch=None, seed: int = 0):
    if name == "nightjar":
        return NightjarPlanner(gamma_max, cswitch, seed=seed)
    if name == "ada-bingreedy":
        return AdaBinGreedy(gamma_max, seed=seed)
    if name == "eps-greedy":
        return EpsilonGreedy(gamma_max, seed=seed)
    if name == "banditspec":
        return UCBBandit(gamma_max)
    if name == "linucb":
        return LinUCB(gamma_max)
    if name == "dsd":
        return DSD(gamma_max)
    if name == "ar" or name == "w/o-sd":
        return FixedGamma(0)
    if name.startswith("fixed-"):
        return FixedGamma(int(name.split("-")[1]))
    if name == "sd":
        return FixedGamma(3)
    raise KeyError(name)
