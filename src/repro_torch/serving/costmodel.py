"""Analytical roofline step-latency model (the simulated tier) and the
memory arithmetic the real tier needs.

Step latency = max(compute term, HBM term) + fixed dispatch overhead.  At
small batch the decode step is weight-read-bound (speculation amortises the
reads); at large batch the verification FLOPs push the step into the
compute-bound regime where speculation loses: the paper's crossover.

The memory half sizes the real tier's paged pool: weight bytes and how many
KV tokens fit beside the weights.  A MoE's weights count every expert;
every leaf counts at its own width (the MoE router and an SSM layer's
A_log / D / dt_bias are fp32), so every latency that reads
``weight_bytes`` differs from the reference's on those configs by exactly
that term.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from ..models import registry
from ..models.hybrid import attn_points


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # FLOP/s (bf16, dense)
    hbm_bw: float              # bytes/s
    hbm_bytes: float           # capacity
    step_overhead: float       # fixed per-step dispatch latency (s)
    host_link_bw: float        # bytes/s host<->device (offload path)
    ici_bw: float = 0.0        # bytes/s per chip-to-chip link (0: none)
    chips: int = 1


# NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s bf16
# dense.  step_overhead and host_link_bw (PCIe Gen5 x16) are estimates, not
# measurements.
H100_SXM = HardwareProfile(
    name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9,
    step_overhead=20e-6, host_link_bw=64e9)

# the paper's single-GPU testbed (for faithful-reproduction experiments)
RTX_4090 = HardwareProfile(
    name="rtx4090", peak_flops=165e12, hbm_bw=1008e9, hbm_bytes=24e9,
    step_overhead=120e-6, host_link_bw=25e9)

A100_40G = HardwareProfile(
    name="a100-40g", peak_flops=312e12, hbm_bw=1555e9, hbm_bytes=40e9,
    step_overhead=90e-6, host_link_bw=25e9)


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """K and V bytes per token across the layers that keep a KV cache: none
    for an ssm model (O(1) state), the decoder's for an encoder-decoder,
    the shared block's application points for a hybrid, every layer
    otherwise."""
    if cfg.family == "ssm":
        return 0
    layers = cfg.num_layers
    if cfg.family == "encdec":
        layers = cfg.dec_layers
    elif cfg.family == "hybrid":
        layers = len(attn_points(cfg))
    return 2 * layers * cfg.num_kv_heads * cfg.resolved_head_dim \
        * dtype_bytes


class RooflineCostModel:
    """Latency oracle and memory arithmetic for one hardware profile."""

    def __init__(self, hw: HardwareProfile = H100_SXM, *,
                 dtype_bytes: int = 2, mfu: float = 0.6, bwu: float = 0.8):
        self.hw = hw
        self.dtype_bytes = dtype_bytes
        self.mfu = mfu   # achievable fraction of peak compute
        self.bwu = bwu   # achievable fraction of HBM bandwidth
        # both caches are keyed by the (frozen) config itself, not its name
        self._pcache = {}
        self._wcache = {}

    def _params(self, cfg: ModelConfig):
        """(total, active) parameter counts."""
        if cfg not in self._pcache:
            self._pcache[cfg] = (registry.param_count(cfg),
                                 registry.active_param_count(cfg))
        return self._pcache[cfg]

    def weight_bytes(self, cfg: ModelConfig) -> float:
        """Every parameter at its leaf's own dtype where it has one (the
        MoE router, the SSM's A_log / D / dt_bias: fp32), else at
        ``dtype_bytes``."""
        if cfg not in self._wcache:
            self._wcache[cfg] = sum(
                math.prod(s.shape) * (getattr(torch, s.dtype).itemsize
                                      if s.dtype else self.dtype_bytes)
                for s in registry.leaves(registry.param_layout(cfg)))
        return self._wcache[cfg]

    # ------------------------------------------------------------------
    def decode_latency(self, cfg: ModelConfig, batch: int, ctx: int,
                       n_tokens: int = 1) -> float:
        """One forward over `n_tokens` new positions per sequence."""
        total, active = self._params(cfg)
        toks = batch * n_tokens
        flops = 2.0 * active * toks
        # attention over the KV cache
        if cfg.num_heads:
            flops += 2.0 * 2.0 * toks * ctx * cfg.num_heads * cfg.resolved_head_dim
        mem = (self.weight_bytes(cfg)
               + batch * ctx * kv_bytes_per_token(cfg, self.dtype_bytes)
               + toks * cfg.d_model * self.dtype_bytes * 8)
        chips = max(self.hw.chips, 1)
        t_compute = flops / (self.hw.peak_flops * self.mfu * chips)
        t_mem = mem / (self.hw.hbm_bw * self.bwu * chips)
        return max(t_compute, t_mem) + self.hw.step_overhead

    def prefill_latency(self, cfg: ModelConfig, batch: int, seq: int) -> float:
        total, active = self._params(cfg)
        toks = batch * seq
        flops = 2.0 * active * toks
        if cfg.num_heads:
            flops += 2.0 * 2.0 * batch * seq * seq * cfg.num_heads \
                * cfg.resolved_head_dim / 2.0  # causal half
        mem = self.weight_bytes(cfg) + toks * cfg.d_model * self.dtype_bytes * 12
        chips = max(self.hw.chips, 1)
        t_compute = flops / (self.hw.peak_flops * self.mfu * chips)
        t_mem = mem / (self.hw.hbm_bw * self.bwu * chips)
        return max(t_compute, t_mem) + self.hw.step_overhead

    def _hybrid_terms(self, cfg: ModelConfig, prefill_tokens: int,
                      batch: int, ctx: int, n_tokens: int = 1,
                      prefill_ctx: int | None = None) -> tuple:
        """(compute seconds, HBM seconds) of one fused mixed step — the two
        roofline terms, exposed so the adaptive chunk budget can find their
        crossover (the compute-bound knee)."""
        total, active = self._params(cfg)
        pctx = prefill_ctx if prefill_ctx is not None else ctx
        toks = batch * n_tokens + prefill_tokens
        flops = 2.0 * active * toks
        if cfg.num_heads:
            hd = cfg.num_heads * cfg.resolved_head_dim
            # decode positions attend to the full KV cache
            flops += 2.0 * 2.0 * batch * n_tokens * ctx * hd
            # chunk positions attend causally to their own prefix
            flops += 2.0 * 2.0 * prefill_tokens * pctx * hd / 2.0
        mem = (self.weight_bytes(cfg)
               + batch * ctx * kv_bytes_per_token(cfg, self.dtype_bytes)
               + toks * cfg.d_model * self.dtype_bytes * 8)
        chips = max(self.hw.chips, 1)
        t_compute = flops / (self.hw.peak_flops * self.mfu * chips)
        t_mem = mem / (self.hw.hbm_bw * self.bwu * chips)
        return t_compute, t_mem

    def hybrid_step_latency(self, cfg: ModelConfig, prefill_tokens: int,
                            batch: int, ctx: int, n_tokens: int = 1,
                            prefill_ctx: int | None = None) -> float:
        """One fused forward over a mixed batch: ``batch * n_tokens`` decode
        positions plus ``prefill_tokens`` prompt-chunk positions whose
        prefixes reach ``prefill_ctx`` tokens (defaults to ``ctx``).

        The chunk shares the single weight-read pass with the decode batch —
        this is the chunked-prefill payoff: in the memory-bound (small-batch)
        regime the chunk's marginal cost is almost pure FLOPs, instead of a
        whole extra weight pass per monolithic prefill call."""
        t_compute, t_mem = self._hybrid_terms(cfg, prefill_tokens, batch, ctx,
                                              n_tokens, prefill_ctx)
        return max(t_compute, t_mem) + self.hw.step_overhead

    def knee_chunk_tokens(self, cfg: ModelConfig, *, batch: int = 0,
                          ctx: int = 1024, lo: int = 16,
                          hi: int = 8192) -> int:
        """Adaptive per-step chunk budget: the largest prefill-token count
        that keeps the fused mixed step on the memory-bound side of the
        roofline (compute term <= HBM term).  Up to this knee the chunk
        rides the weight-read pass almost for free; past it every extra
        chunk token stretches the step and hurts running sequences' TPOT —
        exactly the crossover the ROADMAP's adaptive-budget item asks for."""
        def compute_bound(pt: int) -> bool:
            t_c, t_m = self._hybrid_terms(cfg, pt, batch, ctx)
            return t_c > t_m

        if compute_bound(lo):
            return lo
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if compute_bound(mid):
                hi = mid - 1
            else:
                lo = mid
        return lo

    # ------------------------------------------------------------------
    def ar_step_latency(self, target: ModelConfig, batch: int, ctx: int) -> float:
        return self.decode_latency(target, batch, ctx, 1)

    def spec_step_latency(self, target: ModelConfig, draft: ModelConfig,
                          batch: int, ctx: int, gamma: int) -> float:
        """Chain-draft gamma (+1 sync) steps, then one (gamma+1)-token verify."""
        t_draft = (gamma + 1) * self.decode_latency(draft, batch, ctx, 1)
        t_verify = self.decode_latency(target, batch, ctx, gamma + 1)
        return t_draft + t_verify

    # ------------------------------------------------------------------
    def offload_latency(self, cfg: ModelConfig) -> float:
        return self.weight_bytes(cfg) / self.hw.host_link_bw

    def reload_latency(self, cfg: ModelConfig) -> float:
        return self.weight_bytes(cfg) / self.hw.host_link_bw

    def resolve_chunk_tokens(self, value, cfg: ModelConfig | None = None,
                             *, fallback: int = 256) -> int:
        """CLI helper: ``--chunk-tokens auto`` -> the roofline knee for this
        hardware/model; a plain integer passes through; ``fallback`` covers
        the auto case when no model config is available."""
        if value == "auto":
            if cfg is None:
                return fallback
            return self.knee_chunk_tokens(cfg)
        return int(value)

    def kv_capacity_tokens(self, target: ModelConfig,
                           draft: ModelConfig | None, *,
                           reserve_frac: float = 0.1) -> int:
        """How many KV tokens fit beside the weights."""
        used = self.weight_bytes(target)
        if draft is not None:
            used += self.weight_bytes(draft)
        avail = self.hw.hbm_bytes * self.hw.chips * (1 - reserve_frac) - used
        per = max(kv_bytes_per_token(target, self.dtype_bytes), 1)
        return max(int(avail / per), 0)
