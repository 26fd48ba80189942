"""Hardware profile and the memory arithmetic the real tier needs: weight
bytes and how many KV tokens fit beside the weights (the paged pool's size).
A MoE's weights count every expert; every leaf counts at its own width (the
MoE router and an SSM layer's A_log / D / dt_bias are fp32).
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
    chips: int = 1


# NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s bf16
# dense.  step_overhead and host_link_bw (PCIe Gen5 x16) are estimates, not
# measurements.
H100_SXM = HardwareProfile(
    name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9,
    step_overhead=20e-6, host_link_bw=64e9)


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
    """Memory side of the roofline model for one hardware profile."""

    def __init__(self, hw: HardwareProfile = H100_SXM, *,
                 dtype_bytes: int = 2):
        self.hw = hw
        self.dtype_bytes = dtype_bytes
        self._wcache = {}   # keyed by the (frozen) config itself, not its name

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
