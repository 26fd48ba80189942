"""The card's peaks, and the least time a piece of work can take on it.

Peaks are NVIDIA's data sheet for the H100 SXM (dense bf16, HBM3), the
card the cells run on; a roofline share is stated against them.  What a
model's work needs (a token's flops, an attention call's flops and bytes)
is counted by its architecture module (``archs/<arch>.py``).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core rate
PEAK_HBM_BYTES_S = 3.35e12   # HBM3 bandwidth


def least_time(flops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)
