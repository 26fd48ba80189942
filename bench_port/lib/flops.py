"""Operations and bytes the benchmark counts itself, and the card's peaks.

Peaks are NVIDIA's data sheet for the H100 SXM (dense bf16, HBM3), the
card the cells run on; a roofline share is stated against them.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core rate
PEAK_HBM_BYTES_S = 3.35e12   # HBM3 bandwidth


def least_time(flops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def paged_attention_need(rows: Iterable[Tuple[int, int]], *, heads: int,
                         kv_heads: int, head_dim: int, elem_bytes: int
                         ) -> Tuple[float, float]:
    """(flops, bytes) that one ``paged_attention`` call needs for its real
    rows: each row is (start, n) — n new queries after ``start`` cached
    positions, query t seeing start + t + 1 positions.  Bytes: the K and V
    of every position a row reads, each once, plus its queries read and
    its outputs written.  Flops: QK^T and PV, 2 each per (query, position,
    head, dim).  Padded rows and padded query slots are work no input
    needs, so they count nothing."""
    flops = nbytes = 0.0
    for start, n in rows:
        seen = n * start + n * (n + 1) // 2
        flops += 4.0 * heads * head_dim * seen
        nbytes += elem_bytes * head_dim * (2 * kv_heads * (start + n)
                                           + 2 * heads * n)
    return flops, nbytes


def matmul_params_per_token(m: dict) -> int:
    """Weights one token multiplies by in the target: q, k, v, o and the
    MLP (a MoE: its router and top-k experts) of every layer, and the
    unembedding.  ``m`` holds the model's sizes (``reference.model_sizes``
    keys)."""
    d, H, KH, hd = m["d_model"], m["heads"], m["kv_heads"], m["head_dim"]
    attn = d * (H + 2 * KH) * hd + H * hd * d
    if m["experts"]:
        mlp = d * m["experts"] + m["top_k"] * 3 * d * m["d_ff"]
    else:
        mlp = 3 * d * m["d_ff"]
    return m["layers"] * (attn + mlp) + m["vocab"] * d


def token_flops(m: dict, ctx: int) -> float:
    """Useful flops of one token that sees ``ctx`` positions: 2 per
    weight it multiplies by, and QK^T + PV over the context in every
    layer."""
    return (2.0 * matmul_params_per_token(m)
            + 4.0 * m["layers"] * m["heads"] * m["head_dim"] * ctx)
