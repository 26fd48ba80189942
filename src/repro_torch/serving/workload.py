"""Request generators for the real-execution tier (a copy of the reference's
``tiny_requests``)."""
from __future__ import annotations

from typing import List

import numpy as np

from .request import Request


def tiny_requests(n: int, *, rate_qps: float = 100.0, prompt_len: int = 16,
                  output_len: int = 8, seed: int = 0, vocab: int = 256,
                  alpha: float = 0.9, template_len: int = 0) -> List[Request]:
    """Small deterministic workload for the real-execution tier / tests.

    ``template_len > 0`` makes the first that many prompt tokens identical
    across all requests (shared system prompt), the tiny analogue of a
    templated workload for prefix-caching tests."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    arrivals = np.cumsum(gaps)
    template = rng.integers(0, vocab,
                            size=min(template_len, prompt_len)).tolist()
    out = []
    for i in range(n):
        sfx = rng.integers(0, vocab,
                           size=prompt_len - len(template)).tolist()
        out.append(Request(i, float(arrivals[i]), prompt_len, output_len,
                           alpha, prompt_tokens=template + sfx))
    return out
