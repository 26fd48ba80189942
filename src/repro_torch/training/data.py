"""Deterministic synthetic token pipeline (a copy of the reference's
``SyntheticLM``, numpy only, so its batches are byte-identical to the
reference's for the same seed and step).

A seeded Zipf-ish token stream with enough structure (bigram transitions)
for a small model to show a clearly decreasing loss in a few hundred steps.
The pipeline is cursor-addressable: ``batch_at(step)`` is a pure function of
(seed, step), so a restarted job resumes mid-epoch without data skew.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device


class SyntheticLM:
    def __init__(self, vocab_size: int, *, seed: int = 0, order: int = 1):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # sparse bigram transition table: each token has k likely successors
        k = 8
        self.next_tokens = rng.integers(0, vocab_size, size=(vocab_size, k))
        self.next_probs = rng.dirichlet(np.ones(k) * 0.5, size=vocab_size)
        self.seed = seed

    def batch_at(self, step: int, batch: int, seq: int):
        """{"tokens", "labels"}: (batch, seq) int32 numpy arrays, the labels
        the tokens shifted by one."""
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cur = toks[:, t]
            choice = np.array([
                rng.choice(self.next_tokens[c], p=self.next_probs[c])
                for c in cur])
            # 10% uniform noise
            noise = rng.uniform(size=batch) < 0.1
            choice = np.where(noise, rng.integers(0, self.vocab, size=batch),
                              choice)
            toks[:, t + 1] = choice
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iter(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
                    device="cuda"):
    """``it(step)`` -> the step's batch as int32 tensors on ``device``."""
    dev = _device.resolve(device)
    ds = SyntheticLM(vocab_size, seed=seed)

    def it(step: int):
        b = ds.batch_at(step, batch, seq)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in b.items()}

    return it
