"""AdamW with global-norm clipping and a cosine schedule, from scratch.

The reference's arithmetic leaf by leaf (no ``torch.optim``, so the numbers
are the reference's): fp32 moments, clipping by the global norm, bias
correction with the incremented step, decoupled weight decay.  Parameter
trees are nested dicts of tensors; the update runs under ``torch.no_grad``
and writes the parameters and moments IN PLACE (the reference builds new
arrays and donates the old ones to ``jit``), each in its own dtype.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..models.common import leaves


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    m: Any
    v: Any


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def adamw_init(params, *, m_dtype=torch.float32,
               v_dtype=torch.float32) -> AdamWState:
    """Zero moments shaped (and, for DTensors, placed) like ``params``
    (``v_dtype`` bf16 is the reference's memory-fit option for the largest
    models)."""
    leaf = next(leaves(params))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=m_dtype), params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=v_dtype), params))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step) as an fp32 tensor: linear warm-up to ``base_lr`` over
    ``warmup`` steps, then a cosine decay to 0 at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr_fn,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One step: returns (params, new state, global grad norm).  The
    parameter and moment tensors are updated in place and returned in the
    same trees; the step counter is a new tensor."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    lr = lr_fn(step)

    def upd(g, m, v, p):
        g = g.float() * scale
        m.copy_(b1 * m.float() + (1 - b1) * g)
        v.copy_(b2 * v.float() + (1 - b2) * g.square())
        mhat = m.float() / bc1
        vhat = v.float() / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    tree_map(upd, grads, state.m, state.v, params)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
