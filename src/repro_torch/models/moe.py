"""Mixture-of-Experts layer with group-local capacity dispatch.

The same function as the reference's ``models/moe.py``, not an equivalent
one: token dropping makes a token's output depend on the other tokens of
its call, so the groups, the fp32 router, the capacity, the queue order and
the drop rule follow the reference step for step.

* tokens split into ``moe_groups`` groups (one group when T % G != 0);
* router in fp32: softmax, top-k (descending), renormalised over the k;
* capacity C = max(8, roundup8(int(Tg * k * cf / E) + 1)) per expert and
  group;
* queue order: each (token, slot) takes its place in its expert's queue by
  an exclusive cumsum, token-major, then by k-rank; places at or past C are
  dropped;
* the expert MLPs (swiglu / geglu) run over the (G, E, C) slot table and
  the outputs combine gate-weighted.

The reference computes the routing and the expert products outside any
Pallas kernel, so the port keeps them in plain PyTorch (``topk``,
``cumsum``, scatter / gather, batched matmuls).  ``shard_moe_slots`` is a
no-op on one device and has no counterpart.

Used by grok-1 (8 experts, top-2) and granite-moe (32 experts, top-8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import Spec


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 factor: float) -> int:
    cap = int(num_tokens * top_k * factor / num_experts) + 1
    # round up to a multiple of 8, as the reference does
    return max(8, ((cap + 7) // 8) * 8)


def moe_layout(cfg, lead=()):
    """The layer's parameters as :class:`Spec` leaves; the router stays
    fp32 in a model of any dtype."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    return {"router": Spec(lead + (d, E), "dense", d, "float32"),
            "wg": Spec(lead + (E, d, f), "dense", d),
            "wu": Spec(lead + (E, d, f), "dense", d),
            "wd": Spec(lead + (E, f, d), "dense", f)}


class Routing(NamedTuple):
    """The dispatch of one call: per group (G, Tg * k) token-major slots."""
    probs: torch.Tensor       # (G, Tg, E) fp32 router softmax
    gates: torch.Tensor       # (G, Tg, k) renormalised top-k gates
    expert: torch.Tensor      # (G, Tg * k) expert of each (token, slot)
    position: torch.Tensor    # (G, Tg * k) place in that expert's queue
    capacity: int             # C

    @property
    def kept(self) -> torch.Tensor:
        """(G, Tg * k) bool: the (token, slot) pairs inside capacity."""
        return self.position < self.capacity


def groups_for(cfg, num_tokens: int) -> int:
    G = cfg.moe_groups
    return 1 if num_tokens % G else G


def route(cfg, router, xf, capacity_factor: float) -> Routing:
    """xf (G, Tg, d) -> the call's :class:`Routing`."""
    G, Tg, _ = xf.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    expert = idx.reshape(G, Tg * k)
    onehot = F.one_hot(expert, E)                       # (G, Tg*k, E)
    position = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    return Routing(probs, gates, expert, position,
                   moe_capacity(Tg, E, k, capacity_factor))


def _experts(cfg, p, xin):
    """The E expert MLPs over their slots: xin (G, E, C, d) -> same."""
    G, E, C, d = xin.shape
    xe = xin.transpose(0, 1).reshape(E, G * C, d)
    a = torch.bmm(xe, p["wg"])
    if cfg.mlp_type == "geglu":
        a = F.gelu(a, approximate="tanh")
    else:
        a = F.silu(a)
    y = torch.bmm(a * torch.bmm(xe, p["wu"]), p["wd"])   # (E, G*C, d)
    return y.reshape(E, G, C, d).transpose(0, 1)


def apply_moe(cfg, p, x, *, capacity_factor: Optional[float] = None):
    """x (B, S, d) -> ((B, S, d) in x's dtype, aux losses dict)."""
    B, S, d = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    G = groups_for(cfg, T)
    Tg = T // G
    xf = x.reshape(G, Tg, d)
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe_capacity_factor)
    r = route(cfg, p["router"], xf, cf)
    C = r.capacity
    dev = x.device

    # the (G, E, C) slot table of token ids, -1 where empty; places past
    # capacity are dropped: they land in a spare column C, cut off after
    # the scatter (no boolean indexing, so the host never waits on the
    # device here)
    tok = torch.arange(Tg, device=dev).repeat_interleave(k).expand(G, -1)
    gi = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    place = torch.where(r.kept, r.position, C)
    table = torch.full((G, E, C + 1), -1, dtype=torch.long, device=dev)
    table[gi, r.expert, place] = tok
    table = table[..., :C]
    valid = table >= 0

    xin = torch.gather(xf, 1, table.clamp(min=0).reshape(G, E * C, 1)
                       .expand(G, E * C, d)).reshape(G, E, C, d)
    xin = xin * valid[..., None].to(xf.dtype)
    yout = _experts(cfg, p, xin)

    # combine: each (token, slot)'s expert output, zero where it was dropped
    flat = r.expert * C + r.position.clamp(max=C - 1)            # (G, Tg*k)
    y_slots = torch.gather(yout.reshape(G, E * C, d), 1,
                           flat[..., None].expand(G, Tg * k, d))
    kept = torch.gather(table.reshape(G, E * C), 1, flat) == tok
    y_slots = y_slots * kept[..., None].to(y_slots.dtype)
    y = (y_slots.float() * r.gates.reshape(G, Tg * k, 1)).reshape(
        G, Tg, k, d).sum(2)

    # load-balancing auxiliary loss (Switch-style)
    me = r.probs.mean(dim=(0, 1))
    ce = F.one_hot(r.expert.reshape(G, Tg, k)[..., 0], E).float().mean(
        dim=(0, 1))
    aux = {"load_balance_loss": E * torch.sum(me * ce)}
    return y.reshape(B, S, d).to(x.dtype), aux
