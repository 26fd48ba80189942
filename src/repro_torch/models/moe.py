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
``cumsum``, scatter / gather, batched matmuls).

On DTensor inputs the layer runs as one ``local_map`` region: each data
shard routes, dispatches and combines its own groups (``moe_groups`` a
multiple of the batch shards, as the dry run sets it), which is where the
reference's ``shard_moe_slots`` puts the (G, E, C, d) buffers, and the
experts' ``f`` dim stays sharded over ``model`` (the output is a partial
sum there).  Where the groups do not align with the batch shards every
rank computes every group.

Used by grok-1 (8 experts, top-2) and granite-moe (32 experts, top-8).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.sharding import (axis_sizes, batch_axes, is_dtensor,
                                    reduce_partial, shard_moe_slots)
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
    if is_dtensor(x):
        return _apply_moe_sharded(cfg, p, x, capacity_factor)
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
    xin = shard_moe_slots(xin * valid[..., None].to(xf.dtype))
    yout = shard_moe_slots(_experts(cfg, p, xin))

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


def _apply_moe_sharded(cfg, p, x, capacity_factor):
    """:func:`apply_moe` of DTensors: every data shard runs its own groups
    locally over its rows of ``x`` (or all groups, replicated, where they
    do not align), the expert weights all-gathered over ``data`` and kept
    sharded on ``f`` over ``model``."""
    mesh = x.device_mesh
    names, sizes = list(mesh.mesh_dim_names), axis_sizes(mesh)
    ba = [a for a in batch_axes(mesh) if a in sizes]
    shards = math.prod(sizes[a] for a in ba)
    B, S = x.shape[:2]
    G = groups_for(cfg, B * S)
    local = G % shards == 0 and B % shards == 0
    tp = "model" in sizes and cfg.d_ff % sizes["model"] == 0

    def place(batch_dim=None, model=None):
        out = []
        for n in names:
            if n in ba and local and batch_dim is not None:
                out.append(batch_dim)
            elif n == "model" and model is not None:
                out.append(model)
            else:
                out.append(Replicate())
        return out

    split = Shard(0)
    lcfg = cfg.replace(moe_groups=G // shards if local else G)
    f_in, f_out = (Shard(2), Shard(1)) if tp else (None, None)

    def body(xl, router, wg, wu, wd):
        y, aux = apply_moe(lcfg, {"router": router, "wg": wg, "wu": wu,
                                  "wd": wd}, xl,
                           capacity_factor=capacity_factor)
        return y, aux["load_balance_loss"]

    y_place = place(split, Partial() if tp else None)
    aux_place = place(Partial("avg"))
    ins = (place(split), place(), place(model=f_in), place(model=f_in),
           place(model=f_out))
    # gradients: the weights' sum over the data shards' groups (partial
    # where the groups are local), and, with f sharded, the partial sums
    # over model of x's and the router's (each rank sees its f slice)
    part = Partial() if tp else None
    grads = (place(split, part), place(Partial(), part),
             place(Partial(), f_in), place(Partial(), f_in),
             place(Partial(), f_out))
    if not local:   # every rank runs every group: no data-axis sums
        grads = (place(model=part), place(model=part)) + ins[2:]
    fn = local_map(body, out_placements=(y_place, aux_place),
                   in_placements=ins, in_grad_placements=grads,
                   device_mesh=mesh, redistribute_inputs=True)
    y, aux = fn(x, p["router"], p["wg"], p["wu"], p["wd"])
    return reduce_partial(y), {"load_balance_loss": aux}
