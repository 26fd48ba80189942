"""Sharding rules: parameter / batch / cache specs for every family, their
DTensor placements, and the activation hooks the models call.

The reference's scheme, on ``torch.distributed`` device meshes:

* training (``fsdp``): every weight sharded over ``data`` and ``model`` on
  its two largest dims (ZeRO-3: DTensor all-gathers at use); the residual
  stream constrained to (batch, sequence) sharding between layers
  (sequence parallelism).
* serving (``tp``): weights replicated over ``data``, sharded over
  ``model``; the KV cache shards its sequence dim over ``model`` (context
  parallelism).  ``tp_seq`` (decode) shards the attention projections'
  contraction dims, so new q / k / v come out replicated and the
  sequence-sharded cache is never resharded.
* every dim assignment is divisibility-checked with a graceful fallback,
  so odd vocab sizes (whisper 51,865) and head counts (qwen3's 40) stay
  valid.  A leading ``pod`` axis joins the batch axes (pure data
  parallelism).

Model code on DTensors runs under
``torch.distributed.tensor.experimental.implicit_replication()`` (its
position ids, RoPE angles and masks are plain tensors, replicated), and so
does the backward, which recomputes checkpointed regions.

A spec is a plain tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of names (the reference's ``PartitionSpec`` entries).
:func:`to_placements` turns it into DTensor placements.  The rule engine
reads only the mesh's axis sizes: a ``DeviceMesh``, or any mapping of axis
name to size, so specs need no process group.

The port stacks every layer group (``layers``, ``enc_layers``,
``dec_layers``) on a leading ``L`` axis, including the hybrid family's,
which the reference keeps as a list: a stacked leaf's spec is ``None``
for ``L`` followed by the rule of one layer's leaf.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor, zeros)
from torch.distributed.tensor.experimental import local_map

_STACKED = ("layers", "enc_layers", "dec_layers")

# ---------------------------------------------------------------------------
# activation hooks (called inside model code; the identity by default)
# ---------------------------------------------------------------------------

_ACT_SPEC: contextvars.ContextVar = contextvars.ContextVar("act_spec",
                                                           default=None)


def _constrain(x, spec):
    """``x`` redistributed to ``spec`` when it is a DTensor; an axis whose
    size does not divide its dim is left replicated there."""
    if not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(x.device_mesh)
    spec = tuple(e if _div(n, sizes, e) else None
                 for n, e in zip(x.shape, spec))
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def shard_activations(x):
    """The residual stream (B, S, d) between layers: batch over the data
    axes, sequence over ``model``."""
    spec = _ACT_SPEC.get()
    if spec is None or x.ndim < 3:
        return x
    batch, seq = spec
    return _constrain(x, (batch, seq) + (None,) * (x.ndim - 2))


def shard_moe_slots(x):
    """MoE dispatch buffers (G, E, C, d): the group dim G over the data
    axes, so every dispatch buffer stays shard-local."""
    spec = _ACT_SPEC.get()
    if spec is None or x.ndim != 4:
        return x
    return _constrain(x, (spec[0], None, None, None))


def shard_decode_scores(s):
    """Decode attention scores (B, KH, G, T, S): the context dim S over
    ``model`` (partial softmax per KV shard, then small reductions)."""
    spec = _ACT_SPEC.get()
    if spec is None or s.ndim != 5:
        return s
    batch, seq = spec
    return _constrain(s, (batch, None, None, None, seq))


def replicate_new_kv(x):
    """Freshly projected decode K/V (B, T, KH, hd), replicated over
    ``model`` before the cache write, so the new tokens move and not the
    sequence-sharded cache."""
    spec = _ACT_SPEC.get()
    if spec is None or x.ndim != 4:
        return x
    return _constrain(x, (spec[0], None, None, None))


def shard_kv_cache(x):
    """One layer's KV cache (B, S, KH, hd): batch over the data axes,
    sequence over ``model`` (context parallelism)."""
    spec = _ACT_SPEC.get()
    if spec is None or x.ndim != 4:
        return x
    batch, seq = spec
    return _constrain(x, (batch, seq, None, None))


@contextlib.contextmanager
def activation_sharding(batch_axes, seq_axis):
    """Set the hooks' (batch axes, sequence axis) for the enclosed calls."""
    tok = _ACT_SPEC.set((batch_axes, seq_axis))
    try:
        yield
    finally:
        _ACT_SPEC.reset(tok)


# ---------------------------------------------------------------------------
# rule engine
# ---------------------------------------------------------------------------


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, of an object whose ``shape``
    is such a mapping, or of the mapping itself."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


def _names(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _div(n: int, sizes, axes) -> bool:
    if axes is None:
        return True
    return n % math.prod(sizes[a] for a in _names(axes)) == 0


def _assign(dims, shape, idx, axes, sizes):
    """Put ``axes`` on dims[idx] if divisible and still free."""
    if dims[idx] is None and axes is not None and _div(shape[idx], sizes,
                                                       axes):
        dims[idx] = axes
        return True
    return False


def _leaf_spec(name: str, shape, sizes, *, fsdp, tp, seq_attn: bool):
    """The spec of one (unstacked) parameter leaf, keyed on its name.

    seq_attn (decode, context parallel): the attention projections shard
    their CONTRACTION dims, so q / k / v / o come out replicated (small
    reductions) and the sequence-sharded cache is never resharded."""
    dims: list = [None] * len(shape)

    def a(i, axes):
        return _assign(dims, shape, i, axes, sizes)

    if name in ("wq", "wk", "wv"):            # (d, H, hd)
        if seq_attn:
            a(0, tp)
        else:
            a(0, fsdp)
            a(1, tp) or a(2, tp)
    elif name == "wo":                         # (H, hd, d)
        if seq_attn:
            a(0, tp) or a(1, tp)
        else:
            a(0, tp) or a(1, tp)
            a(2, fsdp)
    elif name in ("wg", "wu", "w1"):           # (d, f) or (E, d, f)
        if len(shape) == 3:
            a(1, fsdp)
            a(2, tp)
        else:
            a(0, fsdp)
            a(1, tp)
    elif name in ("wd", "w2"):                 # (f, d) or (E, f, d)
        if len(shape) == 3:
            a(1, tp)
            a(2, fsdp)
        else:
            a(0, tp)
            a(1, fsdp)
    elif name == "router":                     # (d, E)
        a(0, fsdp)
    elif name in ("embed", "lm_head", "pos_embed", "enc_pos", "dec_pos"):
        a(0, tp)                               # (V or Pmax, d)
        a(1, fsdp)
    elif name in ("image_proj", "in_proj"):    # (d, d) / (d, Z)
        a(0, fsdp)
        a(1, tp)
    elif name == "out_proj":                   # (d_in, d)
        a(0, tp)
        a(1, fsdp)
    # conv_w / biases / norms / A_log / D / dt_bias: replicated
    return tuple(dims)


def _leaf_name(path) -> str:
    for key in reversed(path):
        if isinstance(key, str) and key not in ("scale", "bias"):
            return key
    return ""


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    return fn(path, tree)


def param_specs(cfg, param_tree, mesh, *, weight_mode: str = "fsdp") -> Any:
    """A tree of specs shaped like ``param_tree`` (tensors, meta or not).

    weight_mode: ``fsdp`` (train: 2-D sharding), ``tp`` (serve: replicated
    over data, head-parallel attention) or ``tp_seq`` (decode: context-
    parallel attention with row-parallel projections)."""
    if weight_mode not in ("fsdp", "tp", "tp_seq"):
        raise ValueError(f"unknown weight_mode {weight_mode!r}")
    sizes = axis_sizes(mesh)
    kw = dict(fsdp="data" if weight_mode == "fsdp" else None, tp="model",
              seq_attn=weight_mode == "tp_seq")

    def rule(path, leaf):
        name, shape = _leaf_name(path), tuple(leaf.shape)
        if any(k in _STACKED for k in path) and len(shape) >= 2:
            return (None,) + _leaf_spec(name, shape[1:], sizes, **kw)
        return _leaf_spec(name, shape, sizes, **kw)

    return _map_with_path(rule, param_tree)


# ---------------------------------------------------------------------------
# batch / cache / token specs
# ---------------------------------------------------------------------------


def batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def data_specs(cfg, batch_tree, mesh) -> Any:
    """Input batch: tokens / labels (B, S); enc_emb (B, S, d) with its
    frames over ``model``; image_emb (B, N, d)."""
    sizes, ba = axis_sizes(mesh), batch_axes(mesh)

    def rule(path, leaf):
        dims: list = [None] * leaf.ndim
        if _div(leaf.shape[0], sizes, ba):
            dims[0] = ba
        if _leaf_name(path) == "enc_emb" and _div(leaf.shape[1], sizes,
                                                  "model"):
            dims[1] = "model"
        return tuple(dims)

    return _map_with_path(rule, batch_tree)


def cache_specs(cfg, cache_tree, mesh) -> Any:
    """Decode caches: a KV sequence dim over ``model`` (context
    parallelism), batch over the data axes, SSM state heads over
    ``model``."""
    sizes, ba = axis_sizes(mesh), batch_axes(mesh)

    def rule(path, leaf):
        name, shape = _leaf_name(path), leaf.shape
        dims: list = [None] * len(shape)
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v",
                    "ssm", "conv"):
            # (L, B, S, KH, hd) / (L, B, H, P, N) / (L, B, K-1, C)
            if _div(shape[1], sizes, ba):
                dims[1] = ba
            if name != "conv" and _div(shape[2], sizes, "model"):
                dims[2] = "model"
        # length / enc_len: replicated
        return tuple(dims)

    return _map_with_path(rule, cache_tree)


def token_specs(tok_tree, mesh) -> Any:
    sizes, ba = axis_sizes(mesh), batch_axes(mesh)

    def rule(path, leaf):
        dims: list = [None] * leaf.ndim
        if _div(leaf.shape[0], sizes, ba):
            dims[0] = ba
        return tuple(dims)

    return _map_with_path(rule, tok_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec, mesh):
    """One placement per mesh dim: ``Shard(i)`` on every mesh axis named by
    entry i of ``spec``, ``Replicate()`` elsewhere.  Axes that share a
    tensor dim must be named in mesh order (major first, as XLA orders
    them)."""
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for j in idx:
            if placements[j] != Replicate():
                raise ValueError(f"mesh axis {names[j]!r} shards two dims "
                                 f"of {spec!r}")
            placements[j] = Shard(i)
    return placements


def distribute_tree(tree, spec_tree, mesh):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` with the placements
    of its spec in ``spec_tree``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh)
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh, to_placements(spec_tree, mesh))


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's DTensors (plain tensors count
    whole)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return 0
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# DTensor helpers of the model code (each the identity on a plain tensor)
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def whole(x):
    """A DTensor gathered into a plain tensor (every rank holds it whole);
    the identity on a plain tensor."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def reduce_partial(x):
    """A DTensor's pending (partial) reductions carried out: each partial
    mesh dim becomes replicated.  The identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    places = [Replicate() if p.is_partial() else p for p in x.placements]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def replicate_dim(x, dim: int):
    """A DTensor with ``dim`` gathered (replicated over every mesh axis
    that shards it) and its other placements kept, so a slice along
    ``dim`` stays local; the identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    places = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
              for p in x.placements]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def gather_sequence(x):
    """A (B, S, ...) activation with its sequence gathered: a layer takes
    the residual stream sequence-sharded (``shard_activations``, which
    also keeps the rematerialised layer inputs small) and gathers it on
    entry, so no product flattens a sharded sequence dim (DTensor's view
    rules refuse that in PyTorch 2.11) in the forward or the backward."""
    return replicate_dim(x, 1)


def full_dim(x, dim: int):
    """A DTensor with ``dim`` gathered and its partial sums reduced, for a
    reduction along ``dim`` (an argmax over the vocabulary)."""
    return reduce_partial(replicate_dim(x, dim))


def gather_weights(x):
    """ZeRO-3 at use: a DTensor weight with its shards over the data axes
    gathered (those placements replicated) and its ``model`` shards kept;
    the backward reduce-scatters the gradient.  Only a weight sharded over
    the data axes (``fsdp``) changes; the identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    places = [Replicate() if names[j] in ("pod", "data") else p
              for j, p in enumerate(x.placements)]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def tree_gather(tree):
    """:func:`gather_weights` over a tree of weights."""
    if isinstance(tree, dict):
        return {k: tree_gather(v) for k, v in tree.items()}
    return gather_weights(tree)


def align(x, ref):
    """``x`` (broadcastable to ``ref``) placed as ``ref`` where ``ref`` is a
    DTensor: each dim ``ref`` shards is sharded alike in ``x`` unless ``x``
    broadcasts there (size 1), which stays replicated.  An elementwise op
    of the two then keeps ``ref``'s sharding where DTensor might otherwise
    replicate both.  The identity when ``ref`` is a plain tensor."""
    if not isinstance(ref, DTensor):
        return x
    mesh = ref.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    off = ref.ndim - x.ndim
    places = []
    for p in ref.placements:
        d = p.dim - off if isinstance(p, Shard) else -1
        places.append(Shard(d) if d >= 0 and x.shape[d] != 1
                      else Replicate())
    return x.redistribute(mesh, places)


# ---------------------------------------------------------------------------
# local_map regions: code that runs on each rank's local shards
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# DTensor-aware ops of the model code: each is the plain torch op on a plain
# tensor, and on a DTensor the form that keeps its shards local
# ---------------------------------------------------------------------------


def embed_lookup(table, ids):
    """Rows ``table[ids]`` of an embedding (or position) table (V, d).  A
    DTensor table is gathered over the data axes first and stays
    vocab-sharded over ``model`` (an index into it would replicate it):
    each rank looks up the ids in its slice, zeroes the others, and one
    all-reduce sums the slices (what DTensor's own rule does with a
    ``MaskPartial`` placement, whose gradient it cannot take from a
    partial sum)."""
    if not isinstance(table, DTensor):
        return table[ids]
    table = gather_weights(table)
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, table.device_mesh,
                                 [Replicate()] * table.device_mesh.ndim,
                                 run_check=False)
    mesh = table.device_mesh
    split = [j for j, p in enumerate(table.placements)
             if isinstance(p, Shard)]
    if not split:
        return torch.nn.functional.embedding(ids, table)
    j = split[0]
    rows = table.shape[0] // mesh.size(j)
    lo = mesh.get_local_rank(j) * rows

    # an index, as the plain path's ``table[ids]``: its backward sums a
    # row's gradients as that path does (one rank gives its bits), where
    # ``F.embedding``'s CUDA backward sums them otherwise
    def local(i, t):
        rel = i - lo
        hit = (rel >= 0) & (rel < t.shape[0])
        return t[rel.clamp(0, t.shape[0] - 1)] * hit[..., None].to(t.dtype)
    id_place = [Replicate() if k == j else p
                for k, p in enumerate(ids.placements)]
    out_place = [Partial() if k == j else p for k, p in enumerate(id_place)]
    # each rank's table gradient comes from its own ids: a partial sum over
    # the mesh dims that shard the ids
    grad_place = [Partial() if isinstance(q, Shard) else p
                  for p, q in zip(table.placements, id_place)]
    out = local_map(local, out_placements=out_place,
                    in_placements=(id_place, list(table.placements)),
                    in_grad_placements=(id_place, grad_place),
                    device_mesh=mesh, redistribute_inputs=True)(ids, table)
    return reduce_partial(out)


def cache_write(cache, new, start):
    """Write ``new`` (B, T, KH, hd) into ``cache`` (B, S, KH, hd) at
    positions start[b] .. start[b] + T - 1, IN PLACE (``index_put_``; the
    reference builds a new array).  Every position must lie inside the
    cache.  A DTensor cache takes the reference's masked select instead (a
    scatter into a sequence-sharded cache has no sharding rule), copied
    into ``cache``.  Returns ``cache``."""
    B, T = new.shape[:2]
    if isinstance(cache, DTensor):
        S = cache.shape[1]
        pos = torch.arange(S, device=cache.device)[None, :]
        out = cache
        for t in range(T):
            sel = align((pos == (start.long() + t)[:, None])[..., None, None],
                        cache)
            out = torch.where(sel, align(new[:, t][:, None].to(cache.dtype),
                                         cache), out)
        return cache.copy_(out)
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    pos = start.long()[:, None] + torch.arange(T, device=cache.device)
    return cache.index_put_((rows, pos), new.to(cache.dtype))


def write_prefix(cache, new):
    """cache (B, S_max, ...)[:, :S] = new (B, S, ...), IN PLACE; a DTensor
    cache takes ``new`` zero-padded to S_max (a slice of a sharded dim has
    no in-place rule).  Returns ``cache``."""
    S = new.shape[1]
    if S == cache.shape[1]:
        return cache.copy_(new)
    if isinstance(cache, DTensor):
        pad = new.new_zeros((new.shape[0], cache.shape[1] - S)
                            + tuple(new.shape[2:]))
        return cache.copy_(torch.cat([new, pad], dim=1))
    cache[:, :S] = new
    return cache


def logsumexp(logits):
    """``torch.logsumexp`` over the last dim.  On a DTensor (vocabulary
    sharded over ``model``) from a shard-local max and sum (two small
    reductions) where ``torch.logsumexp`` would gather the vocabulary.  Its
    gradient is written as ``torch.logsumexp``'s backward writes it,
    ``exp(logits - lse)`` times the incoming gradient (the sum ``s`` below
    is 1 in value, and ``s - s.detach()`` adds an exact zero): the
    quotient form ``exp(logits - m) / total`` differs in fp32 rounding,
    which flips bf16 roundings once the gradient enters the unembedding's
    product, and the flips grow through the layers' bf16 backward (1.56e-2
    of a 24-layer draft's worst gradient leaf on one rank).  One rank thus
    gives the unsharded path's bits, at one more exp over the chunk."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    x = logits.detach()
    m = reduce_partial(x.amax(dim=-1, keepdim=True))
    lse = m + torch.log(reduce_partial(torch.exp(x - m).sum(-1,
                                                            keepdim=True)))
    s = reduce_partial(torch.exp(logits - lse).sum(-1, keepdim=True))
    return (lse + (s - s.detach()))[..., 0]


def label_logits(logits, y):
    """logits (B, C, V)[b, c, y[b, c]].  On a DTensor (vocab sharded over
    ``model``) a masked sum over the vocabulary, which stays shard-local up
    to one small reduction (a gather across shards has no sharding rule);
    the same value, since every other term is an exact zero."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, y[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return reduce_partial(torch.where(
        align(vocab == y[..., None], logits), logits,
        torch.zeros_like(logits)).sum(-1))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    transposed local gradient leaving a ``local_map`` region would reach
    DTensor's ``view`` rules, which assume the local shard is laid out as
    the global tensor."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def attention_local_map(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (attention over (B, S, H, D) / (B, S, KH, D));
    DTensors run on each rank's local shards through ``local_map``: batch
    over the data axes and heads over ``model`` where they divide
    (``model`` must split the KV heads too, so each rank keeps whole GQA
    groups), the sequence replicated.  The output keeps q's placements."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kw)
    mesh = q.device_mesh
    sizes, ba = axis_sizes(mesh), batch_axes(mesh)
    B, H, KH = q.shape[0], q.shape[2], k.shape[2]
    spec = [None, None, None, None]
    if _div(B, sizes, tuple(a for a in ba if a in sizes)):
        spec[0] = tuple(a for a in ba if a in sizes)
    if "model" in sizes and H % sizes["model"] == 0 \
            and KH % sizes["model"] == 0:
        spec[2] = "model"
    place = to_placements(tuple(spec), mesh)

    def local(a, b, c):
        return fn(_ContiguousGrad.apply(a), _ContiguousGrad.apply(b),
                  _ContiguousGrad.apply(c), **kw)
    mapped = local_map(local,
                       out_placements=place,
                       in_placements=(place, place, place),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(q, k, v)


def batch_local(fn, batched, weights, n_out: int):
    """``fn(*batched, weights)`` run on each rank's batch rows through
    ``local_map``: every tensor of ``batched`` (batch-leading; None passes)
    split on dim 0 over the data axes where the batch divides, replicated
    elsewhere, and ``weights`` (a dict of DTensor weights) gathered whole.
    ``fn`` returns ``n_out`` batch-leading tensors, placed as the inputs.
    Each rank's weight gradient is a partial sum over the data axes.  For
    a layer whose parts do not split over ``model`` (an SSM layer: its
    fused projection mixes z, x, B, C and dt)."""
    ref = next(t for t in batched if isinstance(t, DTensor))
    mesh = ref.device_mesh
    sizes = axis_sizes(mesh)
    ba = tuple(a for a in batch_axes(mesh) if a in sizes)
    split = _div(ref.shape[0], sizes, ba)
    names = mesh.mesh_dim_names
    rows = [Shard(0) if split and n in ba else Replicate() for n in names]
    whole = [Replicate()] * len(names)
    wgrad = [Partial() if split and n in ba else Replicate() for n in names]
    keys = list(weights)
    nb = len(batched)

    def local(*a):
        return fn(*a[:nb], dict(zip(keys, a[nb:])))
    ins = tuple(None if t is None else rows for t in batched)
    mapped = local_map(local, out_placements=(rows,) * n_out,
                       in_placements=ins + (whole,) * len(keys),
                       in_grad_placements=ins + (wgrad,) * len(keys),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(*batched, *(weights[k] for k in keys))


def new_cache(make, ref):
    """A fresh cache: ``make(device)`` on ``ref``'s device, or, when
    ``ref`` is a DTensor, zeros of ``make("meta")``'s shapes sharded as
    :func:`cache_specs` over ``ref``'s mesh (only the local shards are
    allocated)."""
    if not isinstance(ref, DTensor):
        return make(ref.device)
    mesh = ref.device_mesh
    meta = make("meta")
    specs = cache_specs(None, meta, mesh)

    def build(t, spec):
        if isinstance(t, dict):
            return {k: build(t[k], spec[k]) for k in t}
        return zeros(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
                     placements=to_placements(spec, mesh))
    return build(meta, specs)
