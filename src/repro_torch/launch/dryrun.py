"""Dry run: one step of every (architecture x input shape) cell on a fake
H100 cluster, with per-device flops, bytes, collectives and peak memory.

The counterpart of the reference's lower + compile on 512 placeholder XLA
devices: the cell's step executes once under ``FakeTensorMode`` (tensors
with shapes, dtypes and devices but no storage) with DTensor parameters,
inputs and caches on a fake process group of the mesh's size (256 ranks,
or 512 multi-pod).  Every number is read on rank 0's LOCAL shards:

* flops: ``torch.utils.flop_counter``'s formulas (the flash kernel's
  custom ops register theirs) applied to each local op's shapes — at the
  DTensor level a flop counter would see the global op;
* bytes: each local op's input and output bytes (views excluded);
* collectives: the functional collectives DTensor issues, bytes of each
  result by kind and by mesh axis (from the group's name);
* argument bytes: the local shards of parameters, optimizer state, batch
  and cache; peak: the largest sum of live local storages (each storage
  from its first op to its release).

Times are estimates from the H100 SXM data sheet, not measurements:
989e12 FLOP/s dense bf16, 3.35e12 B/s HBM, 80e9 B HBM; the model axis
runs over NVLink 4 (450e9 B/s per direction), the data and pod axes over
InfiniBand NDR (50e9 B/s per GPU).  ``collective_s`` sums each axis's
bytes over its link.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --json out.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper-7b --shape decode_32k --spec

The fake tensors live on ``--device``: by default ``cuda`` when a card is
present (the card's route: the flash kernel's custom ops), else ``cpu``
(the plain PyTorch versions; autograd of fake CUDA tensors needs a CUDA
build of PyTorch).  A cell that raises is listed FAILED, as in the
reference.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import weakref
from collections import Counter

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..configs.base import ShapeConfig, shapes_for
from ..distributed import sharding as shd
from ..models import registry
from .mesh import make_production_mesh

# H100 SXM data sheet (dense bf16; HBM3; NVLink 4; InfiniBand NDR per GPU)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NVLINK_BW = 450e9
IB_BW = 50e9
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class LocalCounter(TorchDispatchMode):
    """Counts what rank 0 executes on fake tensors: flops, bytes,
    collectives and the peak of live storages.  It steps aside for
    DTensor-level ops (returns NotImplemented), so DTensor's dispatch runs
    beneath it and every local op and collective it issues passes through
    here.  ``mesh`` names the collectives' axes (none for a plain run)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.axis_of = {} if mesh is None else {
            mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = Counter()
        self.coll_counts = Counter()
        self.live = {}
        self.current = 0
        self.peak = 0

    def track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self.live.pop(key, None)
            self.current -= n
        self.live[key] = weakref.ref(st, freed)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        # host bookkeeping, and meta tensors that only describe shapes (a
        # cache's layout before its shards are allocated): no device op
        if not any(isinstance(t, FakeTensor) and t.device.type != "meta"
                   for t in ins + outs):
            return out
        for t in outs:
            self.track(t)
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                group = next((a for a in list(args) + list(kwargs.values())
                              if isinstance(a, str)), "")
                self.coll_counts[kind] += 1
                self.coll_bytes[self.axis_of.get(group, "data")] += sum(
                    _nbytes(t) for t in outs)
            return out
        fn = self.registry.get(func.overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


def _modes_aside(owner, name):
    """Wrap ``owner.name`` to run with every dispatch mode set aside;
    returns the original to restore."""
    orig = owner.__dict__[name]
    kind = type(orig) if isinstance(orig, (staticmethod, classmethod)) \
        else None
    fn = orig.__func__ if kind else orig

    def wrapped(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)
    setattr(owner, name, kind(wrapped) if kind else wrapped)
    return orig


@contextlib.contextmanager
def _dtensor_bookkeeping_aside():
    """DTensor's own host-side work runs with the modes set aside, so the
    counter sees only the local computation, and fake tensors do not break
    it: the output metadata of each op is derived by running it on fake
    tensors of the GLOBAL shape, and a strided shard is sized with a host
    ``arange`` (whose ``tolist`` raises on a fake tensor).

    Both are private to DTensor.  The propagator must be found: left
    inside the counter, its global-shape ops would be counted as local
    work without a word, so a PyTorch without it raises here.  The strided
    shard's sizing exists only where ``_StridedShard`` defines it."""
    from torch.distributed.tensor import _sharding_prop, placement_types
    prop = (_sharding_prop.ShardingPropagator,
            "_propagate_tensor_meta_non_cached")
    if prop[1] not in prop[0].__dict__:
        raise RuntimeError(
            "this PyTorch's DTensor has no ShardingPropagator."
            "_propagate_tensor_meta_non_cached: the dry run cannot keep "
            "DTensor's global-shape metadata ops out of its local counts")
    targets = [prop]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in \
            strided.__dict__:
        targets.append((strided, "local_shard_size_and_offset"))
    done = []
    for owner, name in targets:
        done.append((owner, name, _modes_aside(owner, name)))
    try:
        yield
    finally:
        for owner, name, orig in done:
            setattr(owner, name, orig)


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process is rank 0),
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _weight_mode(cfg, shape_kind: str, mesh) -> str:
    """Serving prefers TP weights (replicated over data) when they fit in
    0.55 of a card; decode uses the context-parallel attention sharding
    (tp_seq); training shards 2-D (fsdp)."""
    if shape_kind == "train":
        return "fsdp"
    per_gpu = registry.param_bytes(cfg) / shd.axis_sizes(mesh)["model"]
    if per_gpu >= 0.55 * HBM_BYTES:
        return "fsdp"
    return "tp_seq" if shape_kind == "decode" else "tp"


def _cache_for(api, cfg, shape, device="meta"):
    """The decode cache a cell holds: a decode cell's input, a prefill
    cell's output (an encoder-decoder's at its S / 4 prompt and S-frame
    cross-attention)."""
    B = shape.global_batch
    if cfg.family == "encdec":
        enc_len = shape.seq_len if shape.kind == "prefill" else cfg.enc_context
        dec_len = max(shape.seq_len // 4, 1) if shape.kind == "prefill" \
            else shape.seq_len
        return api.init_cache(B, dec_len, enc_len=enc_len, device=device)
    return api.init_cache(B, shape.seq_len, device=device)


def _sharded(meta_tree, spec_tree, mesh, *, grad=False):
    """Empty DTensors (only local shards allocated) shaped like a meta
    tree, placed by ``spec_tree``."""
    from torch.distributed.tensor import empty
    if isinstance(meta_tree, dict):
        return {k: _sharded(meta_tree[k], spec_tree[k], mesh, grad=grad)
                for k in meta_tree}
    t = empty(tuple(meta_tree.shape), dtype=meta_tree.dtype,
              device_mesh=mesh,
              placements=shd.to_placements(spec_tree, mesh))
    return t.requires_grad_(True) if grad else t


def build_cell(arch: str, shape: ShapeConfig, mesh, *, spec_decode=False,
               cfg_override=None, accum_override=None):
    """-> (fn, args, meta): ``fn(*args)`` is the cell's step on DTensors
    (to be called under ``FakeTensorMode``).  A train cell rematerialises
    every layer (``remat="full"``), as the reference's."""
    cfg = configs.get_config(arch)
    if shape.kind == "train":
        cfg = cfg.replace(remat="full")
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    sizes = shd.axis_sizes(mesh)
    ba = shd.batch_axes(mesh)
    if cfg.moe_num_experts:
        # group-local dispatch aligned with the data-parallel shards
        cfg = cfg.replace(moe_groups=sizes.get("pod", 1) * sizes["data"])
        if shape.kind != "train":
            cfg = cfg.replace(moe_capacity_factor=1.0)
    api = registry.get_model(cfg)
    mode = _weight_mode(cfg, shape.kind, mesh)
    meta_params = registry.param_specs(cfg)
    pspecs = shd.param_specs(cfg, meta_params, mesh, weight_mode=mode)
    params = _sharded(meta_params, pspecs, mesh, grad=shape.kind == "train")
    ins = configs.input_specs(cfg, shape)

    if shape.kind == "train":
        from ..training.optimizer import adamw_init
        from ..training.train_loop import make_train_step
        nparams = registry.param_count(cfg)
        accum = 8 if nparams > 60e9 else (4 if nparams > 25e9 else
                                          (2 if nparams > 5e9 else 1))
        if cfg.moe_num_experts:
            accum = max(accum, 2)
        if accum_override is not None:
            accum = accum_override
        batch_meta = ins["batch"]
        bspecs = shd.data_specs(cfg, batch_meta, mesh)
        if accum > 1:
            batch_meta = {k: torch.empty(
                (accum, v.shape[0] // accum) + tuple(v.shape[1:]),
                dtype=v.dtype, device="meta") for k, v in batch_meta.items()}
            bspecs = {k: (None,) + shd.data_specs(
                cfg, {k: v[0]}, mesh)[k] for k, v in batch_meta.items()}
        batch = _sharded(batch_meta, bspecs, mesh)
        huge = nparams > 100e9
        mv = torch.bfloat16 if huge else torch.float32
        opt = adamw_init(params, m_dtype=mv, v_dtype=mv)
        _, train_step = make_train_step(cfg, accum=accum, accum_dtype=mv)

        def fn(params, opt, batch):
            with shd.activation_sharding(ba, "model"):
                return train_step(params, opt, batch)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        batch = _sharded(ins["batch"], shd.data_specs(cfg, ins["batch"],
                                                      mesh), mesh)

        def fn(params, batch):
            with shd.activation_sharding(ba, "model"):
                return api.prefill(params, batch, shape.seq_len)
        args = (params, batch)
    elif not spec_decode:
        cache = _sharded(ins["cache"], shd.cache_specs(cfg, ins["cache"],
                                                       mesh), mesh)
        tokens = _sharded(ins["tokens"], shd.token_specs(ins["tokens"],
                                                         mesh), mesh)

        def fn(params, cache, tokens):
            with shd.activation_sharding(ba, "model"):
                return api.decode_step(params, cache, tokens)
        args = (params, cache, tokens)
    else:
        from ..core.spec_decode import make_spec_step
        dcfg = configs.get_draft_config(arch)
        dapi = registry.get_model(dcfg)
        d_meta = registry.param_specs(dcfg)
        dparams = _sharded(d_meta, shd.param_specs(dcfg, d_meta, mesh,
                                                   weight_mode="tp"), mesh)
        B = shape.global_batch
        dc_meta = dapi.init_cache(B, shape.seq_len, device="meta")
        dcache = _sharded(dc_meta, shd.cache_specs(dcfg, dc_meta, mesh),
                          mesh)
        cache = _sharded(ins["cache"], shd.cache_specs(cfg, ins["cache"],
                                                       mesh), mesh)
        last_meta = torch.empty((B,), dtype=torch.int32, device="meta")
        last = _sharded(last_meta, shd.token_specs(last_meta, mesh), mesh)
        step = make_spec_step(api, dapi)

        def fn(tp, dp, tc, dc, lt):
            with shd.activation_sharding(ba, "model"):
                return step(None, tp, dp, tc, dc, lt, gamma=3)
        args = (params, dparams, cache, dcache, last)

    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "weight_mode": mode, "params": registry.param_count(cfg)}
    if shape.kind != "train":
        cache = _cache_for(api, cfg, shape)
        meta["cache_bytes_per_device"] = _local_size(
            cache, shd.cache_specs(cfg, cache, mesh), sizes)
    return fn, args, meta


def _local_size(meta_tree, spec_tree, sizes) -> int:
    """Bytes of one rank's shards of a meta tree placed by ``spec_tree``
    (every sharded dim divides)."""
    if isinstance(meta_tree, dict):
        return sum(_local_size(meta_tree[k], spec_tree[k], sizes)
                   for k in meta_tree)
    n = meta_tree.element_size()
    for dim, entry in zip(meta_tree.shape, spec_tree):
        div = 1
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            div *= sizes[a]
        n *= dim // div
    return n


def run_cell(arch: str, shape: ShapeConfig, mesh, *, spec_decode=False,
             verbose=True, cfg_override=None, accum_override=None):
    """One cell's step under ``FakeTensorMode`` on ``mesh`` (whose process
    group the caller has set up, e.g. :func:`fake_world`), counted on
    rank 0's local shards; returns the reference's result keys.  The fake
    tensors live on the mesh's device type, and ``device`` reports the
    type of a local shard the step produced."""
    t0 = time.perf_counter()
    with FakeTensorMode(), _dtensor_bookkeeping_aside(), \
            implicit_replication(), torch.device(mesh.device_type):
        fn, args, meta = build_cell(arch, shape, mesh,
                                    spec_decode=spec_decode,
                                    cfg_override=cfg_override,
                                    accum_override=accum_override)
        counter = LocalCounter(mesh)
        for t in _tensors(args):
            counter.track(t.to_local() if isinstance(t, DTensor) else t)
        arg_bytes = shd.local_bytes(args)
        with counter:
            out = fn(*args)
        first = next(_tensors(out))
        device = (first.to_local() if isinstance(first, DTensor)
                  else first).device.type
        del out
    cfg = configs.get_config(arch)
    n_chips = mesh.size()
    flops, bytes_accessed = float(counter.flops), float(counter.bytes)
    coll_bytes = float(sum(counter.coll_bytes.values()))
    collective_s = sum(b / LINK_BW.get(a, IB_BW)
                       for a, b in counter.coll_bytes.items())
    peak = counter.peak
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    nparams = (registry.active_param_count(cfg) if shape.kind != "train"
               else meta["params"])
    model_flops = (6 if shape.kind == "train" else 2) * nparams * tokens
    res = {
        **meta,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "chips": n_chips,
        "device": device,
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll_bytes,
        "collective_bytes_by_axis": dict(counter.coll_bytes),
        "collectives": dict(counter.coll_counts),
        "peak_bytes_per_device": peak,
        "argument_bytes_per_device": arg_bytes,
        "temp_bytes_per_device": peak - arg_bytes,
        "ideal_memory_s": arg_bytes / HBM_BW,
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_accessed / HBM_BW,
        "collective_s": collective_s,
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / max(flops * n_chips, 1.0),
        "fits_hbm": peak < HBM_BYTES,
    }
    terms = {"compute": res["compute_s"], "memory": res["memory_s"],
             "collective": res["collective_s"]}
    res["bottleneck"] = max(terms, key=terms.get)
    res["step_time_s"] = max(terms.values())
    res["roofline_fraction"] = (
        model_flops / n_chips / PEAK_FLOPS) / max(res["step_time_s"], 1e-30)
    res["wall_s"] = time.perf_counter() - t0
    if verbose:
        print(f"[{arch} x {shape.name} @ {res['mesh']} "
              f"mode={meta['weight_mode']} device={device}]")
        print(f"  peak/device = {peak / 1e9:.2f} GB (fits 80 GB: "
              f"{res['fits_hbm']}), arguments {arg_bytes / 1e9:.2f} GB")
        print(f"  flops/dev={flops:.3e} bytes/dev={bytes_accessed:.3e}")
        print(f"  collectives: {res['collectives']} bytes/dev="
              f"{coll_bytes:.3e} by axis {res['collective_bytes_by_axis']}")
        print(f"  data-sheet terms (s): compute={res['compute_s']:.4f} "
              f"memory={res['memory_s']:.4f} "
              f"collective={res['collective_s']:.4f} "
              f"-> bottleneck={res['bottleneck']}")
        print(f"  MODEL_FLOPS/FLOPS={res['useful_flops_ratio']:.3f} "
              f"roofline_fraction={res['roofline_fraction']:.3f} "
              f"(wall {res['wall_s']:.1f} s)")
    return res


def _cells(args):
    """(arch, shape) pairs: with --all every assigned arch's shapes, else
    --arch's shapes or its --shape."""
    if args.all:
        return [(a, s) for a in configs.ASSIGNED_ARCHS
                for s in shapes_for(configs.get_config(a))]
    if args.shape:
        return [(args.arch, configs.get_shape(args.shape))]
    return [(args.arch, s) for s in shapes_for(configs.get_config(args.arch))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--spec", action="store_true",
                    help="run the speculative (draft + verify) serve step")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: cuda when a "
                         "card is present, else cpu)")
    args = ap.parse_args(argv)
    if args.device is None:
        args.device = "cuda" if torch.cuda.is_available() else "cpu"
    if not args.all and not args.arch:
        ap.error("give --arch or --all")
    pods = [False, True] if args.both_meshes else [args.multi_pod]
    results, failures = [], []
    for multi_pod in pods:
        size = 512 if multi_pod else 256
        with fake_world(size):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=args.device)
            for arch, shape in _cells(args):
                try:
                    results.append(run_cell(arch, shape, mesh,
                                            spec_decode=args.spec))
                except Exception as e:  # noqa: BLE001 -- listed, as the reference
                    failures.append((arch, shape.name, mesh.shape,
                                     f"{type(e).__name__}: {e}"[:500]))
                    print(f"FAILED {arch} x {shape.name} @ "
                          f"{'x'.join(map(str, mesh.shape))}: "
                          f"{type(e).__name__}: {str(e)[:300]}",
                          file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results,
                       "failures": [list(f_) for f_ in failures]}, f,
                      indent=1)
    print(f"\n{len(results)} cells ran, {len(failures)} failed")
    for f_ in failures:
        print(f"  FAIL: {f_[0]} {f_[1]} @ {'x'.join(map(str, f_[2]))}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
