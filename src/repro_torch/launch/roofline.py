"""Structural roofline: per-cell flop / byte / collective terms from two
depths, extrapolated to the full one.

The reference needs this because XLA's ``cost_analysis`` counts a scanned
layer body once: it lowers each cell unrolled at two small depths (L1, L2)
and extrapolates

    total(L) = cost(L1) + (L - L1) * (cost(L2) - cost(L1)) / (L2 - L1).

The port's dry run executes every layer eagerly and counts each, so for a
uniform stack the structural total equals the full-depth count; the tool
keeps the reference's keys and method, and the per-layer marginal it
reports is the cost of one layer.  Train cells run at accum 1, as in the
reference.  Terms are H100 SXM data-sheet estimates (``dryrun``), not
measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch paper-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.roofline --all --json roofline.json
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import configs
from ..configs.base import shapes_for
from ..models import registry
from . import dryrun
from .mesh import make_production_mesh

TERMS = ("flops_per_device", "bytes_per_device",
         "collective_bytes_per_device")


def _depth_override(cfg, L):
    """Config overrides putting the model at depth L."""
    if cfg.family == "encdec":
        return dict(enc_layers=L, dec_layers=L, num_layers=2 * L)
    return dict(num_layers=L)   # a hybrid keeps attn_every


def _full_depth(cfg):
    return cfg.enc_layers if cfg.family == "encdec" else cfg.num_layers


def structural_cell(arch, shape, mesh, *, verbose=True, cfg_override=None):
    """The cell's terms at full depth, extrapolated from two depths (the
    arch's config with ``cfg_override`` applied first)."""
    cfg = configs.get_config(arch)
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    if cfg.family == "hybrid":
        L1, L2 = cfg.hybrid_attn_every, 2 * cfg.hybrid_attn_every
    else:
        L1, L2 = 2, 4
    accum = 1 if shape.kind == "train" else None

    costs = {}
    for L in (L1, L2):
        costs[L] = dryrun.run_cell(
            arch, shape, mesh, verbose=False,
            cfg_override={**(cfg_override or {}), **_depth_override(cfg, L)},
            accum_override=accum)

    Lf = _full_depth(cfg)
    out = dict(costs[L1])
    for term in TERMS:
        marginal = (costs[L2][term] - costs[L1][term]) / (L2 - L1)
        out[term] = costs[L1][term] + marginal * (Lf - L1)
        out[f"{term}_per_layer"] = marginal
    out.update({
        "arch": arch, "shape": shape.name,
        "structural": True, "L1": L1, "L2": L2, "depth": Lf,
        "compute_s": out["flops_per_device"] / dryrun.PEAK_FLOPS,
        "memory_s": out["bytes_per_device"] / dryrun.HBM_BW,
    })
    # collective time per axis, extrapolated as the bytes are
    by_axis = {}
    for a in set(costs[L1]["collective_bytes_by_axis"]) | set(
            costs[L2]["collective_bytes_by_axis"]):
        b1 = costs[L1]["collective_bytes_by_axis"].get(a, 0)
        b2 = costs[L2]["collective_bytes_by_axis"].get(a, 0)
        by_axis[a] = b1 + (b2 - b1) / (L2 - L1) * (Lf - L1)
    out["collective_bytes_by_axis"] = by_axis
    out["collective_s"] = sum(b / dryrun.LINK_BW.get(a, dryrun.IB_BW)
                              for a, b in by_axis.items())
    terms = {"compute": out["compute_s"], "memory": out["memory_s"],
             "collective": out["collective_s"]}
    out["bottleneck"] = max(terms, key=terms.get)
    out["step_time_s"] = max(terms.values())

    n_chips = mesh.size()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    nparams = (registry.param_count(cfg) if shape.kind == "train"
               else registry.active_param_count(cfg))
    model_flops = (6 if shape.kind == "train" else 2) * nparams * tokens
    out["model_flops_global"] = model_flops
    out["useful_flops_ratio"] = model_flops / max(
        out["flops_per_device"] * n_chips, 1.0)
    # ideal time: compute bound or the unavoidable HBM reads
    ideal_compute = model_flops / n_chips / dryrun.PEAK_FLOPS
    ideal_mem = out.get("argument_bytes_per_device", 0) / dryrun.HBM_BW
    out["ideal_s"] = max(ideal_compute, ideal_mem)
    out["roofline_fraction"] = out["ideal_s"] / max(out["step_time_s"],
                                                    1e-30)
    if verbose:
        print(f"[structural {arch} x {shape.name} @ "
              f"{'x'.join(str(s) for s in mesh.shape)}]")
        print(f"  data-sheet terms (s): compute={out['compute_s']:.4f} "
              f"memory={out['memory_s']:.4f} "
              f"collective={out['collective_s']:.4f} "
              f"-> {out['bottleneck']}  "
              f"(useful_flops={out['useful_flops_ratio']:.3f}, "
              f"roofline_frac={out['roofline_fraction']:.3f})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: cuda when a "
                         "card is present, else cpu)")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    if args.all:
        cells = [(a, s) for a in configs.ASSIGNED_ARCHS
                 for s in shapes_for(configs.get_config(a))]
    elif args.arch and args.shape:
        cells = [(args.arch, configs.get_shape(args.shape))]
    elif args.arch:
        cells = [(args.arch, s)
                 for s in shapes_for(configs.get_config(args.arch))]
    else:
        ap.error("give --arch or --all")

    results, failures = [], []
    with dryrun.fake_world(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device)
        for arch, shape in cells:
            try:
                results.append(structural_cell(arch, shape, mesh))
            except Exception as e:  # noqa: BLE001 -- listed, as the reference
                failures.append((arch, shape.name, str(e)[:300]))
                print(f"FAILED {arch} x {shape.name}: {type(e).__name__}: "
                      f"{str(e)[:200]}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"{len(results)} structural cells, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
