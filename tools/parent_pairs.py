#!/usr/bin/env python3
"""Time this tree against another (a parent commit) on one card, in turns.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 tools/parent_pairs.py --parent build/parent --kernels --serve 10 \
        --elastic 5

``--kernels``: the kernel rows of ``chip_smoke.py`` — paged attention at the
four serve shapes and at 512 / 1,024 / 2,048 tokens of context, flash
attention at its five timed shapes, block migration over the serve's four
page tensors (a CoW fork, contractions of 256 and 2,048 blocks) and on the
target pool alone — each timed by a worker process that imports the
kernels of one tree (built from that tree's sources), in the order parent,
change, change, parent, twice.  Both trees get the same seeded inputs.
Both time the four-tensor rows as four single-tensor calls; this tree also
as one four-tensor call, and the fork's host time of both forms.  One JSON
line per shape: each tree's times, their medians and the ratio change /
parent (null where the parent has no such call).

``--serve N``: N pairs of served runs, the tree that goes first
alternating from pair to pair.  Each run is a fresh process that calls the
tree's own ``chip_smoke.py`` phases serve, dense_serve and cswitch (the
full-width bf16 paper-7b pair, random weights from a seed).  One JSON line
with each tree's serve and dense_serve tokens/s (every run and the median),
the pairs the change won, and the median C_switch table.  Every run's
output is kept under ``build/parent_pairs/``.

``--elastic N``: N pairs of runs of ``chip_smoke.py``'s ``elastic_full``
phase (the full-width §6.4 cycle), the tree that goes first alternating.
Each run is a fresh process that imports one tree's package and this
tree's phase, on full-width bf16 weights drawn from a seed.  One JSON line
with each tree's grow / migrate / shrink / reload times and the move
repeated once the kernel is loaded (every run and the median), and the
pairs the change won.

Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

SCRIPT = Path(__file__).resolve()
ROOT = SCRIPT.parents[1]
OUT = ROOT / "build" / "parent_pairs"

def worker(tree: Path) -> None:
    """Time ``tree``'s kernels; print one JSON object of {shape: ms} (µs
    for the "host us" rows)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels.block_migration import migrate_blocks
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    # the helpers of this tree's chip_smoke (the kernels above stay the
    # other tree's: the package is already imported)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    times = {}
    for label, T, ctx in cs.PAGED_TIMED:
        _, args = cs.paged_timed_case(torch, gen, label, T, ctx)
        times[f"paged {label}"] = cs.cuda_ms(
            torch, lambda: paged_attention(*args), flush=flush, iters=50)
    for label, B, Sq, Sk, H, KH, D, causal, prefix in cs.FLASH_TIMED:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((B, Sq, H, D), (B, Sk, KH, D),
                                          (B, Sk, KH, D)))
        times[f"flash {label}"] = cs.cuda_ms(
            torch, lambda: flash_attention(q, k, v, causal=causal,
                                           prefix_len=prefix),
            flush=flush, iters=50)
    del q, k, v
    for label, m, nb1 in cs.MIG_TIMED:
        pools = cs.pair_pools(torch, gen, nb1)
        src, dst = cs.mig_plan(m, nb1)

        def four_calls():
            for p in pools:
                migrate_blocks(p, src, dst)

        def one_call():
            migrate_blocks(pools, src, dst)
        forms = [("four calls", four_calls)]
        if tree == ROOT:
            forms.append(("one call", one_call))
        for form, fn in forms:
            times[f"migrate {label}, {form}"] = cs.cuda_ms(
                torch, fn, flush=flush, iters=50)
            if m == 1:
                times[f"host us: migrate {label}, {form}"] = cs.host_us(
                    torch, fn)
        del pools
        torch.cuda.empty_cache()
    for label, m in cs.MIG_TIMED_TARGET:
        pool, = cs.pair_pools(torch, gen, cs.SERVE_NB1,
                              shapes=cs.PAIR_POOLS[:1])
        src, dst = cs.mig_plan(m, cs.SERVE_NB1)
        times[f"migrate {label}, target pool"] = cs.cuda_ms(
            torch, lambda: migrate_blocks(pool, src, dst), flush=flush,
            iters=50)
        del pool
    print(json.dumps(times))


def run_worker(tree: Path) -> dict:
    out = subprocess.run([sys.executable, str(SCRIPT), "--worker", str(tree)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"worker for {tree} failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def kernels(parent: Path) -> None:
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent") * 2:
        runs[name].append(run_worker(parent if name == "parent" else ROOT))
    for shape in runs["change"][0]:
        p = [r[shape] for r in runs["parent"] if shape in r]
        c = [r[shape] for r in runs["change"]]
        pm = statistics.median(p) if p else None
        print(json.dumps({"phase": "kernel_pairs", "shape": shape,
                          "parent": p, "change": c, "parent_median": pm,
                          "change_median": statistics.median(c),
                          "ratio": statistics.median(c) / pm if p else None}),
              flush=True)


def serve_worker(tree: Path) -> None:
    """Run ``tree``'s serving phases once; they print their JSON lines."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs   # puts tree/src first on the path
    import torch
    _, params = cs.phase_serve(torch)
    cs.phase_dense_serve(torch, params)
    cs.phase_cswitch(torch, params[1])


def serve(parent: Path, pairs: int) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    res = {"parent": [], "change": []}
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for name in order:
            tree = parent if name == "parent" else ROOT
            out = subprocess.run([sys.executable, str(SCRIPT), "--serve-worker",
                                  str(tree)], cwd=tree, capture_output=True,
                                 text=True, timeout=900)
            (OUT / f"{name}_{i}.log").write_text(out.stdout + out.stderr)
            if out.returncode != 0:
                raise RuntimeError(f"serving phases of {name} failed in pair "
                                   f"{i}: see {OUT}")
            by = {ln["phase"]: ln for ln in map(json.loads, (
                x for x in out.stdout.splitlines() if x.startswith("{")))}
            res[name].append({"serve": by["serve"]["tokens_per_s"],
                              "dense_serve": by["dense_serve"]["tokens_per_s"],
                              "cswitch": by["cswitch"]["ms"]})
    summary = {"phase": "serve_pairs", "pairs": pairs}
    for path in ("serve", "dense_serve"):
        summary[f"{path}_change_wins"] = sum(
            c[path] > p[path] for p, c in zip(res["parent"], res["change"]))
    for name, rs in res.items():
        summary[name] = {
            path: {"runs": [r[path] for r in rs],
                   "median": statistics.median(r[path] for r in rs)}
            for path in ("serve", "dense_serve")}
        summary[name]["cswitch_median_ms"] = {
            cell: statistics.median(r["cswitch"][cell] for r in rs)
            for cell in rs[0]["cswitch"]}
    print(json.dumps(summary), flush=True)


def elastic_worker(tree: Path) -> None:
    """Run this tree's elastic_full phase on ``tree``'s package."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch import configs
    from repro_torch.models import registry
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    params = tuple(registry.get_model(c.replace(dtype="bfloat16")).init(
        device="cuda", seed=seed) for c, seed in (
            (configs.get_config("paper-7b"), 1),
            (configs.get_draft_config("paper-7b"), 2)))
    cs.phase_elastic_full(torch, params)


ELASTIC_STEPS = ("grow", "migrate", "shrink", "reload", "migrate_again")


def elastic(parent: Path, pairs: int) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    res = {"parent": [], "change": []}
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for name in order:
            tree = parent if name == "parent" else ROOT
            out = subprocess.run([sys.executable, str(SCRIPT),
                                  "--elastic-worker", str(tree)], cwd=ROOT,
                                 capture_output=True, text=True, timeout=900)
            (OUT / f"elastic_{name}_{i}.log").write_text(out.stdout
                                                         + out.stderr)
            if out.returncode != 0:
                raise RuntimeError(f"elastic_full of {name} failed in pair "
                                   f"{i}: see {OUT}")
            line = [json.loads(x) for x in out.stdout.splitlines()
                    if x.startswith('{"phase": "elastic_full"')][-1]
            res[name].append(line["ms"])
    summary = {"phase": "elastic_pairs", "pairs": pairs, "unit": "ms"}
    for step in ELASTIC_STEPS:
        summary[f"{step}_change_wins"] = sum(
            c[step] < p[step] for p, c in zip(res["parent"], res["change"]))
    for name, rs in res.items():
        summary[name] = {step: {"runs": [r[step] for r in rs],
                                "median": statistics.median(r[step]
                                                            for r in rs)}
                         for step in ELASTIC_STEPS}
    print(json.dumps(summary), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--serve", type=int, default=0, metavar="PAIRS")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--elastic", type=int, default=0, metavar="PAIRS")
    ap.add_argument("--serve-worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--elastic-worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker.resolve())
        return 0
    if args.serve_worker:
        serve_worker(args.serve_worker.resolve())
        return 0
    if args.elastic_worker:
        elastic_worker(args.elastic_worker.resolve())
        return 0
    import torch
    if not torch.cuda.is_available():
        print("parent_pairs: no CUDA device", file=sys.stderr)
        return 2
    if args.parent is None or not (args.parent / "chip_smoke.py").exists():
        print("parent_pairs: --parent must name an unpacked tree",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"phase": "card", "nvidia_smi": smi,
                      "parent": str(args.parent)}), flush=True)
    parent = args.parent.resolve()
    if args.kernels:
        kernels(parent)
    if args.serve:
        serve(parent, args.serve)
    if args.elastic:
        elastic(parent, args.elastic)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
