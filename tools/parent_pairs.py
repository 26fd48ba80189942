#!/usr/bin/env python3
"""Time this tree against another (a parent commit) on one card, in turns.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 tools/parent_pairs.py --parent build/parent --kernels --serve 10

``--kernels``: the kernel rows of ``chip_smoke.py`` — paged attention at the
four serve shapes and at 512 / 1,024 / 2,048 tokens of context, flash
attention at its five timed shapes — each timed by a worker process that
imports the kernels of one tree (built from that tree's sources), in the
order parent, change, change, parent, twice.  Both trees get the same
seeded inputs.  One JSON line per shape: each tree's times, their medians
and the ratio change / parent.

``--serve N``: N pairs of served runs, the tree that goes first
alternating from pair to pair.  Each run is a fresh process that calls the
tree's own ``chip_smoke.py`` phases serve, dense_serve and cswitch (the
full-width bf16 paper-7b pair, random weights from a seed).  One JSON line
with each tree's serve and dense_serve tokens/s (every run and the median),
the pairs the change won, and the median C_switch table.  Every run's
output is kept under ``build/parent_pairs/``.

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
    """Time ``tree``'s kernels; print one JSON list of {shape: ms}."""
    sys.path.insert(0, str(tree / "src"))
    import torch
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
    for label, B, S, H, KH, D in cs.FLASH_TIMED:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((B, S, H, D), (B, S, KH, D),
                                          (B, S, KH, D)))
        times[f"flash {label}"] = cs.cuda_ms(
            torch, lambda: flash_attention(q, k, v, causal=True), flush=flush,
            iters=50)
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
        p = [r[shape] for r in runs["parent"]]
        c = [r[shape] for r in runs["change"]]
        print(json.dumps({"phase": "kernel_pairs", "shape": shape,
                          "parent_ms": p, "change_ms": c,
                          "parent_median_ms": statistics.median(p),
                          "change_median_ms": statistics.median(c),
                          "ratio": statistics.median(c)
                          / statistics.median(p)}), flush=True)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--serve", type=int, default=0, metavar="PAIRS")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--serve-worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker.resolve())
        return 0
    if args.serve_worker:
        serve_worker(args.serve_worker.resolve())
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
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
