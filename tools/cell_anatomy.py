#!/usr/bin/env python3
"""One traced run of a ``bench_port`` cell, then what it held: the steps of
each kind in the window and in the traced slice, and the kinds of rows the
requests that ``correct`` compares went through.

    python3 tools/cell_anatomy.py <workload> <seed> [window]

The run is the harness's own ``cellrun.run_cell`` with ``trace=True``
(needs a CUDA card).  A step is ``decode g<γ>`` (a pure-decode step at
speculation length γ) or ``mixed`` (a prefill chunk beside decode rows).
The compared requests are the harness's own sample.  Their rows: each
prefill chunk, as lying inside the first ``window`` positions, across the
window's edge or past it, and each step that served them tokens outside a
chunk, as a decode row (γ = 0) or a verify row (``verify g<γ>``).
Prints two JSON lines.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
T0 = time.time()
from bench_port.lib import cellrun, check, spec  # noqa: E402


def kind(step):
    if step.pure_decode:
        return f"decode g{step.gamma}"
    return "mixed" if step.kind == "decode" else step.kind


def count(steps):
    out = {}
    for s in steps:
        out[kind(s)] = out.get(kind(s), 0) + 1
    return out


def rows_of(steps, ids, window):
    rows = {}
    for s in steps:
        chunked = {c[0] for c in s.chunks}
        for rid, start, n in s.chunks:
            if rid in ids:
                k = ("chunk across the edge" if start < window < start + n
                     else "chunk past the edge" if start >= window
                     else "chunk inside the window")
                rows[k] = rows.get(k, 0) + 1
        for rid, _, _ in s.served:
            if rid in ids and rid not in chunked:
                k = f"verify g{s.gamma}" if s.gamma else "decode"
                rows[k] = rows.get(k, 0) + 1
    return rows


def main(argv):
    name, seed = argv[0], int(argv[1])
    window = int(argv[2]) if len(argv) > 2 else 1024
    sampled = {}
    sample = check.sample

    def keep(*a, **k):
        sampled["ids"] = sample(*a, **k)
        return sampled["ids"]

    check.sample = keep
    out = cellrun.run_cell(spec.find_cell(name), seed=seed, seconds=51.0,
                           trace=True, t_process=T0)
    run = out.run
    win = [s for s in run.steps
           if run.window_open <= s.t_start < run.window_close]
    traced = set(run.trace.kernels_by_step) if run.trace else set()
    print(json.dumps({
        "window_steps": count(win),
        "slice_steps": count(s for s in run.steps if s.index in traced),
        "slice_wall_s": run.trace.wall_s if run.trace else None}))
    ids = sampled.get("ids", [])
    print(json.dumps({
        "compared": ids,
        "prompt_lens": [run.requests[i].prompt_len for i in ids],
        "rows": rows_of(run.steps, set(ids), window),
        "correct": out.correct, "gap": out.gap}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
