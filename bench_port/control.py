#!/usr/bin/env python3
"""Readings that set a cell's limit, on the card: the program's and the
control's, seed by seed, in one process.

    python3 bench_port/control.py --workload <name> --seeds 11,12,13 \
        [--seconds <s>]

For each seed, one run of the cell as ``run.py --trace 0`` makes it (the
window at the cell's load), then the control in the program's place on
the same sample of served requests: the plain reference computed in
float8 e4m3 (the target's architecture module's ``logits``,
``precision="fp8"``), the precision below the configuration's bfloat16,
serving at each position the token it puts first, judged by the run's own
decision (``check.decide``).  One JSON line
per seed: the program's readings of the gaps and its ``correct``, the
control's and its ``correct`` (false where the comparison holds), and the
tokens compared.  The benchmark's own runs never run the control.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

T_PROCESS = time.time()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)

    import torch
    from bench_port.lib import cellrun, spec

    if not torch.cuda.is_available():
        print("the control runs on an NVIDIA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    seconds = args.seconds or cell.run_seconds
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        out = cellrun.run_cell(cell, seed=seed, seconds=seconds, trace=False,
                               t_process=t, control=True)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "program": out.readings,
            "correct": out.correct, "control": out.control,
            "control_correct": out.control_correct,
            "number": out.number, "limit": out.limit,
            "compared_requests": out.compared_requests,
            "compared_tokens": out.compared_tokens,
            "output_tok_s": spec.load_reader("output_tok_s")(out.run),
            "seconds": time.time() - t}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
