#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``bench_port/``
and the program (``src/repro_torch``).  With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read with a device trace over a slice of the window.
The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), and last the numbers compared beside their limits, which are
also the last lines of standard error.  Without an NVIDIA card (or with
fewer than the cell asks for) the run exits non-zero and prints no result;
it never falls back to the CPU.
"""
import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# every build and kernel cache at a fixed path inside the checkout (the
# program's own nvcc build is ``build/kernels`` there)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_port" / sub)
os.environ["USE_FLAX"] = "0"

# top-level module names that may not be loaded: the JAX package of the
# repository is ``repro``, which ``repro_torch`` begins with, so names are
# compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)

    import torch
    from bench_port.lib import cellrun, spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} NVIDIA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.seed < 0:
        ap.error("--seed takes a whole number >= 0")
    out = cellrun.run_cell(cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), t_process=T_PROCESS)
    res = cellrun.result(cell, out, trace=bool(args.trace),
                         kind=torch.cuda.get_device_name(0),
                         power_limit=power_limit())
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"summary": cellrun.summary(out)}), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
