"""Where a training step's time goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_train [--arch ARCH]
      [--draft] [--batch 2] [--seq 4096] [--steps 2]

Trains the full-width bf16 config (``--draft``: the pair's draft, as
``chip_smoke.py``'s train phase does with paper-7b's) on ``SyntheticLM``
batches built before the profiled window: one warm-up step, then
``--steps`` steps under ``torch.profiler``.  Prints one JSON line: the wall
time per step, the device's busy time and idle share, the device time of
the port's own CUDA kernels by name, and the operators that took the most
device and host time.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..models.common import leaves
from ..training.data import make_batch_iter
from ..training.optimizer import adamw_init
from ..training.train_loop import make_train_step
from .profile_serve import OWN_KERNELS, _busy_us


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-7b",
                    choices=configs.list_archs())
    ap.add_argument("--draft", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    get = configs.get_draft_config if args.draft else configs.get_config
    cfg = get(args.arch).replace(dtype="bfloat16")
    api, step = make_train_step(cfg, base_lr=1e-3, warmup=10)
    params = api.init(device="cuda", seed=0)
    for x in leaves(params):
        x.requires_grad_(True)
    opt = adamw_init(params)
    it = make_batch_iter(cfg.vocab_size, args.batch, args.seq, seed=0,
                         device="cuda")
    batches = [it(i) for i in range(args.steps + 1)]
    _, params, opt = step(params, opt, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            m, params, opt = step(params, opt, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = _busy_us(events) / 1e6
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    avg = prof.key_averages()

    def top(attr, n=15):
        rows = sorted(avg, key=lambda a: getattr(a, attr), reverse=True)[:n]
        return [{"op": a.key, "calls": a.count,
                 "device_ms": a.self_device_time_total / 1e3,
                 "host_ms": a.self_cpu_time_total / 1e3} for a in rows]

    print(json.dumps({
        "model": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
        "seq": args.seq, "steps": args.steps,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step": wall * 1e3 / args.steps,
        "device_busy_ms_per_step": busy * 1e3 / args.steps,
        "device_idle_share": 1.0 - busy / wall,
        "device_kernels_per_step": len(kernels) / args.steps,
        "own_kernels_device_ms_per_step": {
            name: sum(e.time_range.elapsed_us() for e in kernels
                      if name in e.name) / 1e3 / args.steps
            for name in OWN_KERNELS},
        "loss": m["loss"].item(),
        "top_device": top("self_device_time_total"),
        "top_host": top("self_cpu_time_total")}))


if __name__ == "__main__":
    main()
