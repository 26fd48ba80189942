"""Where a served step's time goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve

Builds the full-width bf16 paper-7b pair as ``chip_smoke.py`` serves it,
warms it up on four requests, then serves eight more under
``torch.profiler`` and prints one JSON line: the wall time (profiler
overhead included), the device's busy time (the union of its kernel
intervals) and idle share, the number of device kernels, the device time
of the port's own CUDA kernels, and the operators that took the most
device and host time.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..serving.workload import tiny_requests
from .serve import build_real_engine


def _busy_us(events) -> float:
    """Union of the device kernels' [start, end) intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main():
    cfg = configs.get_config("paper-7b")
    dcfg = configs.get_draft_config("paper-7b")
    kw = dict(device="cuda", dtype="bfloat16", policy="nightjar",
              prefix_caching=True, chunk_tokens=16, seed=0)
    engine = build_real_engine(cfg, dcfg, **kw)
    engine.run(tiny_requests(4, prompt_len=16, output_len=16, template_len=8,
                             vocab=cfg.vocab_size, seed=1), max_steps=5000)
    reqs = tiny_requests(8, prompt_len=16, output_len=16, template_len=8,
                         vocab=cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = engine.run(reqs, max_steps=5000, record_timeline=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = _busy_us(events) / 1e6
    avg = prof.key_averages()

    def top(attr, n=12):
        rows = sorted(avg, key=lambda a: getattr(a, attr), reverse=True)[:n]
        return [{"op": a.key, "calls": a.count,
                 "device_ms": a.self_device_time_total / 1e3,
                 "host_ms": a.self_cpu_time_total / 1e3} for a in rows]

    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = {name: sum(e.time_range.elapsed_us() for e in kernels
                      if name in e.name) / 1e3
            for name in ("paged_attention_kernel", "migrate_kernel")}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "steps": m.spec.get("steps", 0), "output_tokens": m.total_tokens,
        "device_kernels": len(kernels), "own_kernels_device_ms": ours,
        "top_device": top("self_device_time_total"),
        "top_host": top("self_cpu_time_total")}))


if __name__ == "__main__":
    main()
