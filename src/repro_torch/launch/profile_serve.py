"""Where a served step's time goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch ARCH]

Builds the full-width bf16 pair of ``--arch`` (default paper-7b; also
granite-moe-1b-a400m, paligemma-3b, ...) as ``chip_smoke.py`` serves it,
once on the paged path (``build_real_engine``) and once on the dense-cache
path (``build_dense_engine``, same weights).  A pair without a paged path
(mamba2-780m, zamba2-1.2b) has only the dense-slot path, which
``build_real_engine`` gives it: one line.  For each it warms up on four
requests, then serves eight more under ``torch.profiler`` and prints one
JSON line: the wall time (profiler overhead included), the device's busy
time (the union of its kernel intervals) and idle share, the number of
device kernels, the device time of the port's own CUDA kernels and of
``aten::bmm`` (on the paged path only a MoE layer's expert products call
it; on the dense path the plain decode attention's einsums do too), and
the operators that took the most device and host time.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..models import registry
from ..serving.workload import tiny_requests
from .serve import build_dense_engine, build_real_engine

# the __global__ functions of kernels/csrc, matched by name in the trace
OWN_KERNELS = ("paged_attention_kernel", "paged_combine_kernel",
               "paged_window_attention_kernel", "paged_window_combine_kernel",
               "migrate_kernel", "flash_tc_kernel", "flash_simt_kernel",
               "flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_dq_kernel", "flash_bwd_dkdv_wgmma_kernel",
               "flash_bwd_dq_wgmma_kernel", "flash_bwd_sum_kernel")


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


def profile_run(engine, path, arch, vocab):
    """Warm ``engine`` up, then serve eight requests under the profiler;
    returns the JSON-ready breakdown."""
    engine.run(tiny_requests(4, prompt_len=16, output_len=16, template_len=8,
                             vocab=vocab, seed=1), max_steps=5000)
    reqs = tiny_requests(8, prompt_len=16, output_len=16, template_len=8,
                         vocab=vocab, seed=0)
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
            for name in OWN_KERNELS}
    bmm = [a for a in avg if a.key == "aten::bmm"]
    return {
        "path": path, "arch": arch, "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "steps": m.spec.get("steps", 0), "output_tokens": m.total_tokens,
        "device_kernels": len(kernels), "own_kernels_device_ms": ours,
        "bmm_device_ms": sum(a.self_device_time_total
                             for a in bmm) / 1e3,
        "top_device": top("self_device_time_total"),
        "top_host": top("self_cpu_time_total")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-7b",
                    choices=configs.list_archs())
    arch = ap.parse_args().arch
    cfg = configs.get_config(arch).replace(dtype="bfloat16")
    dcfg = configs.get_draft_config(arch).replace(dtype="bfloat16")
    if not all(registry.get_model(c).supports_paged for c in (cfg, dcfg)):
        engine = build_real_engine(cfg, dcfg, device="cuda",
                                   policy="nightjar", seed=0)
        print(json.dumps(profile_run(engine, "dense slot", arch,
                                     cfg.vocab_size)))
        return
    engine = build_real_engine(cfg, dcfg, device="cuda", policy="nightjar",
                               prefix_caching=True, chunk_tokens=16, seed=0)
    print(json.dumps(profile_run(engine, "paged", arch, cfg.vocab_size)),
          flush=True)
    params = (engine.backend.tparams, engine.backend.dparams)
    del engine
    engine = build_dense_engine(cfg, dcfg, device="cuda", policy="nightjar",
                                seed=0, params=params)
    print(json.dumps(profile_run(engine, "dense", arch, cfg.vocab_size)))


if __name__ == "__main__":
    main()
