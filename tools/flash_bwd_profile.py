#!/usr/bin/env python3
"""Where the flash backward's time goes on one card.

    python3 tools/flash_bwd_profile.py

For each of ``chip_smoke.py``'s FLASH_GRAD_TIMED shapes (bf16, causal):
the backward's device time by kernel (``torch.profiler``, ten calls), each
pass's operations over that time as a share of the bf16 peak (the dK/dV
pass does four products of 2 D flops per visible (query, key) pair, the
dQ pass three), and the split count the wrapper chose.  Then the whole
backward timed (CUDA events, L2 flushed) at forced split counts of the
dK/dV pass, the chosen one first.  One JSON line each; the card's name and
power limit first.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (label, forced split counts) of the shapes timed at other splits
FORCED = {"draft training step": (1, 7), "granite training step": (1, 2),
          "paligemma training step": (8, 4, 2)}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    import repro_torch.kernels.flash_attention as fa
    if not torch.cuda.is_available():
        print("flash_bwd_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    chosen = fa.kv_splits
    for label, B, S, H, KH, D, prefix in cs.FLASH_GRAD_TIMED:
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(
            torch.bfloat16) for s in ((B, S, H, D), (B, S, KH, D),
                                      (B, S, KH, D), (B, S, H, D)))
        o, lse = fa._forward(q, k, v, True, prefix, with_lse=True)

        def bwd():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                          prefix_len=prefix)
        bwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                bwd()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            if t:
                by_kernel[e.key] = t / 10 / 1e3
        pairs = fa.attention_pairs(S, S, True, prefix)
        flops = {"flash_bwd_dkdv_wgmma_kernel": 4 * 2 * D * B * H * pairs,
                 "flash_bwd_dq_wgmma_kernel": 3 * 2 * D * B * H * pairs}
        share = {}
        for name, ms in by_kernel.items():
            for kernel, n in flops.items():
                if kernel in name:
                    share[kernel] = n / (ms / 1e3) / cs.PEAK_FLOPS["bfloat16"]
        splits = chosen(B, S, H, KH, fa._sm_count(q.device),
                        fa._build.library().flash_attention_bwd_rows())
        print(json.dumps({"shape": label, "B": B, "S": S, "H": H, "KH": KH,
                          "D": D, "prefix_len": prefix, "splits": splits,
                          "ms_by_kernel": by_kernel,
                          "peak_share_by_pass": share}), flush=True)
        for forced in FORCED.get(label, ()):
            fa.kv_splits = lambda *a, f=forced: f
            ms = cs.cuda_ms(torch, bwd, flush=flush)
            fa.kv_splits = chosen
            print(json.dumps({"shape": label, "splits": forced,
                              "chosen": forced == splits, "ms": ms}),
                  flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
