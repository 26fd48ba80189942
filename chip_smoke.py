#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
  1. build   — compile src/repro_torch/kernels/csrc/*.cu with nvcc (sm_90a)
               and print ptxas' register / shared-memory report;
  2. kernels — each CUDA kernel against its plain PyTorch version at the
               reference sweep shapes and the paper-7b main-path shapes,
               then CUDA-event timings beside the plain version, a library
               call where one exists, and the device-memory bound;
  3. serve   — the main path: the full-width, full-depth bf16 paper-7b pair
               served through ``build_real_engine`` (Nightjar planner,
               prefix caching, paged speculative decoding); counts every
               kernel launch of that run;
  4. elastic_full — the elastic pool's §6.3-6.4 cycle on the serve's pool
               (1,024 blocks, draft_blocks 256) at full width: offload and
               grow, a contraction that moves 256 blocks of all four page
               tensors in one launch (bit-exact against the sources),
               shrink, reload and one draft decode step; times each step;
  5. lossless — fp32 (TF32 off) at full width and cut depth: the greedy
               stream under Nightjar equals the AR stream, with the paper's
               draft and with the target as its own draft (which accepts);
  6. elastic — the elastic memory manager's whole cycle on a 24-block
               pool (offload, grow, contract, shrink, reload; a scripted
               planner), the streams equal an unmanaged run's, and spec
               steps after the reload replay their recaptured graphs;
  7. dense_serve — the dense-cache path: the same pair and requests as
               phase 3 through ``DenseSlotBackend`` (monolithic prefill one
               prompt at a time through the flash-attention kernel, dense
               spec / AR steps, draft catch-ups by re-prefill);
  8. dense_lossless — fp32 at full width and cut depth: the dense Nightjar,
               dense AR, paged and dense target-as-draft streams are equal;
  9. cswitch — the paper's Table 3 on the card: the full-width bf16 draft's
               dense prefill timed on the (delta, batch) grid through
               ``CSwitchTable.profile``;
 10. moe_serve — the MoE decoder's main path: the full-width, full-depth
               bf16 granite-moe-1b-a400m pair served as in phase 3, then the
               same requests again with the dropped (token, expert) slots
               counted per call kind (decode, verify, prefill chunk);
 11. vlm_serve — the paligemma-3b pair (head_dim 256, MQA) served as in
               phase 3, text only as the reference's real tier serves it;
 12. vlm_prefix — paligemma's image-prefix path: ``prefill`` of 256 image
               rows + 16 text tokens (the flash kernel at D = 256 with
               ``prefix_len`` 256), 8 ``decode_step``s, held against
               ``forward`` at full width in bf16 and at 4 layers in fp32;
 13. moe_lossless — granite at full width and 4 layers, fp32, capacity
               factor 8.0: AR, fixed-2, Nightjar and target-as-draft
               greedy streams are equal with step graphs on, and the same
               runs on the eager path drop no slot (counted);
 14. ssm_serve — the O(1)-state main path: the full-width, full-depth bf16
               mamba2-780m pair (48 + 6 layers) served through
               ``build_real_engine`` → ``DenseSlotBackend`` (no attention:
               no kernel launches), then the draft's prefill at B = 8,
               512 tokens (a catch-up's work, two SSD chunks) and 300
               tokens (a padded tail chunk);
 15. hybrid_serve — the zamba2-1.2b pair (38 + 4 layers) the same way: the
               shared attention block's flash call at six points per
               target prompt;
 16. encdec_prefix — whisper-medium at model level: ``prefill`` of 1,500
               frame embeddings + 16 tokens (24 encoder, 24 causal and 24
               cross-attention flash calls), 8 ``decode_step``s, held
               against ``forward`` in bf16 at full depth and in fp32 at
               4 + 4 layers;
 16b. window_serve — the full-width, full-depth bf16 mellum2-12b-a2.5b
               pair through ``build_real_engine``, chunk 512: eight prompts
               of 1,100-1,800 tokens, past the 1,024-position window; the
               21 sliding layers' windowed launches counted apart
               (``paged_window_attention`` in the kernels line);
 16c. decode_graphs — the pure-decode and spec steps' captured graphs
               (``serving/step_graphs.py``) against the eager model call,
               full-width bf16 paper-7b, granite and Mellum2 on their
               cells' pools (graphs 512 / 512 / 2,048 blocks wide): the
               up-front capture of every bucket and gamma, timed; then
               batch buckets 1 / 4 / 16 / 64, contexts in two table widths
               padded into the served width and gamma 0-3: the same
               tokens, the same launch counts, and each key's eager and
               replayed step times (CUDA events, in turns); what padding
               the tables to the served width and the batch to the next
               captured bucket costs a replay;
 17. ssm_lossless — fp32 cut depth: mamba2 AR == fixed-2 == Nightjar ==
               target-as-draft, zamba2 AR == fixed-2 == Nightjar, through
               the engine (SSM checkpoint rollback);
 18. disagg_serve — disaggregated serving on phase 3's weights: the
               serve's eight requests prefill on one replica, their KV
               blocks travel through host memory (``export_handoff`` ->
               ``import_handoff``) and a second replica decodes them on
               the paged-attention kernel; then one 192-token prompt (24
               blocks); prints each handoff's export / import ms and
               bytes, the bandwidth beside the simulator's price, the
               decode replica's tokens/s, and writes the shared trace
               (span-balanced) to build/traces/ (runs after phase 7);
 19. disagg_lossless — fp32 cut depth: under AR and Nightjar, migrated
               streams equal colocated ones (runs after phase 8);
 20. flash_grad — the flash backward kernel (csrc/flash_attention_bwd.cu)
               against its plain version and the log-sum-exp forward
               against the plain log-sum-exp, fp32 (TF32 off) and bf16, at
               head_dim 32, 64, 128 and 256 (FLASH_CASES, FLASH_256_CASES,
               the two training shapes, a prefix and a non-causal
               Sq != Sk), two launches equal to the bit; timed at five
               shapes (the draft's, granite's and paligemma's training
               steps, deepseek-7b's heads, gemma-7b's --reduced step)
               beside its bound, the plain version and SDPA's backward;
 21. train_fp32 — the paper-7b draft at full width and 2 layers, fp32: the
               train step's loss and gradients with attention through the
               kernels equal those through the plain version (1e-5, 1e-4
               of each leaf's norm), and wq / wk / wv get a gradient;
 22. train   — the training main path: the full-width, full-depth bf16
               draft through ``train()``, 2 x 4,096 tokens of SyntheticLM,
               5 steps, a checkpoint at step 5 under build/, resumed to
               step 10; per-step loss, grad norm, device and host ms,
               tokens/s, model-flop share, peak memory, 24 flash forward
               and backward launches per step, the restored state bit for
               bit;
 23. train_cli — ``python -m repro_torch.launch.train`` on
               granite-moe-1b-a400m at full width, 3 steps of 2 x 1,024, in
               a subprocess: exit 0, finite losses, its launches.
 24. train_vlm — paligemma-3b's language model trained at full width and
               depth in bf16 through ``train()``, 3 steps of 2 x (256
               seeded image rows + 768 text tokens): the backward at
               head_dim 256 with MQA and the image prefix, 18 forward and
               18 backward launches a step, step ms, peak memory; then fp32
               at 4 layers: every gradient leaf within 1e-4 of the plain
               path's;
 25. train_cli_reduced — the reference's documented command,
               ``python -m repro_torch.launch.train --arch gemma-7b
               --reduced`` (head_dim 32, 50 steps of 8 x 128), in a
               subprocess: exit 0, finite losses, its launches;
 26. sharded — the sharded path on a one-rank NCCL group and a (1, 1)
               ("data", "model") mesh, DTensor weights at full width in
               bf16: the draft's loss and gradients at 2 x 4,096 (fsdp)
               and the target's dense prefill + 4 decode steps (tp_seq),
               each within 2e-2 of the unsharded path (each gradient
               leaf's relative error and the worst leaf printed); the
               flash forward and backward launches through ``local_map``
               and each path's step ms (DTensor's host overhead);
 27. remat   — the full-width draft's train step at remat none / full /
               dots: peak memory and median step ms over 5 steps, the
               losses equal (bf16 full depth 2e-2, fp32 4 layers 1e-6);
 28. dryrun  — ``launch/dryrun.py`` in a subprocess on a fake 256-rank
               process group and the (32, 8) H100 mesh: deepseek-7b and
               paligemma-3b train_4k, qwen2-72b prefill_32k and decode_32k,
               grok-1-314b decode_32k and paper-7b decode_32k
               speculative; per-device flops, bytes, collectives, peak
               memory (data-sheet estimates, fake tensors) and wall
               seconds; then the local counting held on this PyTorch
               (8 x an (8, 1) fsdp train step's per-device flops equal
               the unsharded step's within 1 %).
 29. pressure_serve — the real tier under memory pressure on phase 3's
               weights (runs after phase 18): a host KV tier, prefix
               caching and chunks of 16 on a pool cut to 12 blocks, the
               serve's eight requests and then their prompts again; every
               request finishes; prints the preemptions, the blocks
               spilled and restored with their ms, GB/s and checksum
               time, tokens/s, peak memory and the launches;
 30. chunked_lossless — fp32 cut depth (after phase 19): chunk budgets of
               4, 7 and 16 tokens give the streams of monolithic prefill,
               with steps that mix chunks and decode rows;
 31. preempt_lossless — fp32 cut depth: 10 blocks of 4 tokens under four
               requests force preempt-and-recompute; all finish with the
               streams of a roomy pool;
 32. host_tier_lossless — fp32 cut depth: prefix caching with a host KV
               tier on 16 blocks, four prompts and the same four again:
               blocks spill and restore (each restore's checksum checked
               in ``apply_host_transfers``), streams equal a run without
               the tier.

Phase 2 also holds ``flash_attention`` against its plain version (fp32 with
TF32 off on the CUDA-core kernel, and bf16 on the tensor-core kernel) and
times it beside its bound, the plain version and
``scaled_dot_product_attention``; the paged checks include 2,048-token
contexts that take several splits and the combine pass, and each paged
timing row says how many splits it used.  The new pairs' heads
(paligemma's D = 256 with G = 8, granite's D = 64 with G = 2) are checked
at their served shapes and at 512 / 2,048 tokens, and flash at D = 256
with the image prefix; their timing rows stand beside the paper-7b ones.
The windowed paged kernel (Mellum2's sliding layers: 32/4 heads of 128,
window 1,024) is held to the plain version with the same window at decode
(B = 16 and 64, contexts 3,072 and 8,192, split), at the window's edge, at
verify rows and at 512-query chunks (one across the edge, unsplit), and
timed beside the window-0 kernel on the same inputs, its bound counting
only the positions inside each query's window.
``migrate_blocks`` is held bitwise against its plain version on single
pools and on the serve's four page tensors (ids inline, at the inline cap
and past it, 2,048 pairs, float32 beside bfloat16) and timed as one
four-tensor call (device time, host time, the plain version,
``index_select`` + ``index_copy_``, and one contiguous ``copy_`` of the
same bytes as the card's practical rate); the ``inline_cap`` line times
launches with the ids inline against uploaded.

Every line printed is a JSON object; the last is the run's verdict.  Needs a
CUDA device and the repository's ``src/``; it refuses to run otherwise.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
TARGET_ATTN = dict(H=28, KH=4, D=128)          # paper-7b target
DRAFT_ATTN = dict(H=14, KH=2, D=64)            # paper-7b draft
PALI_ATTN = dict(H=8, KH=1, D=256)             # paligemma-3b target (MQA)
GRANITE_ATTN = dict(H=16, KH=8, D=64)          # granite-moe-1b target
MELLUM_ATTN = dict(H=32, KH=4, D=128)          # mellum2-12b-a2.5b target
MELLUM_WINDOW = 1024                           # its sliding layers' window
GRANITE, PALIGEMMA = "granite-moe-1b-a400m", "paligemma-3b"
MAMBA2, ZAMBA2, WHISPER = "mamba2-780m", "zamba2-1.2b", "whisper-medium"
REF_SWEEP = [(2, 4, 4, 64, 16, 3), (3, 8, 2, 64, 16, 4), (2, 8, 1, 128, 8, 5)]
# flash attention checks: (B, Sq, Sk, H, KH, D, causal, prefix_len)
FLASH_CASES = [
    (2, 256, 256, 4, 4, 64, True, 0), (2, 256, 256, 4, 4, 64, False, 0),
    (1, 128, 128, 8, 2, 128, True, 0), (2, 384, 384, 4, 1, 64, False, 0),
    (1, 16, 16, 28, 4, 128, True, 0), (2, 37, 37, 28, 4, 128, True, 5),
    (1, 200, 200, 28, 4, 128, True, 130), (2, 384, 384, 28, 4, 128, True, 0),
    (2, 37, 37, 14, 2, 64, True, 0), (1, 200, 200, 14, 2, 64, True, 0),
    (2, 37, 200, 14, 2, 64, False, 0), (1, 384, 384, 14, 2, 64, True, 3),
    (1, 200, 200, 4, 4, 128, True, 0), (2, 37, 37, 4, 4, 64, False, 0),
    (1, 37, 37, 4, 2, 32, True, 0), (1, 200, 37, 28, 4, 128, False, 0),
    (2, 130, 130, 4, 4, 64, True, 130), (1, 200, 200, 4, 4, 32, True, 0)]
# head_dim 256, held at ATOL (2e-2 in bf16): paligemma's image-prefix
# prefill (256 image rows + 16 text tokens, MQA), ragged corners, gemma-7b's
# MHA heads
FLASH_256_CASES = [
    (2, 272, 272, 8, 1, 256, True, 256), (1, 37, 37, 8, 1, 256, True, 0),
    (1, 200, 200, 8, 1, 256, True, 130), (2, 37, 200, 8, 1, 256, False, 0),
    (1, 130, 130, 16, 16, 256, True, 0)]
# the O(1)-state families' flash calls, held at ATOL: whisper-medium's
# encoder and cross-attention (1,500 frames, MHA, non-causal, Sq != Sk) and
# zamba2-1.2b's shared block (32/32 heads)
FLASH_O1_CASES = [
    (1, 1500, 1500, 16, 16, 64, False, 0),
    (2, 16, 1500, 16, 16, 64, False, 0), (1, 16, 16, 32, 32, 64, True, 0)]
# flash attention timings (bf16): label, B, Sq, Sk, H, KH, D, causal,
# prefix_len
FLASH_TIMED = [
    ("dense serve prefill", 1, 16, 16, 28, 4, 128, True, 0),
    ("C_switch delta=128 B=2", 2, 128, 128, 14, 2, 64, True, 0),
    ("C_switch delta=256 B=8", 8, 256, 256, 14, 2, 64, True, 0),
    ("C_switch delta=512 B=32", 32, 512, 512, 14, 2, 64, True, 0),
    ("long target prefill", 1, 2048, 2048, 28, 4, 128, True, 0),
    ("paligemma image-prefix prefill", 2, 272, 272, 8, 1, 256, True, 256),
    ("granite dense prefill", 1, 16, 16, 16, 8, 64, True, 0),
    ("whisper encoder", 1, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper cross-attention", 1, 16, 1500, 16, 16, 64, False, 0),
    ("zamba2 shared-block prefill", 1, 16, 16, 32, 32, 64, True, 0)]
# paged attention timings (bf16, B = 4, 8-position blocks): label, T,
# context
PAGED_TIMED = [("target decode B=4", 1, 32),
               ("target verify gamma=3 B=4", 4, 32),
               ("target prefill T=16 B=4", 16, 16),
               ("draft decode B=4", 1, 32),
               ("target decode B=4 ctx=512", 1, 512),
               ("target decode B=4 ctx=1024", 1, 1024),
               ("target decode B=4 ctx=2048", 1, 2048),
               ("paligemma decode B=4", 1, 32),
               ("paligemma verify gamma=3 B=4", 4, 32),
               ("paligemma prefill T=16 B=4", 16, 16),
               ("paligemma decode B=4 ctx=512", 1, 512),
               ("paligemma decode B=4 ctx=2048", 1, 2048),
               ("granite decode B=4", 1, 32),
               ("granite verify gamma=3 B=4", 4, 32),
               ("granite decode B=4 ctx=2048", 1, 2048)]
# windowed paged attention at Mellum2's sliding layers (bf16, 8-position
# blocks, window 1,024): label, B, T, context before the call
WINDOW_TIMED = [("mellum2 window decode B=16 ctx=3072", 16, 1, 3072),
                ("mellum2 window decode B=64 ctx=3072", 64, 1, 3072),
                ("mellum2 window decode B=16 ctx=8192", 16, 1, 8192),
                ("mellum2 window decode B=64 ctx=8192", 64, 1, 8192),
                ("mellum2 window verify gamma=3 B=16 ctx=3072", 16, 4, 3072),
                ("mellum2 window chunk T=512 ctx=3072", 1, 512, 3072)]
# the heads of each PAGED_TIMED row, by the first word of its label
TIMED_ATTN = {"target": TARGET_ATTN, "draft": DRAFT_ATTN,
              "paligemma": PALI_ATTN, "granite": GRANITE_ATTN}
# the serve's paged pools, (L, bs, KH, hd) of the target's and the draft's
# K and V, over one NB+1 (1,024 blocks and the trash block)
PAIR_POOLS = [(28, 8, 4, 128)] * 2 + [(24, 8, 2, 64)] * 2
SERVE_NB1 = 1025
# migrate_blocks timings over the four pools (bf16): label, M, NB+1
MIG_TIMED = [("CoW fork, four tensors", 1, SERVE_NB1),
             ("contraction, four tensors (the serve's draft_blocks)", 256,
              SERVE_NB1),
             ("contraction, four tensors, 4,097-block pools", 2048, 4097)]
# the earlier single-tensor rows, target pool only: label, M
MIG_TIMED_TARGET = [("CoW fork, 1 block", 1), ("contraction, 64 blocks", 64)]
CARD = {}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **CARD, **fields}), flush=True)


def card_info(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD.update(device=torch.cuda.get_device_name(0),
                power_limit=smi.split(",")[-1].strip())
    emit("card", nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path, log = _build.build()
    # one line per kernel instance: its (mangled) name, registers, spills
    # and shared memory, as ptxas -v reports them
    ptxas, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("spill" in ln or "registers" in ln):
            ptxas.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    emit("build", library=str(path.relative_to(ROOT)),
         seconds=round(time.perf_counter() - t0, 3),
         rebuilt=bool(log), ptxas=ptxas)
    _build.library()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------


def attn_case(torch, gen, *, B, T, H, KH, D, bs, lengths, dtype):
    """Inputs of one paged-attention call on the card: ragged ``lengths``,
    each sequence's pages drawn from a shuffled pool, tables padded with
    the trash id, whose page holds large finite garbage."""
    maxb = max(-(-n // bs) for n in lengths)
    width = 1 << max(maxb - 1, 0).bit_length()
    nb = sum(-(-n // bs) for n in lengths) + 3
    dev = "cuda"
    q = torch.randn((B, T, H, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((nb + 1, bs, KH, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((nb + 1, bs, KH, D), generator=gen, device=dev).to(dtype)
    kp[nb] = 1e4
    vp[nb] = -1e4
    perm = torch.randperm(nb, generator=gen, device=dev).tolist()
    tables = torch.full((B, width), nb, dtype=torch.int32)
    for b, n in enumerate(lengths):
        need = -(-n // bs)
        tables[b, :need] = torch.tensor(perm[:need], dtype=torch.int32)
        perm = perm[need:]
    return (q, kp, vp, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def paged_timed_case(torch, gen, label, T, ctx):
    """(lengths, inputs) of one PAGED_TIMED row: four sequences of ``ctx``
    positions of context, with the draft's heads on a draft row."""
    attn = TIMED_ATTN[label.split()[0]]
    lens = [ctx + T - 2 * i for i in range(4)]
    return lens, attn_case(torch, gen, B=4, T=T, bs=8, lengths=lens,
                           dtype=torch.bfloat16, **attn)


def attn_bound(q, k_pages, lengths, dtype_name, window=0):
    """Least time the card needs for one call: the bytes it must move
    (queries and outputs once, the K/V pages this call's lengths reach,
    the tables) over HBM bandwidth, against the flops over the type's
    peak.  With a ``window`` only the pages from a row's earliest window
    start on, and each query's positions inside its window, count."""
    B, T, H, D = q.shape
    _, bs, KH, _ = k_pages.shape
    es = q.element_size()
    lens = lengths.tolist()
    first = [max(n - T - window + 1, 0) // bs if window else 0
             for n in lens]
    pages = sum(-(-n // bs) - f for n, f in zip(lens, first))
    nbytes = 2 * q.numel() * es + 2 * pages * bs * KH * D * es \
        + 4 * B * (pages + 1)
    flops = sum(4 * H * D * min(max(n - T + t + 1, 0), window or n)
                for n in lens for t in range(T))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(torch, fn, *, iters=30, flush=None):
    """Mean device time of ``fn`` by CUDA events, one event pair per call.
    ``flush`` (a buffer larger than L2) is rewritten before each call, as
    the serving path leaves the cache cold for every kernel, and a ~1 ms
    device spin ahead of the start event lets the host enqueue the whole
    call first, so the events bracket device work only (the host's cost
    per call is a separate matter: the serving step is launch-bound)."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def phase_kernels(torch):
    from repro_torch.kernels.paged_attention import (TILE, paged_attention,
                                                     split_plan)
    from repro_torch.kernels.ref import paged_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    # --- paged attention: correctness --------------------------------
    # (splits the call must launch with, or None, and the case)
    cases = []
    for B, H, KH, D, bs, maxb in REF_SWEEP:
        for T in (1, 4, 8):
            lens = [T + (7 * i) % (maxb * bs - T + 1) for i in range(B)]
            cases.append((None, dict(B=B, T=T, H=H, KH=KH, D=D, bs=bs,
                                     lengths=lens)))
    # the serves' shapes: one split, so one launch
    for attn in (TARGET_ATTN, DRAFT_ATTN, PALI_ATTN, GRANITE_ATTN):
        for B in (1, 4):
            for T in (1, 2, 3, 4, 16):
                lens = [T + 5 + 9 * i for i in range(B)]
                cases.append((1, dict(B=B, T=T, bs=8, lengths=lens,
                                      **attn)))
    cases.append((None, dict(B=1, T=256, bs=8, lengths=[300],
                             **TARGET_ATTN)))
    cases.append((None, dict(B=2, T=64, bs=4, lengths=[64, 100],
                             **DRAFT_ATTN)))
    for attn in (PALI_ATTN, GRANITE_ATTN):     # 512 tokens: split-KV
        cases.append((None, dict(B=4, T=1, bs=8, lengths=[512, 500, 300, 17],
                                 **attn)))
    # split-KV: 2,048 tokens of context with ragged lengths in one batch,
    # one sequence shorter than a split and one ending on a split boundary
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for attn in (TARGET_ATTN, DRAFT_ATTN, PALI_ATTN, GRANITE_ATTN):
        for T in (1, 4, 16):
            rows = T * attn["H"] // attn["KH"]
            n, per = split_plan(4, attn["KH"], rows, 2048, sms)
            assert n > 1, (attn, T, n)
            split = per * TILE
            cases.append((n, dict(
                B=4, T=T, bs=8, lengths=[2048, split - 5,
                                         split * min(n - 1, 3), 1500],
                **attn)))
    attn_err = {}
    for dtype_name in ("float32", "bfloat16"):
        worst = 0.0
        for splits, kw in cases:
            args = attn_case(torch, gen, dtype=getattr(torch, dtype_name),
                             **kw)
            got = paged_attention(*args)
            assert splits in (None, paged_attention.last_splits), \
                (kw, splits, paged_attention.last_splits)
            want = paged_attention_ref(*args)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), kw
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype_name], (dtype_name, kw, err)
            worst = max(worst, err)
        attn_err[dtype_name] = worst
    emit("check", kernel="paged_attention", cases=len(cases),
         max_abs_err=attn_err, atol=ATOL)

    # --- times at the main-path shapes (bf16) ---------------------------
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    attn_rows = []
    for label, T, ctx in PAGED_TIMED:
        lens, args = paged_timed_case(torch, gen, label, T, ctx)
        err = (paged_attention(*args).float()
               - paged_attention_ref(*args).float()).abs().max().item()
        assert err <= ATOL["bfloat16"], (label, err)
        splits = paged_attention.last_splits   # as the wrapper launched it
        bound, by = attn_bound(args[0], args[1], args[4], "bfloat16")
        attn_rows.append(dict(
            shape=label, T=T, lengths=lens, splits=splits, max_abs_err=err,
            ms=cuda_ms(torch, lambda: paged_attention(*args), flush=flush),
            plain_ms=cuda_ms(torch, lambda: paged_attention_ref(*args),
                             flush=flush),
            bound_ms=bound, bound_by=by, library_ms=None))
    mig_worst, mig_rows = phase_migrate(torch, gen, flush)
    window_worst, window_rows = phase_window_kernels(torch, gen, flush)
    del flush
    torch.cuda.empty_cache()
    for row in attn_rows + mig_rows + window_rows:
        emit("time", **row)
    err = {"paged_attention": max([attn_err["bfloat16"]]
                                  + [r["max_abs_err"] for r in attn_rows]),
           "migrate_blocks": mig_worst,
           "paged_window_attention": window_worst}
    return err, attn_rows, mig_rows, window_rows


def window_case(torch, gen, *, B, T, lengths, dtype):
    """One windowed call at Mellum2's sliding layers' heads."""
    return attn_case(torch, gen, B=B, T=T, bs=8, lengths=lengths,
                     dtype=dtype, **MELLUM_ATTN)


def phase_window_kernels(torch, gen, flush):
    """The windowed kernel (``paged_window_attention_kernel`` and, split,
    ``paged_window_combine_kernel``) against the plain version with the
    same window, at Mellum2's heads: decode at B = 16 and 64 over contexts
    of 3,072 and 8,192 (split plans), contexts at the window's edge, verify
    rows (gamma = 3) and 512-query chunks, one across the window's edge
    (unsplit plans); then its times in bf16 beside the window-0 kernel's on
    the same inputs."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    W = MELLUM_WINDOW
    cases = [dict(B=16, T=1, lengths=[3072 - 37 * i for i in range(16)]),
             dict(B=64, T=1, lengths=[8192 - 61 * i for i in range(64)]),
             dict(B=64, T=1, lengths=[3072 - 29 * i for i in range(64)]),
             dict(B=16, T=1, lengths=[8192 - 5 * i for i in range(16)]),
             # at the window's edge, and shorter than it
             dict(B=8, T=1, lengths=[W - 1, W, W + 1, W + 7, W + 8, W + 33,
                                     300, 2 * W]),
             dict(B=16, T=4, lengths=[3072 + 4 - 41 * i for i in range(16)]),
             dict(B=4, T=4, lengths=[W + 2, W + 3, W + 4, 8192]),
             dict(B=1, T=512, lengths=[1300]),      # across the edge
             dict(B=1, T=512, lengths=[3072]),
             dict(B=2, T=512, lengths=[8192, W + 512])]
    worst, splits = {}, set()
    for dtype_name in ("float32", "bfloat16"):
        worst[dtype_name] = 0.0
        for kw in cases:
            args = window_case(torch, gen, dtype=getattr(torch, dtype_name),
                               **kw)
            got = paged_attention(*args, window=W)
            splits.add(paged_attention.last_splits)
            want = paged_attention_ref(*args, W)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), kw
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype_name], (dtype_name, kw, err)
            worst[dtype_name] = max(worst[dtype_name], err)
    # both plans ran: one split (the chunks) and more (decode)
    assert 1 in splits and max(splits) > 1, splits
    emit("check", kernel="paged_window_attention", window=W,
         cases=len(cases), splits=sorted(splits), max_abs_err=worst,
         atol=ATOL)
    rows = []
    for label, B, T, ctx in WINDOW_TIMED:
        lens = [ctx + T - 2 * i for i in range(B)]
        args = window_case(torch, gen, B=B, T=T, lengths=lens,
                           dtype=torch.bfloat16)
        err = (paged_attention(*args, window=W).float()
               - paged_attention_ref(*args, W).float()).abs().max().item()
        assert err <= ATOL["bfloat16"], (label, err)
        n_splits = paged_attention.last_splits
        bound, by = attn_bound(args[0], args[1], args[4], "bfloat16", W)
        rows.append(dict(
            shape=label, T=T, B=B, context=ctx, window=W, splits=n_splits,
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: paged_attention(*args, window=W),
                       flush=flush),
            plain_ms=cuda_ms(torch, lambda: paged_attention_ref(*args, W),
                             flush=flush),
            bound_ms=bound, bound_by=by, library_ms=None,
            window0_ms=cuda_ms(torch, lambda: paged_attention(*args),
                               flush=flush)))
        del args
    torch.cuda.empty_cache()
    return max([worst["bfloat16"]] + [r["max_abs_err"] for r in rows]), rows


def pair_pools(torch, gen, nb1, dtypes=("bfloat16",) * 4, shapes=PAIR_POOLS):
    """Seeded random (L, NB+1, bs, KH, hd) pools on the card."""
    return [torch.randn((shape[0], nb1) + tuple(shape[1:]), generator=gen,
                        device="cuda").to(getattr(torch, dt))
            for shape, dt in zip(shapes, dtypes)]


def mig_plan(m, nb1):
    """A contraction's shape of plan: the last ``m`` blocks before the
    trash block move to the first ``m``."""
    return list(range(nb1 - 1 - m, nb1 - 1)), list(range(m))


def mig_bound_ms(pools, m):
    """Each moved segment read once and written once, and the 2m ids, over
    HBM bandwidth."""
    seg = sum(p.shape[0] * p.stride(1) * p.element_size() for p in pools)
    return (2 * m * seg + 8 * m) / HBM_BYTES_PER_S * 1e3


def host_us(torch, fn, iters=30):
    """Median host time of ``fn`` (perf_counter around the call, no
    synchronise): what the caller's thread spends to enqueue it."""
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(ts)[iters // 2] * 1e6


def phase_migrate(torch, gen, flush):
    """migrate_blocks bitwise against its plain version (single pools of
    the reference sweep and the target; the four pools at full width with
    plans inline, at the inline cap, past it and at 2,048 pairs; float32
    and bfloat16 in one call), then its times: the four pools as the
    serve's CoW forks and contractions call it, and the earlier
    single-tensor rows.  Returns (worst error, time rows)."""
    from repro_torch.kernels.block_migration import (INLINE_CAP, _launch,
                                                     check_plan,
                                                     migrate_blocks)
    from repro_torch.kernels.ref import migrate_blocks_ref

    def mig_err(pools, src, dst):
        """Largest difference between the kernel and the plain version on
        copies of ``pools``; the kernel must be bitwise equal."""
        want = [migrate_blocks_ref(p.clone(), src, dst) for p in pools]
        got = migrate_blocks([p.clone() for p in pools], src, dst)
        torch.cuda.synchronize()
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        for g, w in zip(got, want):
            assert torch.equal(g, w), (g.dtype, g.shape, len(src), err)
        return err

    worst, checks = 0.0, 0
    singles = [(3, nb, rs) for nb, rs in ((8, (4, 2, 4)), (16, (2, 8, 16)),
                                          (5, (3, 2, 2)))]
    singles.append((PAIR_POOLS[0][0], SERVE_NB1, PAIR_POOLS[0][1:]))
    for dtype_name in ("float32", "bfloat16"):
        for Ls, nb, rs in singles:
            pool, = pair_pools(torch, gen, nb, (dtype_name,), [(Ls,) + rs])
            perm = torch.randperm(nb, generator=gen, device="cuda").tolist()
            m = max(nb // 2, 1)
            src, dst = perm[:m], perm[m:2 * m][:m]
            worst = max(worst, mig_err([pool], src[:len(dst)], dst))
            checks += 1
            del pool
    # the four pools: float32 target beside bfloat16 draft in one call
    pools = pair_pools(torch, gen, SERVE_NB1, ("float32",) * 2
                       + ("bfloat16",) * 2)
    worst = max(worst, mig_err(pools, *mig_plan(256, SERVE_NB1)))
    checks += 1
    by_nb1 = {}
    for m in sorted({1, 256, INLINE_CAP, INLINE_CAP + 1, 2048}):
        by_nb1.setdefault(max(SERVE_NB1, 2 * m + 1), []).append(m)
    for nb1, ms in by_nb1.items():
        pools = pair_pools(torch, gen, nb1)
        for m in ms:
            perm = torch.randperm(nb1, generator=gen, device="cuda").tolist()
            worst = max(worst, mig_err(pools, perm[:m], perm[m:2 * m]))
            checks += 1
    del pools
    torch.cuda.empty_cache()
    emit("check", kernel="migrate_blocks", calls=checks, bitwise_equal=True,
         max_abs_err=worst, inline_cap=INLINE_CAP)

    rows = []
    for label, m, nb1 in MIG_TIMED:
        pools = pair_pools(torch, gen, nb1)
        src, dst = mig_plan(m, nb1)
        err = mig_err(pools, src, dst)
        worst = max(worst, err)
        s_d = torch.tensor(src, device="cuda")
        d_d = torch.tensor(dst, device="cuda")

        def library():
            for p in pools:
                p.index_copy_(1, d_d, p.index_select(1, s_d))
        # the card's practical rate for these bytes: one contiguous copy
        half = torch.empty(m * sum(p.shape[0] * p.stride(1) for p in pools),
                           dtype=torch.bfloat16, device="cuda")
        other = torch.empty_like(half)
        copy_ms = cuda_ms(torch, lambda: other.copy_(half), flush=flush)
        del half, other
        rows.append(dict(
            shape=f"{label}: M={m}, K and V of the target "
            f"{tuple(pools[0].shape)} and the draft {tuple(pools[2].shape)}",
            M=m, tensors=len(pools), ids="inline" if m <= INLINE_CAP
            else "uploaded", max_abs_err=err,
            ms=cuda_ms(torch, lambda: migrate_blocks(pools, src, dst),
                       flush=flush),
            plain_ms=cuda_ms(torch, lambda: [migrate_blocks_ref(p, src, dst)
                                             for p in pools], flush=flush),
            library_ms=cuda_ms(torch, library, flush=flush),
            host_us=host_us(torch, lambda: migrate_blocks(pools, src, dst)),
            contiguous_copy_ms=copy_ms, bound_ms=mig_bound_ms(pools, m),
            bound_by="bytes"))
        del pools
        torch.cuda.empty_cache()
    for label, m in MIG_TIMED_TARGET:
        pool, = pair_pools(torch, gen, SERVE_NB1, shapes=PAIR_POOLS[:1])
        src, dst = mig_plan(m, SERVE_NB1)
        s_d = torch.tensor(src, device="cuda")
        d_d = torch.tensor(dst, device="cuda")
        err = mig_err([pool], src, dst)
        worst = max(worst, err)
        rows.append(dict(
            shape=f"{label}, target pool {tuple(pool.shape)}", M=m,
            tensors=1, ids="inline", max_abs_err=err,
            ms=cuda_ms(torch, lambda: migrate_blocks(pool, src, dst),
                       flush=flush),
            plain_ms=cuda_ms(torch, lambda: migrate_blocks_ref(pool, src,
                                                               dst),
                             flush=flush),
            library_ms=cuda_ms(torch, lambda: pool.index_copy_(
                1, d_d, pool.index_select(1, s_d)), flush=flush),
            host_us=host_us(torch, lambda: migrate_blocks(pool, src, dst)),
            bound_ms=mig_bound_ms([pool], m), bound_by="bytes"))
        del pool
    # the inline cap: one launch with the ids in its parameters against one
    # that uploads them first, on four small pools (one 32-byte segment per
    # block), so the call is launch and ids, not copying
    tiny = pair_pools(torch, gen, 4097, shapes=[(1, 16)] * 4)
    cap = []
    for m in (64, 512, 2048):
        s, d = check_plan(*mig_plan(m, 4097), 4097)
        row = {"M": m}
        for how in ("inline", "uploaded"):
            def call():
                _launch(tiny, s, d, inline=how == "inline")
            row[f"{how}_host_us"] = host_us(torch, call)
            row[f"{how}_ms"] = cuda_ms(torch, call)
        cap.append(row)
    emit("inline_cap", kernel="migrate_blocks", inline_cap=INLINE_CAP,
         pools="four of (1, 4097, 16) bf16", rows=cap)
    del tiny
    torch.cuda.empty_cache()
    return worst, rows


def flash_bound(B, Sq, Sk, H, KH, D, causal, dtype_name, es,
                prefix_len=0):
    """Least time of one call: 4 * D flops per visible (query, key) pair and
    head over the type's peak (causal: query i sees max(i + 1,
    prefix_len) keys; non-causal: every query sees all Sk), against q, k
    and v read once and the output written once over HBM bandwidth."""
    pairs = (sum(max(i + 1, min(prefix_len, Sk)) for i in range(Sq))
             if causal else Sq * Sk)
    flops = 4 * B * H * D * pairs
    nbytes = es * B * D * (2 * Sq * H + 2 * Sk * KH)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_flash(torch):
    """flash_attention against its plain version, then its times."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(B, Sq, Sk, H, KH, D, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))]

    worst, groups = {"float32": 0.0, "bfloat16": 0.0}, {}
    for group, cases, atol in (("reference sweep", FLASH_CASES, FLASH_ATOL),
                               ("head_dim 256", FLASH_256_CASES, ATOL),
                               ("O(1)-state families", FLASH_O1_CASES,
                                ATOL)):
        errs = groups[group] = {"cases": len(cases), "atol": atol,
                                "max_abs_err": {}}
        for dtype_name in ("float32", "bfloat16"):
            errs["max_abs_err"][dtype_name] = 0.0
            for B, Sq, Sk, H, KH, D, causal, prefix in cases:
                args = inputs(B, Sq, Sk, H, KH, D,
                              getattr(torch, dtype_name))
                got = flash_attention(*args, causal=causal,
                                      prefix_len=prefix)
                want = flash_attention_ref(*args, causal=causal,
                                           prefix_len=prefix)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), (B, Sq, Sk, H, KH, D)
                err = (got.float() - want.float()).abs().max().item()
                assert err <= atol[dtype_name], (dtype_name, B, Sq, Sk, H,
                                                 KH, D, causal, prefix, err)
                errs["max_abs_err"][dtype_name] = max(
                    errs["max_abs_err"][dtype_name], err)
                worst[dtype_name] = max(worst[dtype_name], err)
    emit("check", kernel="flash_attention",
         cases=sum(g["cases"] for g in groups.values()), max_abs_err=worst,
         groups=groups)

    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    rows = []
    for label, B, Sq, Sk, H, KH, D, causal, prefix in FLASH_TIMED:
        q, k, v = inputs(B, Sq, Sk, H, KH, D, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kw = dict(causal=causal, prefix_len=prefix)
        if prefix:   # SDPA takes the prefix-causal mask as a boolean tensor
            pos = torch.arange(Sq, device="cuda")
            lib_kw = dict(attn_mask=(pos[:, None] >= pos[None, :])
                          | (pos[None, :] < prefix))
        else:
            lib_kw = dict(is_causal=causal)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **lib_kw)
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.transpose(1, 2).float() - want.float()).abs().max()
        assert err <= ATOL["bfloat16"], (label, err)
        assert lib_err.item() <= FLASH_ATOL["bfloat16"], (label, lib_err)
        bound, by = flash_bound(B, Sq, Sk, H, KH, D, causal, "bfloat16",
                                q.element_size(), prefix)
        rows.append(dict(
            shape=f"{label}: B={B} "
            + (f"S={Sq}" if Sq == Sk else f"Sq={Sq} Sk={Sk}")
            + f" H={H} KH={KH} D={D}" + ("" if causal else " non-causal")
            + (f" prefix_len={prefix}" if prefix else ""),
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: flash_attention(q, k, v, **kw),
                       flush=flush),
            plain_ms=cuda_ms(torch, lambda: flash_attention_ref(q, k, v,
                                                                **kw),
                             flush=flush, iters=10),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **lib_kw), flush=flush),
            bound_ms=bound, bound_by=by))
        del q, k, v, qt, kt, vt, got, want, lib
    del flush
    torch.cuda.empty_cache()
    for row in rows:
        emit("time", kernel="flash_attention", **row)
    return max([worst["bfloat16"]] + [r["max_abs_err"] for r in rows]), rows


# ---------------------------------------------------------------------------
# phases 3-5: the serving path
# ---------------------------------------------------------------------------


def requests(vocab, n=8, seed=0):
    """Eight 16-token prompts sharing an 8-token system template.  Requests
    2 and 3 repeat requests 0 and 1 (a retried question) while those still
    run, so their fully cached prompts fork a shared block (copy-on-write)
    to recompute the last prompt token."""
    from repro_torch.serving.workload import tiny_requests
    reqs = tiny_requests(n, prompt_len=16, output_len=16, template_len=8,
                         vocab=vocab, seed=seed)
    for dup, src in zip(reqs[2:4], reqs[:2]):
        dup.prompt_tokens = list(src.prompt_tokens)
    return reqs


def streams(engine, reqs):
    return {r.req_id: engine.backend.output_tokens(r.req_id)[
        :r.output_len + 1] for r in reqs}


def _wrappers():
    from repro_torch.kernels.block_migration import migrate_blocks
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.paged_attention import paged_attention
    return {"paged_attention": paged_attention,
            "migrate_blocks": migrate_blocks,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["paged_attention"].window_launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def check_run(m, reqs, outs, vocab):
    assert len(m.requests) == len(reqs), (len(m.requests), len(reqs))
    for r in reqs:
        toks = outs[r.req_id]
        assert len(toks) == r.output_len + 1, (r.req_id, len(toks))
        assert all(0 <= t < vocab for t in toks), r.req_id


def phase_serve(torch):
    from repro_torch import configs
    from repro_torch.launch.serve import build_real_engine
    cfg = configs.get_config("paper-7b")
    dcfg = configs.get_draft_config("paper-7b")
    kw = dict(device="cuda", dtype="bfloat16", policy="nightjar",
              prefix_caching=True, chunk_tokens=16, seed=0)
    t0 = time.perf_counter()
    warm = build_real_engine(cfg, dcfg, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # a warm-up run on other prompts keeps the first launches of every
    # kernel and library call out of the measured run; the measured engine
    # starts with a fresh planner, scheduler and prefix cache on the same
    # weights
    t0 = time.perf_counter()
    warm.run(requests(cfg.vocab_size, n=4, seed=1), max_steps=5000)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    params = (warm.backend.tparams, warm.backend.dparams)
    del warm
    engine = build_real_engine(cfg, dcfg, params=params, **kw)
    reqs = requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = engine.run(reqs, max_steps=5000, record_timeline=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = streams(engine, reqs)
    check_run(m, reqs, outs, cfg.vocab_size)
    spec_steps = m.spec.get("spec_steps", 0)
    assert spec_steps >= 1, m.spec
    assert counts["paged_attention"] > 0 and counts["migrate_blocks"] > 0, \
        counts
    assert counts["flash_attention"] == 0, counts
    emit("serve", model="paper-7b full width and depth, bf16",
         target_layers=cfg.num_layers, draft_layers=dcfg.num_layers,
         setup_s=setup_s, warmup_s=warm_s, wall_s=wall,
         output_tokens=m.total_tokens,
         tokens_per_s=m.total_tokens / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         requests_finished=len(m.requests), spec_steps=spec_steps,
         prefix_forks=m.prefix.get("forks", 0), launches=counts,
         step_ms={g: 1e3 * v["latency_s"] / v["steps"]
                  for g, v in m.spec["per_gamma"].items()},
         graphs=graph_counts(engine.backend), summary=m.summary())
    del engine
    torch.cuda.empty_cache()
    return counts, params, outs


def tree_bytes(tree):
    return sum(tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def phase_elastic_full(torch, params):
    """The elastic pool's whole cycle (paper §6.3-6.4) at full width and
    depth, bf16: ``build_real_engine``'s pool (1,024 blocks) and memory
    manager (draft_blocks 256), driven by hand.  Block tables fill the base
    region, speculation is off, so the manager offloads the draft and grows
    the pools; sequences take the whole expanded region; every page tensor
    gets seeded random bits; the base tables finish and, with the queue
    empty, the manager migrates the 256 blocks, trims the pools and
    reloads the draft.  Each moved block must carry its source's bits on
    all four tensors, and the reloaded draft runs one decode step.  Times
    the manager's grow, migrate, shrink, offload and reload hooks (host
    clock between synchronises), and the same move repeated through
    ``migrate_pools`` afterwards (median of five).  Returns the kernel
    launches of the contraction."""
    from repro_torch import configs
    from repro_torch.launch.serve import build_real_engine
    from repro_torch.serving.kv_cache import MigrationPlan
    cfg = configs.get_config("paper-7b")
    dcfg = configs.get_draft_config("paper-7b")
    engine = build_real_engine(cfg, dcfg, device="cuda", dtype="bfloat16",
                               seed=0, params=params)
    be, mm = engine.backend, engine.memmgr
    bm = be.bm
    nb, extra, bs = bm.base_blocks, mm.draft_blocks, bm.block_size
    assert (nb, extra) == (SERVE_NB1 - 1, 256), (nb, extra)
    ms = {}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out
        return run
    for hook in ("offload", "grow", "migrate", "shrink", "reload"):
        setattr(mm, f"{hook}_fn", timed(hook, getattr(mm, f"{hook}_fn")))

    per_seq = 8                        # blocks per sequence
    fillers = range(nb // per_seq)
    for i in fillers:
        bm.allocate(i, per_seq * bs)
    assert bm.num_allocatable == 0
    for step in range(mm.t_persist):
        mm.step(float(step), spec_disabled=True, waiting=1)
    assert not be.draft_resident and bm.total_blocks == nb + extra
    live = range(nb, nb + extra // per_seq)
    for i in live:
        bm.allocate(i, per_seq * bs)
    old = {i: list(bm.tables[i]) for i in live}
    assert sorted(b for t in old.values() for b in t) == list(
        range(nb, nb + extra))
    gen = torch.Generator(device="cuda").manual_seed(7)
    keys = [(m, k) for m in ("tkv", "dkv") for k in ("k_pages", "v_pages")]
    for m, k in keys:
        getattr(be, m).pages[k].normal_(generator=gen)
    high = {(m, k): getattr(be, m).pages[k][:, nb:nb + extra].clone()
            for m, k in keys}
    for i in fillers:
        bm.release(i)
    reset_counts()
    mm.step(float(mm.t_persist), spec_disabled=False, waiting=0)
    counts = read_counts()
    ev = {e.kind: e for e in mm.events}
    assert [e.kind for e in mm.events] == ["offload", "expand", "contract",
                                           "reload"], mm.events
    moved = ev["contract"].detail["migrated_blocks"]
    assert moved == extra, moved
    assert be.draft_resident and bm.total_blocks == nb
    src = torch.tensor([b - nb for i in live for b in old[i]], device="cuda")
    dst = torch.tensor([b for i in live for b in bm.tables[i]],
                       device="cuda")
    assert int(dst.max()) < nb
    for m, k in keys:
        now = getattr(be, m).pages[k]
        assert now.shape[1] == nb + 1, now.shape
        assert torch.equal(now[:, dst].view(torch.int16),
                           high[m, k][:, src].view(torch.int16)), (m, k)
    del high
    # the reloaded draft decodes one token on a moved sequence's table
    i = live[0]
    logits, _ = be.draft.decode_step_paged(
        be.dparams, be.dkv.pages,
        torch.zeros((1, 1), dtype=torch.long, device="cuda"),
        torch.tensor([bm.tables[i]], dtype=torch.int32, device="cuda"),
        torch.tensor([per_seq * bs - 1], dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert logits.shape == (1, 1, dcfg.vocab_size), logits.shape
    assert torch.isfinite(logits).all()
    # the same 256-block move again through migrate_pools, on the trimmed
    # pools (the moved blocks to free ones), with the card busy and the
    # kernel loaded: what the step costs without a cold start
    again = sorted(be.migrate_pools(MigrationPlan(
        src=sorted(dst.tolist()), dst=sorted(bm.free)[:extra])) * 1e3
        for _ in range(5))
    ms["migrate_again"] = again[2]
    block_bytes = be.tkv.bytes_per_block + be.dkv.bytes_per_block
    emit("elastic_full", model="paper-7b full width and depth, bf16, "
         "build_real_engine's pool", base_blocks=nb, draft_blocks=extra,
         migrated_blocks=moved, ms=ms,
         contract_event_ms=ev["contract"].latency * 1e3,
         moved_bytes=2 * moved * block_bytes,
         migrate_bound_ms=2 * moved * block_bytes / HBM_BYTES_PER_S * 1e3,
         shrink_bound_ms=2 * (nb + 1) * block_bytes / HBM_BYTES_PER_S * 1e3,
         grow_bound_ms=(2 * (nb + 1) + extra) * block_bytes
         / HBM_BYTES_PER_S * 1e3, draft_bytes=tree_bytes(be.dparams),
         launches=counts, draft_step_logits_finite=True)
    del engine, be, mm
    torch.cuda.empty_cache()
    return counts


FP32_DEPTH = 4   # the fp32 phases' cut: layers of the target and the draft


def fp32_cut(depth=FP32_DEPTH):
    from repro_torch import configs
    return (configs.get_config("paper-7b").replace(num_layers=depth,
                                                   dtype="float32"),
            configs.get_draft_config("paper-7b").replace(num_layers=depth,
                                                         dtype="float32"))


def phase_lossless(torch, params):
    """Nightjar against AR twice: with the paper's draft, which random
    weights make reject everything, and with the target as its own draft,
    which accepts, so committed verify rows t > 0 are covered too."""
    from repro_torch.launch.serve import build_real_engine
    cfg, dcfg = fp32_cut()
    runs = (("nightjar", "nightjar", dcfg, params),
            ("ar", "ar", dcfg, params),
            ("nightjar, draft = target", "nightjar", cfg,
             (params[0], params[0])))
    out, accepted = {}, {}
    for name, policy, draft_cfg, pair in runs:
        engine = build_real_engine(cfg, draft_cfg, device="cuda",
                                   policy=policy, prefix_caching=True,
                                   chunk_tokens=16, seed=0, params=pair)
        reqs = requests(cfg.vocab_size)
        reset_counts()
        m = engine.run(reqs, max_steps=5000, record_timeline=True)
        counts = read_counts()
        out[name] = streams(engine, reqs)
        check_run(m, reqs, out[name], cfg.vocab_size)
        accepted[name] = sum(g["accepted"] for gam, g in
                             m.spec.get("per_gamma", {}).items() if gam > 0)
        if policy == "nightjar":
            assert m.spec.get("spec_steps", 0) >= 1, m.spec
        graphs = graph_counts(engine.backend)
        assert graphs["replays"] > 0, graphs
        emit("lossless_run", run=name, spec=m.spec_summary(),
             accepted_tokens=accepted[name], launches=counts, graphs=graphs)
        del engine
    assert accepted["nightjar, draft = target"] > 0, accepted
    for name in ("nightjar", "nightjar, draft = target"):
        assert out[name] == out["ar"], f"fp32 {name} stream != AR stream"
    emit("lossless", model=f"paper-7b full width, {cfg.num_layers} target + "
         f"{dcfg.num_layers} draft layers, fp32, TF32 off",
         requests=len(out["ar"]), equal=True, accepted_tokens=accepted)


def recipe(params, *, memmgr, blocks=24, block_size=4, chunk=None,
           prefix_caching=False, host_blocks=None, prompt=10, out=12,
           wave2=0, setup=None, policy=None):
    """tests/test_paged_backend.py's engine recipe on the card, at the fp32
    cut: by default the elastic pool's (24 blocks of 4 tokens, four
    requests).  ``chunk`` is the chunk budget, ``host_blocks`` the capacity
    of a host KV tier; ``wave2`` more requests repeat the first four's
    prompts once those have drained; ``setup(engine)`` runs before the
    engine does; ``policy``, the planner, Nightjar's by default."""
    from repro_torch.core.bandits import make_policy
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import BlockManager, HostKVStore
    from repro_torch.serving.memory_manager import ElasticMemoryManager
    from repro_torch.serving.real_backend import RealBackend
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    from repro_torch.serving.workload import tiny_requests
    cfg, dcfg = fp32_cut()
    bm = BlockManager(blocks, block_size, prefix_caching=prefix_caching,
                      host_store=HostKVStore(host_blocks) if host_blocks
                      else None)
    be = RealBackend(registry.get_model(cfg), registry.get_model(dcfg),
                     device="cuda", params=params, max_batch=4, seed=0,
                     block_manager=bm)
    sched = ContinuousBatchingScheduler(bm, max_batch=4, chunk_tokens=chunk,
                                        watermark_frac=0.0)
    mm = None
    if memmgr:
        mm = ElasticMemoryManager(
            bm, draft_blocks=4, t_persist=1, tau_low_frac=0.4,
            offload_fn=be.offload_draft, reload_fn=be.reload_draft,
            migrate_fn=be.migrate_pools, grow_fn=be.grow_pools,
            shrink_fn=be.shrink_pools)
    eng = ServingEngine(be, sched, policy or make_policy("nightjar", 3,
                                                          seed=0), mm,
                        gamma_max=3)
    reqs = tiny_requests(4, rate_qps=1e6, prompt_len=prompt, output_len=out,
                         vocab=cfg.vocab_size, seed=5)
    reqs += repeat_wave(reqs, wave2)
    if setup is not None:
        setup(eng)
    m = eng.run(reqs, max_steps=3000, record_timeline=True)
    outs = streams(eng, reqs)
    check_run(m, reqs, outs, cfg.vocab_size)
    return outs, m


def repeat_wave(reqs, n):
    """``n`` more requests, long after ``reqs`` have drained, asking the
    prompts of ``reqs`` again in turn (a retried batch)."""
    import dataclasses
    return [dataclasses.replace(
        r, req_id=len(reqs) + i, arrival=r.arrival + 1e4,
        prompt_tokens=list(r.prompt_tokens))
        for i, r in ((i, reqs[i % len(reqs)]) for i in range(n))]


class Scripted:
    """gamma 0 while three or more sequences run (speculation off, so the
    memory manager may offload the draft), 2 below (tests/
    test_torch_engine.py's planner of the elastic cycle)."""
    name = "scripted"

    def select(self, batch, *, delta_max=0):
        return 0 if batch >= 3 else 2

    def observe(self, *args, **kw):
        pass


def phase_elastic(params):
    """The elastic memory manager's whole cycle on a 24-block pool with a
    scripted planner and a second wave (tests/test_torch_engine.py's
    ``CYCLE``): the draft is offloaded and the pool grows, then the pool
    is contracted and trimmed and the draft reloaded; the streams equal
    an unmanaged run's.  With step graphs on, each move drops graphs;
    every spec step after the reload runs a graph captured over the
    reloaded draft, and all but the first of a key replay it."""
    after = []

    def watch(eng):
        be, mm = eng.backend, eng.memmgr
        reload, step = mm.reload_fn, be.step

        def reload_draft():
            reload()
            after.append("reload")

        def counted_step(seqs, gamma):
            g = be._graphs
            before = (g.captures, g.replays)
            out = step(seqs, gamma)
            if after and gamma > 0:
                after.append("capture" if g.captures > before[0] else
                             "replay" if g.replays > before[1] else "eager")
            return out
        mm.reload_fn, be.step = reload_draft, counted_step
        watch.backend = be

    reset_counts()
    managed, m = recipe(params, memmgr=True, wave2=2, setup=watch,
                        policy=Scripted())
    counts = read_counts()
    be = watch.backend
    graphs = graph_counts(be)
    del be.step, watch.backend, be
    plain, _ = recipe(params, memmgr=False, wave2=2, policy=Scripted())
    assert m.offload_events >= 1 and m.reload_events >= 1, m.summary()
    assert managed == plain, "elastic-pool streams differ from unmanaged"
    spec_after = after[after.index("reload") + 1:]
    assert "replay" in spec_after and "eager" not in spec_after, after
    assert graphs["replays"] > 0 and graphs["captures"] > graphs["keys"], \
        graphs
    emit("elastic", offload_events=m.offload_events,
         reload_events=m.reload_events, equal=True, launches=counts,
         graphs=graphs, spec_steps_after_reload=spec_after)


# ---------------------------------------------------------------------------
# the real tier under memory pressure: chunked prefill, preempt-and-recompute
# and the host KV tier (tests/test_torch_pressure.py, test_torch_host_tier.py)
# ---------------------------------------------------------------------------


def counted(run):
    """``run()``'s result and the kernel launches it made."""
    reset_counts()
    out = run()
    return out, read_counts()


def preemption_trace(eng):
    """Attach a trace recorder to ``eng``; the scheduler reports each
    preemption to it."""
    from repro_torch.serving.observability import TraceRecorder
    eng.attach_trace(TraceRecorder())


def preemptions(eng):
    trace = eng.trace
    assert trace.dropped == 0, trace.dropped
    return sum(1 for e in trace.events if e["name"] == "preempt")


def phase_chunked_lossless(torch, params):
    """tests/test_paged_backend.py:398 on the card, fp32 with TF32 off at
    the cut depth: 24-token prompts prefilled in chunks of 4, 7 and 16
    tokens give the streams of monolithic prefill, with steps that mix
    prefill chunks and decode rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kw = dict(memmgr=False, blocks=256, block_size=8, prompt=24, out=8)
    (mono, _), counts = counted(lambda: recipe(params, **kw))
    assert counts["paged_attention"] > 0, counts
    runs = {"monolithic": {"launches": counts}}
    for chunk in (4, 7, 16):
        (got, m), counts = counted(lambda: recipe(params, chunk=chunk, **kw))
        # steps that carried prefill chunks and decode rows together
        mixed = sum(1 for r in m.timeline if r["prefill_tokens"] and r["B"])
        assert got == mono, f"chunk {chunk} stream != monolithic"
        assert mixed > 0 and counts["paged_attention"] > 0, (chunk, counts)
        runs[f"chunk {chunk}"] = {"mixed_steps": mixed, "launches": counts}
    emit("chunked_lossless", model=f"paper-7b full width, {FP32_DEPTH} "
         "target + draft layers, fp32, TF32 off", requests=4,
         prompt_tokens=24, equal=True, runs=runs,
         seconds=time.perf_counter() - t0)


def phase_preempt_lossless(torch, params):
    """tests/test_paged_backend.py:411 on the card (the reference does not
    finish it, ROADMAP C15): 10 blocks of 4 tokens under four requests of
    10 + 16 tokens, chunks of 6, force preempt-and-recompute; every
    request finishes with the streams of a roomy pool."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    roomy, _ = recipe(params, memmgr=False, blocks=256, block_size=8,
                      out=16)
    engines = []

    def setup(eng):
        preemption_trace(eng)
        engines.append(eng)
    (squeezed, m), counts = counted(lambda: recipe(
        params, memmgr=False, blocks=10, block_size=4, chunk=6, out=16,
        setup=setup))
    n_preempt = preemptions(engines.pop())
    assert squeezed == roomy, "squeezed streams != roomy streams"
    assert n_preempt > 0 and counts["paged_attention"] > 0, \
        (n_preempt, counts)
    emit("preempt_lossless", model=f"paper-7b full width, {FP32_DEPTH} "
         "target + draft layers, fp32, TF32 off", blocks=10, block_size=4,
         requests_finished=len(m.requests), preemptions=n_preempt,
         equal=True, launches=counts, seconds=time.perf_counter() - t0)


def phase_host_tier_lossless(torch, params):
    """The host KV tier on the card, fp32 with TF32 off at the cut depth:
    prefix caching on 16 blocks of 4 tokens with a ``HostKVStore`` of 64
    blocks, four 12-token prompts of 8 output tokens, then the same four
    prompts again.  The cache spills the blocks it evicts and the second
    wave restores them; every restore passes the record's checksum
    (``apply_host_transfers`` verifies it), and the streams equal a run
    without the host tier."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kw = dict(memmgr=False, blocks=16, block_size=4, chunk=8,
              prefix_caching=True, prompt=12, out=8, wave2=4)
    verified, draining, backends = [], [], []

    def setup(eng):
        # count the checksum checks made while apply_host_transfers drains
        # the restores (match_prefix checks each record once before)
        be, hs = eng.backend, eng.scheduler.bm.host_store

        def verify(h, check=hs.verify):
            ok = check(h)
            if draining:
                verified.append(ok)
            return ok

        def apply_host_transfers(drain=be.apply_host_transfers):
            draining.append(True)
            try:
                drain()
            finally:
                draining.pop()
        hs.verify, be.apply_host_transfers = verify, apply_host_transfers
        backends.append(be)
    (got, m), counts = counted(lambda: recipe(params, host_blocks=64,
                                              setup=setup, **kw))
    del backends.pop().apply_host_transfers   # no wrapper keeps it alive
    plain, _ = recipe(params, **kw)
    host = {k: v for k, v in m.host.items() if not k.endswith("_s")}
    assert got == plain, "host-tier streams != streams without it"
    assert host["spilled_blocks"] > 0 and host["restores"] > 0, host
    assert len(verified) == host["restores"] and all(verified), verified
    assert counts["paged_attention"] > 0, counts
    if m.prefix["forks"]:
        assert counts["migrate_blocks"] > 0, counts
    emit("host_tier_lossless", model=f"paper-7b full width, {FP32_DEPTH} "
         "target + draft layers, fp32, TF32 off", blocks=16, block_size=4,
         host_blocks=64, requests_finished=len(m.requests), host=host,
         checksums_verified=len(verified), prefix=m.prefix, equal=True,
         launches=counts, seconds=time.perf_counter() - t0)


PRESSURE_BLOCKS = 12   # blocks of 8 tokens: two requests' worth at a time


def phase_pressure_serve(torch, params, serve_outs):
    """The real tier under memory pressure at full width and depth, bf16,
    on the serve's weights: ``build_real_engine``'s pieces with a host KV
    tier (``kv_offload``: a ``HostKVStore`` of four times the pool),
    prefix caching and a chunk budget of 16, on a pool cut to
    PRESSURE_BLOCKS blocks, without the elastic memory manager (it would
    grow the pool out of the pressure).  The serve's eight requests, then
    their prompts again once they have drained: the pool preempts, the
    prefix cache spills what it evicts and the second wave restores it.
    Every request finishes at its full length; prints the preemptions,
    the blocks spilled and restored with their ms and GB/s (host clock
    around a synchronise; pageable host memory) and the part of it spent
    on the records' checksums, tokens/s, peak memory and the launches."""
    from repro_torch import configs
    from repro_torch.core.bandits import make_policy
    from repro_torch.launch.serve import BLOCK_SIZE, GAMMA_MAX, MAX_BATCH
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import BlockManager, HostKVStore
    from repro_torch.serving.real_backend import make_real_backend
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    t_phase = time.perf_counter()
    cfg = configs.get_config("paper-7b").replace(dtype="bfloat16")
    dcfg = configs.get_draft_config("paper-7b").replace(dtype="bfloat16")
    bm = BlockManager(PRESSURE_BLOCKS, BLOCK_SIZE, prefix_caching=True,
                      host_store=HostKVStore(4 * PRESSURE_BLOCKS))
    be = make_real_backend(registry.get_model(cfg), registry.get_model(dcfg),
                           device="cuda", params=params, max_batch=MAX_BATCH,
                           seed=0, block_manager=bm)
    sched = ContinuousBatchingScheduler(bm, max_batch=MAX_BATCH,
                                        chunk_tokens=16)
    eng = ServingEngine(be, sched, make_policy("nightjar", GAMMA_MAX, seed=0),
                        None, gamma_max=GAMMA_MAX)
    preemption_trace(eng)
    checksum = {"seal": [0, 0.0], "verify": [0, 0.0]}   # calls, seconds
    store = bm.host_store
    for name in checksum:
        def timed(h, fn=getattr(store, name), acc=checksum[name]):
            t = time.perf_counter()
            try:
                return fn(h)
            finally:
                acc[0] += 1
                acc[1] += time.perf_counter() - t
        setattr(store, name, timed)
    first = requests(cfg.vocab_size)
    reqs = first + repeat_wave(first, len(first))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = eng.run(reqs, max_steps=20000, record_timeline=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = streams(eng, reqs)
    check_run(m, reqs, outs, cfg.vocab_size)
    hs = store.stats
    n_preempt = preemptions(eng)
    assert n_preempt > 0 and hs["spilled_blocks"] > 0 and hs["restores"] > 0, \
        (n_preempt, hs)
    assert counts["paged_attention"] > 0, counts
    if m.prefix["forks"]:
        assert counts["migrate_blocks"] > 0, counts
    block_bytes = be.tkv.bytes_per_block + be.dkv.bytes_per_block
    spill_bytes = hs["spilled_blocks"] * block_bytes
    restore_bytes = hs["restores"] * block_bytes
    equal = sum(a == b for r in first
                for a, b in zip(outs[r.req_id], serve_outs[r.req_id]))
    emit("pressure_serve", model="paper-7b full width and depth, bf16",
         blocks=PRESSURE_BLOCKS, block_size=BLOCK_SIZE,
         host_blocks=4 * PRESSURE_BLOCKS, block_bytes=block_bytes,
         requests_finished=len(m.requests), preemptions=n_preempt,
         spilled_blocks=hs["spilled_blocks"], restored_blocks=hs["restores"],
         spill_ms=1e3 * hs["spill_s"], restore_ms=1e3 * hs["restore_s"],
         spill_gb_per_s=spill_bytes / hs["spill_s"] / 1e9,
         restore_gb_per_s=restore_bytes / hs["restore_s"] / 1e9,
         # seal runs inside spill_ms; verify once at match time and once
         # inside restore_ms for each restored block
         checksum_calls_ms={k: [n, 1e3 * t] for k, (n, t) in
                            checksum.items()},
         prefix=m.prefix, wall_s=wall, output_tokens=m.total_tokens,
         tokens_per_s=m.total_tokens / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         spec=m.spec_summary(), launches=counts,
         first_wave_tokens_equal_to_serve=equal,
         tokens_compared=sum(len(outs[r.req_id]) for r in first),
         graphs=graph_counts(be),
         seconds=time.perf_counter() - t_phase)
    del eng, be
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phases 6-8: the dense-cache path
# ---------------------------------------------------------------------------


def dense_engine(cfg, dcfg, params, *, policy="nightjar"):
    from repro_torch.launch.serve import build_dense_engine
    return build_dense_engine(cfg, dcfg, device="cuda", policy=policy,
                              params=params)


def phase_dense_serve(torch, params):
    """phase_serve's pair, weights and requests through DenseSlotBackend."""
    from repro_torch import configs
    cfg = configs.get_config("paper-7b").replace(dtype="bfloat16")
    dcfg = configs.get_draft_config("paper-7b").replace(dtype="bfloat16")
    t0 = time.perf_counter()
    dense_engine(cfg, dcfg, params).run(requests(cfg.vocab_size, n=4,
                                                 seed=1), max_steps=5000)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    engine = dense_engine(cfg, dcfg, params)
    reqs = requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = engine.run(reqs, max_steps=5000, record_timeline=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = streams(engine, reqs)
    check_run(m, reqs, outs, cfg.vocab_size)
    assert counts["flash_attention"] > 0, counts
    assert m.spec.get("spec_steps", 0) >= 1, m.spec
    emit("dense_serve", model="paper-7b full width and depth, bf16, "
         "DenseSlotBackend", warmup_s=warm_s, wall_s=wall,
         output_tokens=m.total_tokens, tokens_per_s=m.total_tokens / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         requests_finished=len(m.requests),
         spec_steps=m.spec["spec_steps"],
         draft_catchups=engine.backend.catchups, launches=counts,
         step_ms={g: 1e3 * v["latency_s"] / v["steps"]
                  for g, v in m.spec["per_gamma"].items()},
         summary=m.summary())
    return counts


def phase_dense_lossless(torch, params):
    """The reference's test_paged_engine_matches_dense_engine on the card:
    dense Nightjar, dense AR, paged Nightjar and dense target-as-draft
    greedy streams are equal on every request."""
    from repro_torch.launch.serve import build_real_engine
    cfg, dcfg = fp32_cut()
    runs = (("dense nightjar", lambda: dense_engine(cfg, dcfg, params)),
            ("dense ar", lambda: dense_engine(cfg, dcfg, params,
                                              policy="ar")),
            ("paged nightjar", lambda: build_real_engine(
                cfg, dcfg, device="cuda", policy="nightjar", memmgr=False,
                seed=0, params=params)),
            ("dense nightjar, draft = target", lambda: dense_engine(
                cfg, cfg, (params[0], params[0]))))
    out, accepted = {}, {}
    for name, make in runs:
        engine = make()
        reqs = requests(cfg.vocab_size)
        reset_counts()
        m = engine.run(reqs, max_steps=5000, record_timeline=True)
        counts = read_counts()
        out[name] = streams(engine, reqs)
        check_run(m, reqs, out[name], cfg.vocab_size)
        accepted[name] = sum(g["accepted"] for gam, g in
                             m.spec.get("per_gamma", {}).items() if gam > 0)
        key = "paged_attention" if name.startswith("paged") \
            else "flash_attention"
        assert counts[key] > 0, (name, counts)
        emit("dense_lossless_run", run=name, spec=m.spec_summary(),
             accepted_tokens=accepted[name], launches=counts)
        del engine
    assert accepted["dense nightjar, draft = target"] > 0, accepted
    for name in out:
        assert out[name] == out["dense ar"], f"fp32 {name} stream != AR"
    emit("dense_lossless", model=f"paper-7b full width, {cfg.num_layers} "
         f"target + {dcfg.num_layers} draft layers, fp32, TF32 off",
         requests=len(out["dense ar"]), equal=True, runs=list(out),
         accepted_tokens=accepted)


def phase_cswitch(torch, dparams):
    """Table 3 of the paper (the reference's benchmarks/run.py real tier):
    C_switch(delta, B) = host time of the full-width bf16 draft's dense
    prefill of B sequences of delta tokens into a 600-position cache, after
    one warm-up call per shape."""
    from repro_torch import configs
    from repro_torch.core.cswitch import CSwitchTable
    from repro_torch.models import registry
    api = registry.get_model(configs.get_draft_config("paper-7b").replace(
        dtype="bfloat16"))

    def measure(delta, batch):
        batch_in = {"tokens": torch.zeros((batch, delta), dtype=torch.long,
                                          device="cuda")}
        api.prefill(dparams, batch_in, 600)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(dparams, batch_in, 600)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    reset_counts()
    table = CSwitchTable.profile(measure, deltas=(128, 256, 512),
                                 batches=(2, 8, 32))
    counts = read_counts()
    assert counts["flash_attention"] > 0, counts
    emit("cswitch", model="paper-7b draft (qwen2.5-0.5B layout), full width "
         "and depth, bf16", ms={f"delta={d} B={b}": 1e3 * v
                                for (d, b), v in sorted(table.table.items())},
         launches=counts)



# ---------------------------------------------------------------------------
# phases 10-13: the MoE and VLM decoders
# ---------------------------------------------------------------------------


class DropCounter:
    """Counts the (token, expert) slots ``apply_moe`` drops, by the kind of
    the call: ``install`` swaps ``models.moe.apply_moe`` for a wrapper that
    routes the call's input again (``moe.route``, the same function) and
    adds its dropped slots, on the device, to the kind the backend's wrapped
    entry points set: ``decode`` (the AR step), ``verify`` (the target's
    pass of a speculative step) or ``prefill chunk`` (prefill and chunk
    appends, with any decode rows batched beside them).  Padded batch rows
    are routed too, as the reference routes them, and count; a packed chunk
    call has none, and its capacity drops no slot.  The wrappers
    are taken off the backend again on exit: a wrapper of one of its bound
    methods left on it would keep the backend, and its weights, in a
    reference cycle."""

    TAGS = {"_ar": "decode", "_spec": "verify",
            "_extend_target": "prefill chunk"}

    def __init__(self, torch, backend):
        from repro_torch.models import moe
        self.moe, self.kind, self.stats = moe, None, {}
        self.orig = moe.apply_moe
        self.backend = backend
        dev = backend.device

        def counted(cfg, p, x, *, capacity_factor=None):
            G = moe.groups_for(cfg, x.shape[0] * x.shape[1])
            cf = (capacity_factor if capacity_factor is not None
                  else cfg.moe_capacity_factor)
            r = moe.route(cfg, p["router"], x.reshape(G, -1, x.shape[-1]), cf)
            st = self.stats.setdefault(self.kind, {
                "calls": 0, "slots": 0, "capacity": set(),
                "dropped": torch.zeros((), dtype=torch.long, device=dev)})
            st["calls"] += 1
            st["slots"] += r.position.numel()
            st["capacity"].add(r.capacity)
            st["dropped"] += (~r.kept).sum()
            return self.orig(cfg, p, x, capacity_factor=capacity_factor)
        self.counted = counted

    def _tagged(self, kind, fn):
        def run(*a, **kw):
            self.kind = kind
            return fn(*a, **kw)
        return run

    def __enter__(self):
        self.moe.apply_moe = self.counted
        be = self.backend
        # the counting runs in Python: a replayed step graph would skip it
        self.graphs, be._graphs = be._graphs, None
        self.saved = {name: be.__dict__.get(name) for name in self.TAGS}
        for name, kind in self.TAGS.items():
            setattr(be, name, self._tagged(kind, getattr(be, name)))
        return self

    def __exit__(self, *exc):
        self.moe.apply_moe = self.orig
        for name, fn in self.saved.items():
            if fn is None:          # a method of the class
                delattr(self.backend, name)
            else:
                setattr(self.backend, name, fn)
        self.backend._graphs = self.graphs
        self.backend = self.saved = self.graphs = None

    def summary(self):
        return {k: {"calls": v["calls"], "slots": v["slots"],
                    "capacity": sorted(v["capacity"]),
                    "dropped": int(v["dropped"])}
                for k, v in self.stats.items()}


def serve_pair(torch, arch, *, count_drops=False):
    """``phase_serve`` for another pair: the full-width bf16 pair of
    ``arch`` through ``build_real_engine`` with the serve's traffic, after a
    warm-up run on other prompts.  A pair with a paged path runs it with
    prefix caching and a chunk budget of 16 (and must launch paged
    attention and migrations); one without (ssm, hybrid) gets
    ``DenseSlotBackend`` with monolithic prefill, and its draft catch-ups
    are reported.  With ``count_drops`` the same requests are served once
    more on a fresh engine under a :class:`DropCounter` (kept out of the
    timed run: its routing adds work)."""
    from repro_torch import configs
    from repro_torch.launch.serve import build_real_engine
    from repro_torch.models import registry
    cfg, dcfg = configs.get_config(arch), configs.get_draft_config(arch)
    paged = all(registry.get_model(c).supports_paged for c in (cfg, dcfg))
    kw = dict(device="cuda", dtype="bfloat16", policy="nightjar", seed=0)
    if paged:
        kw.update(prefix_caching=True, chunk_tokens=16)
    torch.cuda.empty_cache()
    # what earlier phases left allocated: ~0 when nothing holds their
    # weights, so the peak below is this pair's own
    left_over = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    warm = build_real_engine(cfg, dcfg, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm.run(requests(cfg.vocab_size, n=4, seed=1), max_steps=5000)
    params = (warm.backend.tparams, warm.backend.dparams)
    del warm
    engine = build_real_engine(cfg, dcfg, params=params, **kw)
    reqs = requests(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = engine.run(reqs, max_steps=5000, record_timeline=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = streams(engine, reqs)
    check_run(m, reqs, outs, cfg.vocab_size)
    assert m.spec.get("spec_steps", 0) >= 1, m.spec
    if paged:
        assert counts["paged_attention"] > 0 \
            and counts["migrate_blocks"] > 0, counts
        assert counts["flash_attention"] == 0, counts
    fields = dict(
        model=f"{arch} full width and depth, bf16", wall_s=wall,
        backend=type(engine.backend).__name__,
        target_layers=cfg.num_layers, draft_layers=dcfg.num_layers,
        setup_s=setup_s, output_tokens=m.total_tokens,
        tokens_per_s=m.total_tokens / wall,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        allocated_before_phase_bytes=left_over,
        requests_finished=len(m.requests), steps=m.spec.get("steps", 0),
        spec_steps=m.spec["spec_steps"], launches=counts,
        step_ms={g: 1e3 * v["latency_s"] / v["steps"]
                 for g, v in m.spec["per_gamma"].items()})
    if paged:
        fields.update(pool_blocks=engine.backend.bm.total_blocks,
                      prefix_forks=m.prefix.get("forks", 0))
    else:
        fields.update(draft_catchups=engine.backend.catchups,
                      prompts=len(reqs))
    del engine
    if count_drops:
        engine = build_real_engine(cfg, dcfg, params=params, **kw)
        with DropCounter(torch, engine.backend) as dc:
            engine.run(requests(cfg.vocab_size), max_steps=5000)
        fields["dropped_slots"] = dc.summary()
        del engine
    del params
    torch.cuda.empty_cache()
    return counts, fields


def long_requests(vocab, n=8, seed=0):
    """``n`` prompts of 1,100 to 1,800 distinct tokens, each past
    Mellum2's 1,024-position window, and 16 tokens out."""
    from repro_torch.serving.workload import tiny_requests
    reqs = tiny_requests(n, prompt_len=1800, output_len=16, vocab=vocab,
                         seed=seed)
    for i, r in enumerate(reqs):
        r.prompt_len = 1100 + 100 * (i % 8)
        r.prompt_tokens = r.prompt_tokens[:r.prompt_len]
    return reqs


def phase_window_serve(torch):
    """Mellum2-12B-A2.5B at full width and depth, bf16, through
    ``build_real_engine`` on the paged path: ``long_requests`` in chunks of
    512 with prefix caching, after a warm-up run on other prompts.  Its 21
    sliding layers launch the windowed kernel, its 7 full layers and the
    draft the window-0 one; both are counted from 0 over the measured run,
    the windowed ones as ``paged_window_attention``."""
    from repro_torch.configs import mellum2_12b
    from repro_torch.configs.base import SLIDING
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import build_real_engine
    cfg, dcfg = mellum2_12b.CONFIG, mellum2_12b.DRAFT
    kw = dict(device="cuda", dtype="bfloat16", policy="nightjar",
              prefix_caching=True, chunk_tokens=512, seed=0)
    torch.cuda.empty_cache()
    left_over = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    warm = build_real_engine(cfg, dcfg, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm.run(long_requests(cfg.vocab_size, n=4, seed=1), max_steps=5000)
    params = (warm.backend.tparams, warm.backend.dparams)
    del warm
    engine = build_real_engine(cfg, dcfg, params=params, **kw)
    reqs = long_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = engine.run(reqs, max_steps=5000, record_timeline=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    counts["paged_window_attention"] = paged_attention.window_launches
    counts["paged_attention"] -= counts["paged_window_attention"]
    outs = streams(engine, reqs)
    check_run(m, reqs, outs, cfg.vocab_size)
    # every target call launches the windowed kernel in each of the 21
    # sliding layers, once per run of rows with equal query counts
    windowed = sum(k == SLIDING for k in cfg.layer_types)
    assert counts["paged_window_attention"] > 0 \
        and counts["paged_window_attention"] % windowed == 0, counts
    assert counts["paged_attention"] > 0, counts
    assert counts["flash_attention"] == 0, counts
    emit("window_serve", model="mellum2-12b-a2.5b full width and depth, "
         "bf16", window=cfg.sliding_window, sliding_layers=windowed,
         target_layers=cfg.num_layers, draft_layers=dcfg.num_layers,
         prompt_lens=[r.prompt_len for r in reqs], setup_s=setup_s,
         wall_s=wall, output_tokens=m.total_tokens,
         tokens_per_s=m.total_tokens / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         allocated_before_phase_bytes=left_over,
         requests_finished=len(m.requests),
         spec_steps=m.spec.get("spec_steps", 0), launches=counts,
         pool_blocks=engine.backend.bm.total_blocks,
         graphs=graph_counts(engine.backend))
    del engine, params
    torch.cuda.empty_cache()
    return counts


GRAPH_BUCKETS = (1, 4, 16, 64)
# context table widths in blocks of 8: a short table and one that splits
# (paper-7b, granite: 512 positions); Mellum2 inside and past its 1,024
# window
GRAPH_WIDTHS = {"paper-7b": (4, 64), GRANITE: (4, 64), "mellum2": (16, 256)}
# the cells' pools (``bench_port/configs``): 64 rows' share of them makes
# graphs 512, 512 and 2,048 blocks wide, as served
GRAPH_POOLS = {"paper-7b": 24576, GRANITE: 24576, "mellum2": 71680}
# batches a step pads up to the next captured bucket (4, 16, 64), against
# a graph of their own power-of-two bucket (2, 8, 32)
PAD_BATCHES = (2, 5, 17)


def graph_backend(torch, arch):
    """A full-width bf16 ``RealBackend`` of ``arch`` (seeded weights) on
    its cell's pool (``GRAPH_POOLS``) of blocks of 8, 64 rows, its pages
    filled with seeded noise."""
    from repro_torch import configs
    from repro_torch.configs import mellum2_12b
    from repro_torch.models import registry
    from repro_torch.serving.real_backend import RealBackend
    if arch == "mellum2":
        cfg, dcfg = mellum2_12b.CONFIG, mellum2_12b.DRAFT
    else:
        cfg, dcfg = configs.get_config(arch), configs.get_draft_config(arch)
    cfg, dcfg = cfg.replace(dtype="bfloat16"), dcfg.replace(dtype="bfloat16")
    be = RealBackend(registry.get_model(cfg), registry.get_model(dcfg),
                     device="cuda", max_batch=64, block_size=8,
                     num_blocks=GRAPH_POOLS[arch], seed=0)
    gen = torch.Generator(device=be.device).manual_seed(7)
    for kv in (be.tkv, be.dkv):
        for t in kv.pages.values():
            t.normal_(generator=gen)
    return be, cfg


def phase_decode_graphs(torch):
    """Each arch's backend captures its steps up front
    (``capture_steps``: batch buckets 1 / 4 / 16 / 64, gamma 0-3, at the
    backend's width, as served: 512 blocks for paper-7b and granite, 2,048
    for Mellum2), timed.  Then each bucket, context width and gamma
    against the eager model call on the same operands (rows of distinct
    blocks, contexts in the last block of ``width`` with gamma + 1
    positions left, tables padded with the write-off block to the graph's
    width, seeded last tokens): the step writes the same positions with
    the same values, so the two calls see one state.  Asserts equal
    tokens (and acceptance counts) from two replays and equal
    ``paged_attention`` launch counts; times each key's eager call and
    replay with CUDA events in turns (eager, graph, graph, eager: the
    host's enqueueing is in the eager time), after an untimed first
    replay, which instantiates the graph.  What padding costs a replay,
    against graphs of a runner of its own: the same step in a graph of
    its tables' own width, and, at the long context, ``PAD_BATCHES`` rows
    in the graph of the bucket a step pads them to against one of their
    power-of-two bucket."""
    import statistics

    import numpy as np
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.paged_runtime import bucket_size
    from repro_torch.serving.step_graphs import CudaGraph, StepGraphs
    rows, pads = [], []
    t_phase = time.perf_counter()
    for arch, widths in GRAPH_WIDTHS.items():
        torch.cuda.empty_cache()
        be, cfg = graph_backend(torch, arch)
        g = be._graphs
        assert g is not None, "no step graphs on the card"
        W = g.width
        assert W == bucket_size(-(-GRAPH_POOLS[arch] // 64)), W
        assert g.buckets == GRAPH_BUCKETS, g.buckets
        n0 = paged_attention.launches
        t0 = time.perf_counter()
        be.capture_steps(3)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        assert paged_attention.launches == n0
        assert g.captures == len(g.entries) == 4 * 4, g.captures
        rng = np.random.default_rng(11)

        def timed(fn):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn()
            e.record()
            torch.cuda.synchronize()
            return out, s.elapsed_time(e)

        def step_fn(gamma):
            return lambda *x: be._padded_call(gamma, *x)

        def replay(runner, key, host):
            entry = runner.load(key, host)
            return runner.run(entry, be._graph_ptrs(key[2]),
                              step_fn(key[2]))

        def replay_ms(runner, key, host):
            """Two timed replays of ``key``'s graph in ``runner``, after
            its capture and an untimed first replay."""
            runner.capture(key, host, be._graph_ptrs(key[2]),
                           step_fn(key[2]))
            replay(runner, key, host)
            return [timed(lambda: replay(runner, key, host))[1]
                    for _ in range(2)]

        def inputs(n, Bb, width, table_w, gamma):
            """``n`` real rows of a ``Bb``-row step, contexts in the last
            block of ``width``, tables ``table_w`` wide."""
            tables = np.full((Bb, table_w), be.tkv.trash, np.int32)
            tables[:n, :width] = np.arange(n * width).reshape(n, width)
            lengths = np.zeros((Bb,), np.int32)
            lengths[:n] = rng.integers((width - 1) * 8, width * 8 - gamma,
                                       n, dtype=np.int32)
            last = np.zeros((Bb,), np.int64)
            last[:n] = rng.integers(0, cfg.vocab_size, n, dtype=np.int64)
            return tables, lengths, last

        for Bb in GRAPH_BUCKETS:
            for width in widths:
                for gamma in range(4):
                    tables, lengths, last = inputs(Bb, Bb, width, W, gamma)
                    ops = tuple(torch.from_numpy(a).to(be.device)
                                for a in (tables, lengths, last))
                    host = be._graph_inputs(tables, lengths, last, gamma)
                    key = (Bb, W, gamma)

                    def eager():
                        return be._padded_call(gamma, *ops)

                    n0 = paged_attention.launches
                    want, e1 = timed(eager)
                    want = [t.cpu() for t in want]
                    n1 = paged_attention.launches
                    # the first replay instantiates the graph: untimed
                    got = [t.cpu() for t in replay(g, key, host)]
                    n2 = paged_attention.launches
                    again, r1 = timed(lambda: replay(g, key, host))
                    again = [t.cpu() for t in again]
                    n3 = paged_attention.launches
                    _, r2 = timed(lambda: replay(g, key, host))
                    _, e2 = timed(eager)
                    tag = (arch, Bb, width, gamma)
                    for a, b, c in zip(want, got, again):
                        assert torch.equal(a, b) and torch.equal(a, c), tag
                    assert n1 - n0 == n2 - n1 == n3 - n2 > 0, \
                        (tag, n0, n1, n2, n3)
                    # the same step in a graph of its tables' own width
                    exact = StepGraphs(CudaGraph, be.device, max_batch=64,
                                       width=width)
                    x = replay_ms(exact, (Bb, width, gamma),
                                  (np.ascontiguousarray(tables[:, :width]),)
                                  + host[1:])
                    del exact
                    rows.append(dict(arch=arch, Bb=Bb, width=width,
                                     gamma=gamma, launches=n1 - n0,
                                     splits=paged_attention.last_splits,
                                     eager_ms=[e1, e2], replay_ms=[r1, r2],
                                     exact_width_replay_ms=x))
        for n in PAD_BATCHES:
            for gamma in range(4):
                Bb, own = g.bucket(n), bucket_size(n)
                assert Bb > own, (n, Bb, own)
                tables, lengths, last = inputs(n, Bb, widths[-1], W, gamma)
                host = be._graph_inputs(tables, lengths, last, gamma)
                padded = replay_ms(g, (Bb, W, gamma), host)
                exact = StepGraphs(CudaGraph, be.device, max_batch=64,
                                   width=W)
                x = replay_ms(exact, (own, W, gamma), be._graph_inputs(
                    tables[:own], lengths[:own], last[:own], gamma))
                del exact
                pads.append(dict(arch=arch, rows=n, bucket=Bb, own=own,
                                 gamma=gamma, replay_ms=padded,
                                 own_bucket_replay_ms=x))
        emit("decode_graphs_arch", arch=arch, width=W,
             capture_steps_s=capture_s, keys=4 * 4, replays=g.replays,
             rows=[r for r in rows if r["arch"] == arch],
             batch_padding=[r for r in pads if r["arch"] == arch])
        del be, g
    emit("decode_graphs", keys=len(rows), tokens_equal=True,
         launches_equal=True,
         # medians over each arch's keys: eager ms / replayed ms; the
         # served width's replay / one at the tables' own width, by
         # context width; a batch's replay in the bucket it pads to / in
         # its own power-of-two bucket, by rows
         eager_over_replay={a: statistics.median(
             sum(r["eager_ms"]) / sum(r["replay_ms"])
             for r in rows if r["arch"] == a) for a in GRAPH_WIDTHS},
         padded_over_exact={a: {w: statistics.median(
             sum(r["replay_ms"]) / sum(r["exact_width_replay_ms"])
             for r in rows if r["arch"] == a and r["width"] == w)
             for w in ws} for a, ws in GRAPH_WIDTHS.items()},
         bucket_over_own={a: {n: statistics.median(
             sum(r["replay_ms"]) / sum(r["own_bucket_replay_ms"])
             for r in pads if r["arch"] == a and r["rows"] == n)
             for n in PAD_BATCHES} for a in GRAPH_WIDTHS},
         seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return rows


def graph_counts(backend):
    """A backend's step graphs: captures, replays and keys held."""
    g = backend._graphs
    return None if g is None else {"captures": g.captures,
                                   "replays": g.replays,
                                   "keys": len(g.entries)}


def phase_moe_serve(torch):
    counts, fields = serve_pair(torch, GRANITE, count_drops=True)
    emit("moe_serve", **fields)
    return counts


def phase_vlm_serve(torch):
    """paligemma's pair serves text, as the reference's real tier does."""
    counts, fields = serve_pair(torch, PALIGEMMA)
    emit("vlm_serve", **fields)
    return counts


def phase_moe_lossless(torch):
    """tests/test_spec_engine.py's losslessness on the card: granite at
    full width and 4 layers, fp32 with TF32 off, capacity factor 8.0 as the
    reference's reduced() sets it.  The greedy streams under AR, fixed-2,
    Nightjar and Nightjar with the target as its own draft (which accepts)
    are equal token for token, served with step graphs on (the pure-decode
    and spec steps replay); each run is served once more on the eager
    path under a :class:`DropCounter` (which counts in Python, so it turns
    the graphs off), to the same streams, with no slot dropped."""
    from repro_torch import configs
    from repro_torch.launch.serve import build_real_engine
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(GRANITE).replace(
        num_layers=4, dtype="float32", moe_capacity_factor=8.0)
    dcfg = configs.get_draft_config(GRANITE).replace(dtype="float32")
    params = (registry.get_model(cfg).init(device="cuda", seed=1),
              registry.get_model(dcfg).init(device="cuda", seed=2))
    runs = (("ar", "ar", dcfg, params), ("fixed-2", "fixed-2", dcfg, params),
            ("nightjar", "nightjar", dcfg, params),
            ("nightjar, draft = target", "nightjar", cfg,
             (params[0], params[0])))
    out, accepted, drops = {}, {}, {}
    for name, policy, draft_cfg, pair in runs:
        def engine():
            return build_real_engine(cfg, draft_cfg, device="cuda",
                                     policy=policy, prefix_caching=True,
                                     chunk_tokens=16, seed=0, params=pair)
        eng, reqs = engine(), requests(cfg.vocab_size)
        reset_counts()
        m = eng.run(reqs, max_steps=5000, record_timeline=True)
        counts = read_counts()
        out[name] = streams(eng, reqs)
        check_run(m, reqs, out[name], cfg.vocab_size)
        graphs = graph_counts(eng.backend)
        assert graphs["replays"] > 0, graphs
        accepted[name] = sum(g["accepted"] for gam, g in
                             m.spec.get("per_gamma", {}).items() if gam > 0)
        if policy != "ar":
            assert m.spec.get("spec_steps", 0) >= 1, m.spec
        del eng
        eng, reqs = engine(), requests(cfg.vocab_size)
        with DropCounter(torch, eng.backend) as dc:
            eng.run(reqs, max_steps=5000)
        eager = streams(eng, reqs)
        drops[name] = dc.summary()
        assert all(v["dropped"] == 0 for v in drops[name].values()), drops
        assert eager == out[name], f"{name}: eager stream != replayed"
        emit("moe_lossless_run", run=name, spec=m.spec_summary(),
             accepted_tokens=accepted[name], launches=counts, graphs=graphs,
             dropped_slots=drops[name])
        del eng
    assert accepted["nightjar, draft = target"] > 0, accepted
    for name in out:
        assert out[name] == out["ar"], f"fp32 {name} stream != AR stream"
    emit("moe_lossless", model=f"{GRANITE} full width, {cfg.num_layers} "
         f"target + {dcfg.num_layers} draft layers, fp32, TF32 off, "
         f"capacity factor 8.0", requests=len(out["ar"]), equal=True,
         runs=list(out), accepted_tokens=accepted)
    del params
    torch.cuda.empty_cache()


def vlm_prefix_check(torch, cfg, params):
    """B = 2: ``prefill`` of 256 seeded image rows + 16 text tokens, then 8
    ``decode_step``s; each step's logits against ``forward`` over the whole
    sequence.  Returns (max |difference|, max |forward logit|, prefill ms,
    flash launches of the prefill)."""
    from repro_torch.models import registry
    from repro_torch.models.transformer import unembed
    api = registry.get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    N, S, steps, B = cfg.num_image_tokens, 16, 8, 2
    img = torch.randn((B, N, cfg.d_model), generator=gen, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                        device="cuda")
    api.prefill(params, {"tokens": tok[:, :S], "image_emb": img}, N + S)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lg, cache = api.prefill(params, {"tokens": tok[:, :S],
                                     "image_emb": img}, N + S + steps)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    flash = read_counts()["flash_attention"]
    assert flash == cfg.num_layers, flash
    got = [lg[:, 0]]
    for t in range(S, S + steps - 1):
        lg, cache = api.decode_step(params, cache, tok[:, t:t + 1])
        got.append(lg[:, 0])
    got = torch.stack(got, 1)
    h = api.forward(params, {"tokens": tok[:, :S + steps - 1],
                             "image_emb": img})
    want = unembed(cfg, params, h[:, N + S - 1:])
    assert got.shape == want.shape == (B, steps, cfg.vocab_size)
    assert torch.isfinite(got).all()
    return ((got - want).abs().max().item(), want.abs().max().item(),
            prefill_ms, flash)


def phase_vlm_prefix(torch):
    """paligemma's image-prefix path: full width and depth in bf16 (the
    difference held within 5 % of the largest logit: 18 layers of bf16
    rounding taken in another order), and 4 layers in fp32 with TF32 off
    (1e-4, as tests/test_decode_equivalence.py holds it)."""
    from repro_torch import configs
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = configs.get_config(PALIGEMMA)
    out = {}
    for name, cfg in (("bf16", base.replace(dtype="bfloat16")),
                      ("fp32", base.replace(num_layers=4,
                                            dtype="float32"))):
        params = registry.get_model(cfg).init(device="cuda", seed=4)
        err, scale, ms, flash = vlm_prefix_check(torch, cfg, params)
        limit = 0.05 * scale if name == "bf16" else 1e-4
        assert err <= limit, (name, err, limit)
        out[name] = {"layers": cfg.num_layers, "max_abs_err": err,
                     "limit": limit, "max_abs_logit": scale,
                     "prefill_ms": ms, "flash_launches_head_dim_256": flash}
        del params
        torch.cuda.empty_cache()
    emit("vlm_prefix", model=f"{PALIGEMMA}, B=2, 256 image rows + 16 text "
         f"tokens, then 8 decode steps", **out)
    return out["bf16"]["flash_launches_head_dim_256"]



# ---------------------------------------------------------------------------
# phases 14-17: the O(1)-state families
# ---------------------------------------------------------------------------


def phase_ssm_serve(torch):
    """The mamba2-780m pair through ``build_real_engine`` (ssm target and
    draft: ``DenseSlotBackend``).  No attention anywhere, so no kernel of
    the port may launch.  Then the draft's ``prefill`` at B = 8 and 512
    tokens (two SSD chunks, so the inter-chunk recurrence runs) and at 300
    tokens (above the chunk of 256 and not a multiple of it: the scan pads
    the tail, ROADMAP C9): the work of a catch-up, host clock between
    synchronises, median of five after a warm-up call.  The padded length
    is also held, in fp32 at 2 layers, against the same prefill at a chunk
    that divides it (100)."""
    from repro_torch import configs
    from repro_torch.models import registry
    counts, fields = serve_pair(torch, MAMBA2)
    assert fields["backend"] == "DenseSlotBackend", fields["backend"]
    assert not any(counts.values()), counts
    dcfg = configs.get_draft_config(MAMBA2).replace(dtype="bfloat16")
    api = registry.get_model(dcfg)
    params = api.init(device="cuda", seed=2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for delta in (512, 300):
        batch = {"tokens": torch.randint(0, dcfg.vocab_size, (8, delta),
                                         generator=gen, device="cuda")}
        api.prefill(params, batch)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = api.prefill(params, batch)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        assert torch.isfinite(lg).all() and torch.isfinite(cache["ssm"]).all()
        fields[f"draft_prefill_B8_delta{delta}_ms"] = sorted(ts)[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut = dcfg.replace(num_layers=2, dtype="float32")
    p32 = registry.get_model(cut).init(device="cuda", seed=3)
    lgs = [registry.get_model(cut.replace(ssm_chunk=c)).prefill(
        p32, batch)[0] for c in (cut.ssm_chunk, 100)]
    err = (lgs[0] - lgs[1]).abs().max().item()
    assert err <= 1e-3, err
    fields["delta300_padded_vs_chunk100_max_abs_err"] = err
    emit("ssm_serve", **fields)
    del params, cache, p32
    torch.cuda.empty_cache()
    return counts


def phase_hybrid_serve(torch):
    """The zamba2-1.2b pair (hybrid target, ssm draft) through
    ``build_real_engine`` → ``DenseSlotBackend``: every target prompt runs
    the shared attention block's flash call at each of its six points."""
    from repro_torch import configs
    from repro_torch.models.hybrid import attn_points
    counts, fields = serve_pair(torch, ZAMBA2)
    assert fields["backend"] == "DenseSlotBackend", fields["backend"]
    points = len(attn_points(configs.get_config(ZAMBA2)))
    assert points == 6, points
    assert counts["flash_attention"] >= points * fields["prompts"], counts
    assert counts["paged_attention"] == counts["migrate_blocks"] == 0, \
        counts
    emit("hybrid_serve", **fields)
    return counts


class FlashKinds:
    """Counts the flash calls of ``models.common.blockwise_attention`` by
    kind — ``causal``, ``non-causal Sq == Sk`` (an encoder) and
    ``non-causal Sq != Sk`` (a cross-attention) — by swapping the module's
    ``flash_attention`` for a wrapper that tallies and calls through; the
    kernel's own ``launches`` count is untouched."""

    def __init__(self):
        from repro_torch.models import common
        self.common, self.orig, self.kinds = common, common.flash_attention, {}

    def __enter__(self):
        def tally(q, k, v, *, causal, prefix_len=0):
            kind = ("causal" if causal else "non-causal Sq == Sk"
                    if q.shape[1] == k.shape[1] else "non-causal Sq != Sk")
            self.kinds[kind] = self.kinds.get(kind, 0) + 1
            return self.orig(q, k, v, causal=causal, prefix_len=prefix_len)
        self.common.flash_attention = tally
        return self

    def __exit__(self, *exc):
        self.common.flash_attention = self.orig


def encdec_check(torch, cfg, params):
    """B = 2: ``prefill`` of 1,500 seeded frame embeddings and 16 tokens,
    then 8 ``decode_step``s; each step's logits against ``forward`` over
    the whole sequence.  Returns (max |difference|, max |forward logit|,
    prefill ms, flash launches of the prefill, by kind)."""
    from repro_torch.models import registry
    from repro_torch.models.common import tied_unembed
    api = registry.get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(6)
    S, steps, B = 16, 8, 2
    enc = torch.randn((B, cfg.enc_context, cfg.d_model), generator=gen,
                      device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                        device="cuda")
    batch = {"tokens": tok[:, :S], "enc_emb": enc}
    api.prefill(params, batch, S + steps)
    torch.cuda.synchronize()
    reset_counts()
    with FlashKinds() as fk:
        t0 = time.perf_counter()
        lg, cache = api.prefill(params, batch, S + steps)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    flash = read_counts()["flash_attention"]
    want_kinds = {"causal": cfg.dec_layers,
                  "non-causal Sq == Sk": cfg.enc_layers,
                  "non-causal Sq != Sk": cfg.dec_layers}
    assert fk.kinds == want_kinds, fk.kinds
    assert flash == sum(want_kinds.values()), flash
    got = [lg[:, 0]]
    for t in range(S, S + steps - 1):
        lg, cache = api.decode_step(params, cache, tok[:, t:t + 1])
        got.append(lg[:, 0])
    got = torch.stack(got, 1)
    h = api.forward(params, {"tokens": tok[:, :S + steps - 1],
                             "enc_emb": enc})
    want = tied_unembed(params, h[:, S - 1:])
    assert got.shape == want.shape == (B, steps, cfg.vocab_size)
    assert torch.isfinite(got).all()
    return ((got - want).abs().max().item(), want.abs().max().item(),
            prefill_ms, flash, fk.kinds)


def phase_encdec_prefix(torch):
    """whisper-medium at model level (the engine serves no audio, as in the
    reference): full width and depth (24 + 24) in bf16, held within 5 % of
    the largest logit, and 4 + 4 layers in fp32 with TF32 off within 1e-4.
    Every full-depth prefill runs 24 encoder, 24 causal self-attention and
    24 cross-attention flash calls."""
    from repro_torch import configs
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = configs.get_config(WHISPER)
    out = {}
    for name, cfg in (("bf16", base.replace(dtype="bfloat16")),
                      ("fp32", base.replace(enc_layers=4, dec_layers=4,
                                            dtype="float32"))):
        params = registry.get_model(cfg).init(device="cuda", seed=7)
        err, scale, ms, flash, kinds = encdec_check(torch, cfg, params)
        limit = 0.05 * scale if name == "bf16" else 1e-4
        assert err <= limit, (name, err, limit)
        out[name] = {"layers": [cfg.enc_layers, cfg.dec_layers],
                     "max_abs_err": err, "limit": limit,
                     "max_abs_logit": scale, "prefill_ms": ms,
                     "flash_launches": flash, "flash_by_kind": kinds}
        del params
        torch.cuda.empty_cache()
    emit("encdec_prefix", model=f"{WHISPER}, B=2, 1,500 frame embeddings + "
         f"16 tokens, then 8 decode steps", **out)
    return out["bf16"]["flash_launches"]


def phase_ssm_lossless(torch):
    """tests/test_spec_engine.py's SSM case on the card, fp32 with TF32 off
    through ``build_real_engine`` → ``DenseSlotBackend``: mamba2 at 4 + 4
    layers under AR, fixed-2, Nightjar and Nightjar with the target as its
    own draft (which accepts, so checkpoint indices above 0 are taken);
    zamba2 at 6 layers (one shared-attention point) with its 4-layer ssm
    draft under AR, fixed-2 and Nightjar (a hybrid draft is refused, as in
    the reference).  Each pair's greedy streams are equal."""
    from repro_torch import configs
    from repro_torch.launch.serve import build_real_engine
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuts = ((MAMBA2, 4, 4), (ZAMBA2, 6, 4))
    summary = {}
    for arch, tl, dl in cuts:
        cfg = configs.get_config(arch).replace(num_layers=tl, dtype="float32")
        dcfg = configs.get_draft_config(arch).replace(num_layers=dl,
                                                      dtype="float32")
        params = (registry.get_model(cfg).init(device="cuda", seed=1),
                  registry.get_model(dcfg).init(device="cuda", seed=2))
        runs = [("ar", "ar", dcfg, params),
                ("fixed-2", "fixed-2", dcfg, params),
                ("nightjar", "nightjar", dcfg, params)]
        if cfg.family == "ssm":
            runs.append(("nightjar, draft = target", "nightjar", cfg,
                         (params[0], params[0])))
        out, accepted = {}, {}
        for name, policy, draft_cfg, pair in runs:
            engine = build_real_engine(cfg, draft_cfg, device="cuda",
                                       policy=policy, seed=0, params=pair)
            reqs = requests(cfg.vocab_size)
            reset_counts()
            m = engine.run(reqs, max_steps=5000, record_timeline=True)
            counts = read_counts()
            out[name] = streams(engine, reqs)
            check_run(m, reqs, out[name], cfg.vocab_size)
            accepted[name] = sum(g["accepted"] for gam, g in
                                 m.spec.get("per_gamma", {}).items()
                                 if gam > 0)
            if policy != "ar":
                assert m.spec.get("spec_steps", 0) >= 1, m.spec
            emit("ssm_lossless_run", model=arch, run=name,
                 spec=m.spec_summary(), accepted_tokens=accepted[name],
                 launches=counts)
            del engine
        if cfg.family == "ssm":
            assert accepted["nightjar, draft = target"] > 0, accepted
        for name in out:
            assert out[name] == out["ar"], f"fp32 {arch} {name} != AR"
        summary[arch] = {"target_layers": tl, "draft_layers": dl,
                         "runs": list(out), "accepted_tokens": accepted}
        del params
        torch.cuda.empty_cache()
    emit("ssm_lossless", model="fp32, TF32 off, full width, cut depth",
         requests=8, equal=True, **summary)

# ---------------------------------------------------------------------------
# phases 18-19: the disaggregated prefill -> decode handoff
# ---------------------------------------------------------------------------


class HandoffClock:
    """Times ``export_handoff`` on a prefill replica's backend and
    ``import_handoff`` on a decode replica's (host clock around a
    synchronise on each side) and counts the bytes each moves.  Takes its
    wrappers off the backends on exit, so no backend keeps a wrapper of its
    own bound method."""

    def __init__(self, torch, src_be, dst_be):
        self.torch, self.src_be, self.dst_be = torch, src_be, dst_be
        self.export, self.imported = {}, {}   # req_id -> (ms, bytes)

    @staticmethod
    def payload_bytes(kv):
        return sum(a.nbytes for pool in ("tkv", "dkv")
                   for a in kv.get(pool, {}).values())

    def _timed(self, fn, log, kv_of):
        sync = self.torch.cuda.synchronize

        def wrapper(seq, *args):
            sync()
            t0 = time.perf_counter()
            out = fn(seq, *args)
            sync()
            log[seq.req_id] = ((time.perf_counter() - t0) * 1e3,
                               self.payload_bytes(kv_of(out, args)))
            return out
        return wrapper

    def __enter__(self):
        self.src_be.export_handoff = self._timed(
            self.src_be.export_handoff, self.export, lambda out, a: out)
        self.dst_be.import_handoff = self._timed(
            self.dst_be.import_handoff, self.imported,
            lambda out, a: a[0]["kv"])
        return self

    def __exit__(self, *exc):
        del self.src_be.export_handoff, self.dst_be.import_handoff


def handoff_run(torch, src, dst, reqs, trace=None, *, max_steps=5000):
    """The reference's disaggregated flow (tests/test_disagg.py:369-378) on
    two engines: submit to ``src``, step it, hand every fully prefilled,
    not yet decoded sequence to ``dst``, then run ``dst`` to the end.  With
    ``trace`` (one recorder for both engines, as a cluster shares one) each
    handoff opens the request's ``transfer`` stage on ``src`` as the
    cluster does; the KV is ready at ``src``'s clock.  Returns ``dst``'s
    metrics, each payload's ``n_blocks``, the decode run's wall seconds
    and the kernel launches of ``dst``'s run alone."""
    for r in reqs:
        src.submit(r)
    n_blocks = {}
    for _ in range(max_steps):
        if not src.has_work():
            break
        src.step()
        for seq in list(src.scheduler.running):
            if seq.prompt_remaining == 0 and not seq.done \
                    and seq.generated == 0:
                payload = src.extract_for_handoff(seq)
                n_blocks[seq.req_id] = payload["kv"]["n_blocks"]
                if trace is not None:
                    trace.req_stage(seq.req_id, src.clock, "transfer",
                                    src.replica_id)
                dst.accept_handoff(seq.request, t_ready=src.clock,
                                   payload=payload)
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = dst.run([], max_steps=max_steps, record_timeline=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = read_counts()
    return m, n_blocks, wall, {k: after[k] - before[k] for k in after}


def span_balance(trace):
    """tests/test_observability.py's span balance on a trace: for each
    finished request, its stage spans sum to its end-to-end latency (to
    1e-6 s).  Returns the number of requests checked."""
    subs, ends, spans = {}, {}, {}
    for ln in trace.jsonl_lines():
        e = json.loads(ln)
        rid = e.get("req")
        if rid is None or e["cat"] != "request":
            continue
        if e["ph"] == "X":
            spans[rid] = spans.get(rid, 0.0) + e["dur"]
        elif e["name"] == "submit":
            subs[rid] = e["t"]
        elif e["name"] == "finished":
            ends[rid] = e["t"]
    for rid, t_end in ends.items():
        e2e = t_end - subs[rid]
        assert abs(spans[rid] - e2e) <= 1e-6, (rid, spans[rid], e2e)
    assert not trace.open_spans(), trace.open_spans()
    return len(ends)


def disagg_pair(params, cfg, dcfg, policy, trace=None):
    """A prefill replica (id 0) and a decode replica (id 1):
    ``build_real_engine`` on the same weights with a chunk budget of 16
    (a migration candidate exists only on the chunked path), without the
    elastic memory manager (its draft offload on one replica would move
    weights the other still reads) or a prefix cache."""
    from repro_torch.launch.serve import build_real_engine
    pair = []
    for rid in (0, 1):
        eng = build_real_engine(cfg, dcfg, device="cuda", params=params,
                                memmgr=False, chunk_tokens=16,
                                policy=policy, seed=0)
        eng.replica_id = rid
        if trace is not None:
            eng.attach_trace(trace)
        pair.append(eng)
    return pair


def phase_disagg_serve(torch, params, colocated):
    """Disaggregated serving of the full-width bf16 paper-7b pair on the
    serve's weights: the serve's eight requests prefill on one replica,
    their KV blocks (both pools) travel through host numpy
    (``export_handoff`` -> ``import_handoff``), and a second replica
    decodes them on the paged-attention kernel.  Then one 192-token
    prompt (24 blocks of 8) the same way, large enough to read a
    bandwidth, printed beside the simulator's price for it under the
    H100 profile.  Both replicas share one trace recorder; the trace is
    span-balanced and written under build/traces/."""
    from repro_torch import configs
    from repro_torch.serving.costmodel import H100_SXM, RooflineCostModel
    from repro_torch.serving.observability import TraceRecorder
    from repro_torch.serving.simulator import SimulatedBackend
    from repro_torch.serving.workload import tiny_requests
    cfg = configs.get_config("paper-7b").replace(dtype="bfloat16")
    dcfg = configs.get_draft_config("paper-7b").replace(dtype="bfloat16")
    trace = TraceRecorder()
    src, dst = disagg_pair(params, cfg, dcfg, "nightjar", trace)
    reqs = requests(cfg.vocab_size)
    with HandoffClock(torch, src.backend, dst.backend) as clock:
        reset_counts()
        m, n_blocks, wall, dst_counts = handoff_run(torch, src, dst, reqs,
                                                    trace)
        outs = streams(dst, reqs)
        check_run(m, reqs, outs, cfg.vocab_size)
        assert all(n > 0 for n in n_blocks.values()), n_blocks
        assert (dst.handoffs_in, dst.handoffs_refused) == (8, 0), \
            (dst.handoffs_in, dst.handoffs_refused)
        long_req = tiny_requests(1, prompt_len=192, output_len=16,
                                 vocab=cfg.vocab_size, seed=7)[0]
        long_req.req_id, long_req.arrival = len(reqs), src.clock
        m_long, nb_long, _, long_dst = handoff_run(torch, src, dst,
                                                   [long_req], trace)
        path = read_counts()
    # the decode replica ran its decode and verify steps on the kernel
    assert dst_counts["paged_attention"] > 0, dst_counts
    assert long_dst["paged_attention"] > 0, long_dst
    assert nb_long[long_req.req_id] == 24, nb_long
    assert len(m_long.requests) == 1 and dst.handoffs_in == 9
    balanced = span_balance(trace)
    assert balanced == 9, balanced
    out_dir = ROOT / "build" / "traces"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace.export(str(out_dir / "disagg_serve.jsonl"), fmt="jsonl")
    trace.export(str(out_dir / "disagg_serve.json"), fmt="chrome")
    per_request = {rid: {"export_ms": clock.export[rid][0],
                         "import_ms": clock.imported[rid][0],
                         "bytes": clock.export[rid][1],
                         "n_blocks": (n_blocks | nb_long)[rid]}
                   for rid in sorted(clock.export)}
    big = per_request[long_req.req_id]
    sim = SimulatedBackend(cfg, dcfg, RooflineCostModel(H100_SXM))
    equal = sum(a == b for r in reqs
                for a, b in zip(outs[r.req_id], colocated[r.req_id]))
    emit("disagg_serve", model="paper-7b full width and depth, bf16, "
         "prefill replica -> decode replica", handoffs=dst.handoffs_in,
         handoffs_refused=dst.handoffs_refused, per_request=per_request,
         long_prompt_tokens=192,
         export_gb_per_s=big["bytes"] / big["export_ms"] / 1e6,
         import_gb_per_s=big["bytes"] / big["import_ms"] / 1e6,
         sim_kv_transfer_ms_h100_sxm=1e3 * sim.kv_transfer_seconds(192),
         sim_host_link_bw=H100_SXM.host_link_bw,
         decode_wall_s=wall, decode_output_tokens=m.total_tokens,
         decode_tokens_per_s=m.total_tokens / wall,
         decode_spec_steps=m.spec.get("spec_steps", 0),
         trace_events=len(trace.events),
         trace_events_by_replica={
             rid: sum(1 for e in trace.events if e["pid"] == rid)
             for rid in (0, 1)},
         span_balanced_requests=balanced,
         traces=[str((out_dir / n).relative_to(ROOT)) for n in
                 ("disagg_serve.jsonl", "disagg_serve.json")],
         tokens_equal_to_colocated_serve=equal,
         tokens_compared=sum(len(outs[r.req_id]) for r in reqs),
         launches=path, decode_replica_launches={
             k: dst_counts[k] + long_dst[k] for k in path})
    del src, dst
    torch.cuda.empty_cache()
    return path


def phase_disagg_lossless(torch, params):
    """tests/test_disagg.py's real-tier contract on the card, fp32 with
    TF32 off at cut depth: under AR and under Nightjar, the streams of
    requests prefilled on one replica and decoded on another equal a
    colocated run's, token for token (and AR's)."""
    from repro_torch.launch.serve import build_real_engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dcfg = fp32_cut()
    out = {}
    for policy in ("ar", "nightjar"):
        colo = build_real_engine(cfg, dcfg, device="cuda", params=params,
                                 memmgr=False, chunk_tokens=16,
                                 policy=policy, seed=0)
        reqs = requests(cfg.vocab_size)
        m = colo.run(reqs, max_steps=5000)
        out[f"{policy} colocated"] = streams(colo, reqs)
        check_run(m, reqs, out[f"{policy} colocated"], cfg.vocab_size)
        del colo
        src, dst = disagg_pair(params, cfg, dcfg, policy)
        reqs = requests(cfg.vocab_size)
        reset_counts()
        m, n_blocks, _, dst_counts = handoff_run(torch, src, dst, reqs)
        counts = read_counts()
        out[f"{policy} migrated"] = streams(dst, reqs)
        check_run(m, reqs, out[f"{policy} migrated"], cfg.vocab_size)
        assert all(n > 0 for n in n_blocks.values()), n_blocks
        assert dst.handoffs_in == 8 and dst_counts["paged_attention"] > 0
        emit("disagg_lossless_run", policy=policy, handoffs=dst.handoffs_in,
             spec=m.spec_summary(), launches=counts)
        del src, dst
    for name in out:
        assert out[name] == out["ar colocated"], f"fp32 {name} != AR"
    emit("disagg_lossless", model=f"paper-7b full width, {cfg.num_layers} "
         f"target + {dcfg.num_layers} draft layers, fp32, TF32 off",
         requests=8, equal=True, runs=list(out))


# ---------------------------------------------------------------------------
# phases 20-23: training
# ---------------------------------------------------------------------------

# the draft's attention in a training step of 2 x 4,096 tokens, and
# granite's in the CLI's 2 x 1,024: (B, Sq, Sk, H, KH, D, causal, prefix_len)
TRAIN_ATTN = (2, 4096, 4096, 14, 2, 64, True, 0)
GRANITE_TRAIN_ATTN = (2, 1024, 1024, 16, 8, 64, True, 0)
# paligemma-3b's training step (256 image rows + 768 text, MQA) and
# gemma-7b's --reduced CLI step
VLM_TRAIN_ATTN = (2, 1024, 1024, 8, 1, 256, True, 256)
REDUCED_TRAIN_ATTN = (8, 128, 128, 4, 4, 32, True, 0)
# flash backward checks: every FLASH_CASES row (D 32 / 64 / 128), the
# head_dim-256 rows (paligemma's MQA image prefix, gemma-7b's MHA, ragged
# and non-causal corners), the four training shapes, a prefix and a
# non-causal Sq != Sk
FLASH_GRAD_CASES = (FLASH_CASES + FLASH_256_CASES
                    + [TRAIN_ATTN, GRANITE_TRAIN_ATTN, VLM_TRAIN_ATTN,
                       REDUCED_TRAIN_ATTN,
                       (1, 512, 512, 14, 2, 64, True, 300),
                       (2, 100, 700, 14, 2, 64, False, 0)])
# flash backward timings (bf16, causal): label, B, S, H, KH, D, prefix_len —
# the draft's and granite's training steps, paligemma-3b's (256 image rows
# + 768 text tokens, MQA), deepseek-7b's heads at train_4k and gemma-7b's
# --reduced CLI step (head_dim 32)
FLASH_GRAD_TIMED = [
    ("draft training step", 2, 4096, 14, 2, 64, 0),
    ("granite training step", 2, 1024, 16, 8, 64, 0),
    ("paligemma training step", 2, 1024, 8, 1, 256, 256),
    ("deepseek-7b heads, train_4k", 1, 4096, 32, 32, 128, 0),
    ("gemma-7b --reduced CLI step", 8, 128, 4, 4, 32, 0)]
GRAD_ATOL = 2e-4   # fp32: a gradient sums over every key (forward: 2e-5)
GRAD_REL = 1e-2    # bf16: ||kernel - plain|| / ||plain||
LSE_ATOL = 2e-5
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
CLI_ARGS = ["--arch", GRANITE, "--steps", "3", "--batch", "2", "--seq",
            "1024"]
# the reference's documented invocation (src/repro/launch/train.py), on the
# card: every --reduced config has head_dim 32
CLI_REDUCED_ARGS = ["--arch", "gemma-7b", "--reduced"]
VLM_TEXT = 768   # paligemma's text tokens a sequence, after 256 image rows


def flash_bwd_bound(B, S, H, KH, D, es, prefix_len=0):
    """Least time of the causal backward: 2.5 times the forward's flops (4 D
    per visible (query, key) pair and head; query i sees max(i + 1,
    prefix_len) keys) over the bf16 peak, against q, k, v, o, dO and the
    log-sum-exp read once and dq, dk, dv written once over HBM
    bandwidth."""
    from repro_torch.kernels.flash_attention import attention_pairs
    pairs = attention_pairs(S, S, True, prefix_len)
    flops = 2.5 * 4 * B * H * D * pairs
    nbytes = es * B * S * D * (4 * H + 4 * KH) + 4 * B * H * S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_flash_grad(torch):
    """The backward kernel against ``flash_attention_bwd_ref`` and the
    log-sum-exp forward against the plain log-sum-exp on FLASH_GRAD_CASES
    (every head_dim), fp32 (TF32 off) and bf16, and two launches on the
    same inputs equal to the bit; then the backward timed at
    FLASH_GRAD_TIMED beside its bound, its plain version and SDPA's
    backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_lse_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8)

    def inputs(B, Sq, Sk, H, KH, D, dtype):
        """q, k, v and an incoming gradient dO."""
        return [torch.randn(s, generator=gen, device="cuda").to(dtype)
                for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D),
                          (B, Sq, H, D))]

    def grads(dtype, B, Sq, Sk, H, KH, D, causal, prefix):
        q, k, v, do = inputs(B, Sq, Sk, H, KH, D, dtype)
        o, lse = _forward(q, k, v, causal, prefix, with_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  prefix_len=prefix)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    prefix_len=prefix)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       prefix_len=prefix)
        _, want_lse = flash_attention_lse_ref(q, k, v, causal=causal,
                                              prefix_len=prefix)
        torch.cuda.synchronize()
        lse_err = (lse - want_lse).abs().max().item()
        abs_err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
        rel_err = max(((g.float() - w.float()).norm()
                       / w.float().norm()).item() for g, w in zip(got, want))
        assert all(torch.isfinite(g).all() for g in got)
        assert all(torch.equal(g, a) for g, a in zip(got, again)), \
            ("not deterministic", dtype, B, Sq, Sk, H, KH, D)
        return (q, k, v, do, o, lse, want), lse_err, abs_err, rel_err

    worst = {}
    for dtype_name in ("float32", "bfloat16"):
        w = worst[dtype_name] = {"lse_max_abs_err": 0.0,
                                 "grad_max_abs_err": 0.0,
                                 "grad_max_rel_err": 0.0}
        for case in FLASH_GRAD_CASES:
            _, lse_err, abs_err, rel_err = grads(getattr(torch, dtype_name),
                                                 *case)
            assert lse_err <= LSE_ATOL, (dtype_name, case, lse_err)
            if dtype_name == "float32":
                assert abs_err <= GRAD_ATOL, (case, abs_err)
            else:
                assert rel_err <= GRAD_REL, (case, rel_err)
            for key, x in zip(w, (lse_err, abs_err, rel_err)):
                w[key] = max(w[key], x)
            torch.cuda.empty_cache()
    emit("check", kernel="flash_attention_bwd",
         cases=2 * len(FLASH_GRAD_CASES),
         head_dims=sorted({c[5] for c in FLASH_GRAD_CASES}),
         lse_atol=LSE_ATOL, grad_atol_float32=GRAD_ATOL,
         grad_rel_bfloat16=GRAD_REL, deterministic=True, worst=worst)

    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    rows = []
    for label, B, S, H, KH, D, prefix in FLASH_GRAD_TIMED:
        case = (B, S, S, H, KH, D, True, prefix)
        (q, k, v, do, o, lse, want), _, err, rel = grads(torch.bfloat16,
                                                         *case)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        if prefix:   # SDPA takes the prefix-causal mask as a boolean tensor
            pos = torch.arange(S, device="cuda")
            lib_kw = dict(attn_mask=(pos[:, None] >= pos[None, :])
                          | (pos[None, :] < prefix))
        else:
            lib_kw = dict(is_causal=True)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                 **lib_kw)
        lib = torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                  retain_graph=True)
        lib_rel = max(((g.transpose(1, 2).float() - w.float()).norm()
                       / w.float().norm()).item()
                      for g, w in zip(lib, want))
        assert rel <= GRAD_REL, (label, rel)
        assert lib_rel <= GRAD_REL, (label, lib_rel)
        bound, by = flash_bwd_bound(B, S, H, KH, D, q.element_size(), prefix)
        kw = dict(causal=True, prefix_len=prefix)
        rows.append(dict(
            shape=f"{label}: B={B} S={S} H={H} KH={KH} D={D} causal"
            + (f" prefix_len={prefix}" if prefix else ""),
            max_abs_err=err, rel_err=rel, sdpa_rel_err=lib_rel,
            ms=cuda_ms(torch, lambda: flash_attention_bwd(
                q, k, v, o, lse, do, **kw), flush=flush),
            plain_ms=cuda_ms(torch, lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, **kw), flush=flush, iters=3),
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True),
                flush=flush),
            bound_ms=bound, bound_by=by,
            forward_ms=cuda_ms(torch, lambda: flash_attention(q, k, v, **kw),
                               flush=flush),
            forward_with_lse_ms=cuda_ms(torch, lambda: _forward(
                q, k, v, True, prefix, with_lse=True), flush=flush)))
        del q, k, v, do, o, lse, want, qt, kt, vt, dot, lib_out, lib
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    for row in rows:
        emit("time", kernel="flash_attention_bwd", **row)
    err = max(worst["float32"]["grad_max_abs_err"],
              *(r["max_abs_err"] for r in rows))
    return err, rows


def tree_bits_equal(torch, a, b):
    """Two trees (nested dicts / NamedTuples of tensors) hold the same
    bits, leaf by leaf."""
    from repro_torch.training.checkpoint import flatten
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32}
    fa, fb = flatten(a), flatten(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x.view(ints[x.dtype]),
                                           y.view(ints[y.dtype]))
        for x, y in zip(fa, fb))


def kernel_vs_plain_grads(torch, api, params, batch):
    """The loss and gradients of ``api.loss`` with attention through the
    CUDA kernels, then through the plain version (swapped in for
    ``models.common.flash_attention``, as ``FlashKinds`` does).  Returns
    (kernel loss, plain loss, {leaf path: |kernel - plain| / |plain|},
    kernel gradients, the kernel run's launches, the plain run's)."""
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import common
    from repro_torch.training.train_loop import loss_and_grads
    reset_counts()
    loss_k, grads_k = loss_and_grads(api, params, batch)
    torch.cuda.synchronize()
    kernel_counts = read_counts()
    orig = common.flash_attention
    common.flash_attention = flash_attention_ref
    try:
        reset_counts()
        loss_p, grads_p = loss_and_grads(api, params, batch)
        torch.cuda.synchronize()
        plain_counts = read_counts()
    finally:
        common.flash_attention = orig
    assert not any(plain_counts.values()), plain_counts
    rel = {}

    def walk(gk, gp, path):
        if isinstance(gk, dict):
            for key in gk:
                walk(gk[key], gp[key], f"{path}/{key}")
            return
        rel[path] = ((gk - gp).norm() / gp.norm().clamp(min=1e-30)).item()
    walk(grads_k, grads_p, "")
    del grads_p
    return loss_k, loss_p, rel, grads_k, kernel_counts, plain_counts


def phase_train_fp32(torch):
    """The draft at full width (d 896, vocab 152,064) and 2 layers, fp32 with
    TF32 off: the train step's loss and gradients with attention through
    the CUDA kernels equal those through the plain version: loss within
    1e-5, every gradient leaf within 1e-4 of its own norm, and the q / k / v
    projections' gradients nonzero (what the wrapper once dropped).  Then
    one whole ``train_step`` on the kernel path."""
    from repro_torch import configs
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.data import make_batch_iter
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_draft_config("paper-7b").replace(num_layers=2,
                                                       dtype="float32")
    api, step = make_train_step(cfg, base_lr=1e-3, warmup=10)
    params = api.init(device="cuda", seed=4)
    for x in flatten(params):
        x.requires_grad_(True)
    batch = make_batch_iter(cfg.vocab_size, 2, 1024, seed=0,
                            device="cuda")(0)
    loss_k, loss_p, rel, grads_k, kernel_counts, plain_counts = \
        kernel_vs_plain_grads(torch, api, params, batch)
    assert kernel_counts["flash_attention"] == cfg.num_layers, kernel_counts
    assert kernel_counts["flash_attention_bwd"] == cfg.num_layers, \
        kernel_counts
    loss_err = abs(loss_k.item() - loss_p.item())
    assert loss_err <= 1e-5, loss_err
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-4, (worst, rel[worst])
    attn = grads_k["layers"]["attn"]
    norms = {n: attn[n].norm().item() for n in ("wq", "wk", "wv")}
    assert all(x > 0 for x in norms.values()), norms
    m, params, opt = step(params, adamw_init(params), batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    emit("train_fp32", model="paper-7b draft, full width, 2 layers, fp32, "
         "TF32 off, batch 2 x 1,024", loss_kernel=loss_k.item(),
         loss_plain=loss_p.item(), loss_abs_err=loss_err,
         grad_leaves=len(rel), worst_grad_leaf=worst,
         worst_grad_rel_err=rel[worst], attn_grad_norms=norms,
         kernel_launches=kernel_counts, plain_launches=plain_counts,
         train_step={"loss": m["loss"].item(),
                     "grad_norm": m["grad_norm"].item(),
                     "step": int(opt.step)})
    del params, opt, grads_k, m
    torch.cuda.empty_cache()


def phase_train(torch):
    """The training main path: the full-width, full-depth bf16 paper-7b
    draft through ``train()`` on seeded weights and ``SyntheticLM`` batches
    of 2 x 4,096 tokens: 5 steps with a checkpoint at step 5 under build/,
    then a resumed run to step 10.  Prints each step's loss, grad norm,
    device time (CUDA events from the batch's hand-off to the step's end)
    and host batch time; tokens/s, the model-flop share and peak memory;
    checks 24 flash forward and 24 backward launches per step and that the
    resumed run starts from step 5 with the saved state bit for bit."""
    import shutil
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import make_batch_iter
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import train
    cfg = configs.get_draft_config("paper-7b").replace(dtype="bfloat16")
    B, S, steps, half = 2, 4096, 10, 5
    make = make_batch_iter(cfg.vocab_size, B, S, seed=0, device="cuda")
    log = {}

    def batch_iter(step):
        t0 = time.perf_counter()
        batch = make(step)
        log[step] = {"batch_ms": (time.perf_counter() - t0) * 1e3,
                     "start": torch.cuda.Event(enable_timing=True),
                     "before": read_counts()}
        log[step]["start"].record()
        return batch

    def hook(step, metrics):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rec = log[step]
        rec["loss"] = metrics["loss"].item()          # synchronises
        rec["grad_norm"] = metrics["grad_norm"].item()
        rec["step_ms"] = rec.pop("start").elapsed_time(end)
        after, before = read_counts(), rec.pop("before")
        rec["launches"] = {k: after[k] - before[k] for k in after}

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    kw = dict(batch_iter=batch_iter, seed=0, device="cuda",
              checkpoint_dir=str(TRAIN_CKPT), checkpoint_every=half,
              hooks=[hook], base_lr=1e-3, warmup=10)
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = train(cfg, steps=half, **kw)
    peak = torch.cuda.max_memory_allocated()
    specs = registry.param_specs(cfg)
    p5, o5, meta = ckpt.restore_latest(
        str(TRAIN_CKPT), template={"params": specs,
                                   "opt": adamw_init(specs)},
        device="cuda")
    assert meta["step"] == half and int(o5.step) == half, meta
    restored_exact = tree_bits_equal(
        torch, {"p": first["params"], "o": first["opt"]},
        {"p": p5, "o": o5})
    assert restored_exact
    first_s = first["elapsed_s"]
    del first, p5, o5
    torch.cuda.empty_cache()
    second = train(cfg, steps=steps, resume=True, **kw)
    counts = read_counts()
    assert sorted(log) == list(range(steps)), sorted(log)
    assert int(second["opt"].step) == steps
    assert [h["step"] for h in second["history"]] == [steps - 1]
    per_step = {"flash_attention": cfg.num_layers,
                "flash_attention_bwd": cfg.num_layers,
                "paged_attention": 0, "migrate_blocks": 0}
    for i, rec in log.items():
        assert rec["launches"] == per_step, (i, rec["launches"])
        assert math.isfinite(rec["loss"]) and math.isfinite(
            rec["grad_norm"]), (i, rec)
    step_ms = sorted(rec["step_ms"] for rec in log.values())
    med_s = step_ms[len(step_ms) // 2] / 1e3
    tokens = B * S
    n_params = registry.param_count(cfg)
    D = cfg.resolved_head_dim
    attn_fwd = 4 * B * cfg.num_heads * D * (S * (S + 1) // 2) \
        * cfg.num_layers
    flops = 6 * n_params * tokens + 3.5 * attn_fwd
    emit("train", model="paper-7b draft (qwen2.5-0.5B layout), full width "
         "and depth, bf16, SyntheticLM", layers=cfg.num_layers, batch=B,
         seq=S, steps=steps, checkpoint_at=half, params=n_params,
         allocated_before_phase_bytes=allocated_before,
         steps_log=[{"step": i, **log[i]} for i in range(steps)],
         median_step_ms=med_s * 1e3,
         median_batch_ms=sorted(r["batch_ms"] for r in log.values())[
             steps // 2],
         tokens_per_s=tokens / med_s,
         flops_per_step={"6N_tokens": 6 * n_params * tokens,
                         "attention_fwd_bwd": 3.5 * attn_fwd},
         model_flop_share=flops / med_s / PEAK_FLOPS["bfloat16"],
         max_memory_allocated_bytes=peak,
         wall_s={"steps_0_4_with_checkpoints": first_s,
                 "steps_5_9_with_checkpoints": second["elapsed_s"]},
         resumed_from_step=half, restored_bit_exact=restored_exact,
         launches=counts)
    del second
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


# ``python -m repro_torch.launch.train`` as ``-m`` runs it (runpy), then the
# wrappers' launch counts and the peak memory as one JSON line
CLI_CODE = """import json, runpy, sys
sys.argv = ["repro_torch.launch.train"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.train", run_name="__main__",
                 alter_sys=True)
import torch
from repro_torch.kernels.block_migration import migrate_blocks
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_attention import paged_attention
print(json.dumps({"launches": {
    f.__name__: f.launches for f in (paged_attention, migrate_blocks,
                                     flash_attention, flash_attention_bwd)},
    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}))
"""


def run_train_cli(torch, args, steps, layers):
    """``python -m repro_torch.launch.train`` with ``args`` in a subprocess:
    it must exit 0 and print the reference's lines (a step line for every
    10th step and the last, then the final loss) with finite losses, and
    launch the flash forward and backward once a layer a step.  Returns
    (its lines, the losses, its launches and peak, wall seconds)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CLI_CODE, *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    stats = json.loads(lines[-1])
    losses = [float(ln.split()[-1]) for ln in lines[:-2]]
    recorded = sorted({i for i in range(steps) if i % 10 == 0} | {steps - 1})
    assert [ln.split()[:2] for ln in lines[:-2]] == [
        ["step", str(i)] for i in recorded], lines
    assert lines[-2].startswith("final loss "), lines
    assert all(math.isfinite(x) for x in losses), losses
    launches = stats["launches"]
    assert launches["flash_attention"] == steps * layers, launches
    assert launches["flash_attention_bwd"] == steps * layers, launches
    return lines[:-1], losses, stats, wall


def phase_train_cli(torch):
    """The training CLI at full width: granite-moe-1b-a400m, 3 steps of
    2 x 1,024 tokens in a subprocess (``run_train_cli``)."""
    from repro_torch import configs
    cfg = configs.get_config(GRANITE)
    lines, losses, stats, wall = run_train_cli(torch, CLI_ARGS, 3,
                                               cfg.num_layers)
    emit("train_cli", command="python -m repro_torch.launch.train "
         + " ".join(CLI_ARGS), model=f"{GRANITE}, full width and depth, "
         "bf16", output=lines, losses=losses, wall_s=wall,
         max_memory_allocated_bytes=stats["max_memory_allocated_bytes"],
         launches=stats["launches"])
    return stats["launches"]


def phase_train_cli_reduced(torch):
    """The reference's documented training command on the card with its
    defaults (50 steps of 8 x 128 tokens): gemma-7b ``--reduced``, whose
    heads are 32 wide as every reduced config's, through
    ``run_train_cli``."""
    from repro_torch import configs
    cfg = configs.reduced(configs.get_config("gemma-7b"))
    lines, losses, stats, wall = run_train_cli(torch, CLI_REDUCED_ARGS, 50,
                                               cfg.num_layers)
    emit("train_cli_reduced", command="python -m repro_torch.launch.train "
         + " ".join(CLI_REDUCED_ARGS), model="gemma-7b reduced: 2 layers, "
         f"d 128, {cfg.num_heads} / {cfg.num_kv_heads} heads of "
         f"{cfg.resolved_head_dim}, bf16", output=lines, losses=losses,
         wall_s=wall, launches=stats["launches"])
    return stats["launches"]


def vlm_batch_iter(torch, cfg, batch):
    """``it(step)``: SyntheticLM text of VLM_TEXT tokens and seeded image
    embeddings (batch, num_image_tokens, d) in the model's dtype, the
    inputs of paligemma's loss."""
    from repro_torch.training.data import make_batch_iter
    text = make_batch_iter(cfg.vocab_size, batch, VLM_TEXT, seed=0,
                           device="cuda")

    def it(step):
        out = text(step)
        gen = torch.Generator(device="cuda").manual_seed(1000 + step)
        out["image_emb"] = torch.randn(
            (batch, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device="cuda").to(getattr(torch, cfg.dtype))
        return out
    return it


def phase_train_vlm(torch):
    """paligemma-3b's language model trained at full width and depth
    (d 2,048, 18 layers, 8 / 1 heads of 256, GeGLU, vocab 257,216, bf16)
    through ``train()``: 3 steps of 2 sequences of 256 seeded image rows
    and 768 text tokens, so every layer's attention is MQA with the
    bidirectional prefix of 256.  Prints each step's loss, device ms and
    launches (18 flash forward and 18 backward), tokens/s and peak memory.
    Then fp32 at 4 layers (TF32 off): the loss and every gradient leaf with
    attention through the kernels within 1e-5 / 1e-4 of the plain
    version's."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.train_loop import train
    cfg = configs.get_config(PALIGEMMA).replace(dtype="bfloat16")
    B, steps = 2, 3
    make = vlm_batch_iter(torch, cfg, B)
    log = {}

    def batch_iter(step):
        batch = make(step)
        log[step] = {"start": torch.cuda.Event(enable_timing=True),
                     "before": read_counts()}
        log[step]["start"].record()
        return batch

    def hook(step, metrics):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rec = log[step]
        rec["loss"] = metrics["loss"].item()          # synchronises
        rec["grad_norm"] = metrics["grad_norm"].item()
        rec["step_ms"] = rec.pop("start").elapsed_time(end)
        after, before = read_counts(), rec.pop("before")
        rec["launches"] = {k: after[k] - before[k] for k in after}

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = train(cfg, steps=steps, batch_iter=batch_iter, seed=0,
                device="cuda", hooks=[hook], base_lr=1e-3, warmup=10)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    per_step = {"flash_attention": cfg.num_layers,
                "flash_attention_bwd": cfg.num_layers,
                "paged_attention": 0, "migrate_blocks": 0}
    for i, rec in log.items():
        assert rec["launches"] == per_step, (i, rec["launches"])
        assert math.isfinite(rec["loss"]) and math.isfinite(
            rec["grad_norm"]), (i, rec)
    step_ms = sorted(rec["step_ms"] for rec in log.values())[steps // 2]
    n_params = registry.param_count(cfg)
    emit("train_vlm", model=f"{PALIGEMMA} language model, full width and "
         "depth, bf16, SyntheticLM text + seeded image embeddings",
         layers=cfg.num_layers, batch=B, image_rows=cfg.num_image_tokens,
         text_tokens=VLM_TEXT, prefix_len=cfg.num_image_tokens,
         params=n_params, allocated_before_phase_bytes=allocated_before,
         steps_log=[{"step": i, **log[i]} for i in range(steps)],
         median_step_ms=step_ms,
         trained_tokens_per_s=B * VLM_TEXT / step_ms * 1e3,
         max_memory_allocated_bytes=peak, wall_s=out["elapsed_s"],
         launches=counts)
    del out
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = configs.get_config(PALIGEMMA).replace(num_layers=4,
                                                  dtype="float32")
    api = registry.get_model(cfg32)
    params = api.init(device="cuda", seed=5)
    for x in flatten(params):
        x.requires_grad_(True)
    batch = vlm_batch_iter(torch, cfg32, B)(0)
    loss_k, loss_p, rel, grads_k, kernel_counts, plain_counts = \
        kernel_vs_plain_grads(torch, api, params, batch)
    assert kernel_counts["flash_attention"] == cfg32.num_layers, \
        kernel_counts
    assert kernel_counts["flash_attention_bwd"] == cfg32.num_layers, \
        kernel_counts
    loss_err = abs(loss_k.item() - loss_p.item())
    assert loss_err <= 1e-5, loss_err
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-4, (worst, rel[worst])
    emit("train_vlm", model=f"{PALIGEMMA}, full width, 4 layers, fp32, "
         "TF32 off, batch 2 x (256 image rows + 768 text)",
         loss_kernel=loss_k.item(), loss_plain=loss_p.item(),
         loss_abs_err=loss_err, grad_leaves=len(rel),
         worst_grad_leaf=worst, worst_grad_rel_err=rel[worst],
         kernel_launches=kernel_counts, plain_launches=plain_counts)
    del params, grads_k, batch
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# distribution and compile-time tooling: sharded, remat, dryrun
# ---------------------------------------------------------------------------


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def event_ms(torch, fn, iters=3):
    """(median ms of ``fn()`` under CUDA events over ``iters`` calls after
    one warm-up, the last result)."""
    out = fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def _leaf_diffs(torch, got, want, path=""):
    """{leaf path: (largest |got - want|, that relative to the leaf's
    largest |want|, entries that differ)} over two trees; DTensors
    compared whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(want, dict):
        out = {}
        for k in want:
            out.update(_leaf_diffs(torch, got[k], want[k], f"{path}/{k}"))
        return out
    if isinstance(got, DTensor):
        got = got.full_tensor()
    d = (got.float() - want.float()).abs()
    top = d.max().item()
    return {path: (top, top / max(want.float().abs().max().item(), 1e-30),
                   int((d > 0).sum().item()))}


def _max_diff(torch, got, want):
    """(largest |got - want| over the leaves of two trees, largest of it
    relative to its leaf's largest |want|); DTensors compared whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(want, dict):
        pairs = [_max_diff(torch, got[k], want[k]) for k in want]
        return (max(p[0] for p in pairs), max(p[1] for p in pairs))
    if isinstance(got, DTensor):
        got = got.full_tensor()
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def phase_sharded(torch):
    """The sharded path on the card: a one-rank NCCL process group and a
    (1, 1) ("data", "model") mesh; DTensor parameters and inputs through
    the models' sharding hooks, attention through ``local_map`` onto the
    flash kernels.  At full width in bf16: the paper-7b draft's loss and
    gradients at 2 x 4,096 (fsdp specs), and the target's dense prefill of
    2 x 1,024 tokens + 4 decode steps (tp_seq specs), each against the
    unsharded path on the same weights and tokens (2e-2, the bf16 kernel
    tolerance; gradients relative to each leaf's largest entry, printed
    leaf by leaf with the worst leaf named); the flash
    forward and backward launches of the sharded path, and each path's
    step time under CUDA events (the gap is DTensor's host overhead)."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import registry
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_loop import loss_and_grads
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        ba = shd.batch_axes(mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def sharded(fn):
            def run():
                with implicit_replication(), \
                        shd.activation_sharding(ba, "model"):
                    return fn()
            return run

        # the draft's loss and gradients (fsdp)
        dcfg = configs.get_draft_config("paper-7b").replace(dtype="bfloat16")
        dapi = registry.get_model(dcfg)
        params = dapi.init(device="cuda", seed=0)
        tok = torch.randint(0, dcfg.vocab_size, (2, 4096), device="cuda",
                            generator=gen)
        batch = {"tokens": tok, "labels": tok}
        plain = tree_map(lambda p: p.detach().requires_grad_(True), params)
        dparams = tree_map(lambda p: p.requires_grad_(True),
                           shd.distribute_tree(params, shd.param_specs(
                               dcfg, params, mesh, weight_mode="fsdp"),
                               mesh))
        dbatch = shd.distribute_tree(batch, shd.data_specs(dcfg, batch,
                                                           mesh), mesh)
        train_plain = lambda: loss_and_grads(dapi, plain, batch)  # noqa: E731
        train_sharded = sharded(lambda: loss_and_grads(dapi, dparams,
                                                       dbatch))
        loss_p, grads_p = train_plain()
        reset_counts()
        loss_s, grads_s = train_sharded()
        torch.cuda.synchronize()
        train_counts = read_counts()
        loss_err = abs(loss_s.full_tensor().item() - loss_p.item())
        leaf = _leaf_diffs(torch, grads_s, grads_p)
        worst = max(leaf, key=lambda k: leaf[k][1])
        grad_abs, grad_rel = leaf[worst][0], leaf[worst][1]
        assert train_counts["flash_attention"] > 0, train_counts
        assert train_counts["flash_attention_bwd"] > 0, train_counts
        assert loss_err <= ATOL["bfloat16"], loss_err
        assert grad_rel <= ATOL["bfloat16"], (grad_abs, grad_rel)
        del grads_p, grads_s
        ms_plain = event_ms(torch, train_plain)[0]
        ms_sharded = event_ms(torch, train_sharded)[0]
        emit("sharded", part="draft loss + gradients, fsdp",
             model="paper-7b draft, full width and depth, bf16",
             batch=[2, 4096], mesh={"data": 1, "model": 1},
             backend="nccl", loss_plain=loss_p.item(),
             loss_sharded=loss_s.full_tensor().item(),
             loss_abs_err=loss_err, grad_max_abs_err=grad_abs,
             grad_max_rel_err=grad_rel, grad_worst_leaf=worst,
             grad_rel_err_by_leaf={k: v[1] for k, v in leaf.items()},
             grad_entries_differing={k: v[2] for k, v in leaf.items()},
             tolerance=ATOL["bfloat16"],
             launches=train_counts, step_ms_plain=ms_plain,
             step_ms_sharded=ms_sharded,
             dtensor_overhead_ms=ms_sharded - ms_plain)
        del plain, dparams, params
        torch.cuda.empty_cache()

        # the target's dense prefill + 4 decode steps (tp_seq)
        tcfg = configs.get_config("paper-7b").replace(dtype="bfloat16")
        tapi = registry.get_model(tcfg)
        tparams = tapi.init(device="cuda", seed=1)
        dtp = shd.distribute_tree(tparams, shd.param_specs(
            tcfg, tparams, mesh, weight_mode="tp_seq"), mesh)
        prompt = torch.randint(0, tcfg.vocab_size, (2, 1024), device="cuda",
                               generator=gen)
        max_len = prompt.shape[1] + 8

        def to_mesh(t):
            return shd.distribute_tree(t, shd.token_specs(t, mesh), mesh)

        with torch.no_grad():
            lg_p, cache_p = tapi.prefill(tparams, {"tokens": prompt},
                                         max_len)
            toks, want = [lg_p[:, -1].argmax(-1)], [lg_p]
            for _ in range(4):
                lg_p, cache_p = tapi.decode_step(tparams, cache_p,
                                                 toks[-1][:, None])
                want.append(lg_p)
                toks.append(lg_p[:, -1].argmax(-1))
            reset_counts()
            got = []
            lg_s, cache_s = sharded(lambda: tapi.prefill(
                dtp, {"tokens": to_mesh(prompt)}, max_len))()
            got.append(lg_s)
            for i in range(4):
                lg_s, cache_s = sharded(lambda: tapi.decode_step(
                    dtp, cache_s, to_mesh(toks[i][:, None])))()
                got.append(lg_s)
            torch.cuda.synchronize()
            serve_counts = read_counts()
            errs = [_max_diff(torch, g, w)[0] for g, w in zip(got, want)]
            assert serve_counts["flash_attention"] > 0, serve_counts
            assert max(errs) <= ATOL["bfloat16"], errs
            ms = {"prefill_plain": event_ms(torch, lambda: tapi.prefill(
                tparams, {"tokens": prompt}, max_len))[0],
                "prefill_sharded": event_ms(torch, sharded(
                    lambda: tapi.prefill(dtp, {"tokens": to_mesh(prompt)},
                                         max_len)))[0]}
            _, cache_p = tapi.prefill(tparams, {"tokens": prompt}, max_len)
            _, cache_s = sharded(lambda: tapi.prefill(
                dtp, {"tokens": to_mesh(prompt)}, max_len))()
            ms["decode_plain"] = event_ms(torch, lambda: tapi.decode_step(
                tparams, cache_p, toks[0][:, None]), iters=4)[0]
            ms["decode_sharded"] = event_ms(torch, sharded(
                lambda: tapi.decode_step(dtp, cache_s,
                                         to_mesh(toks[0][:, None]))),
                iters=4)[0]
        emit("sharded", part="target dense prefill + 4 decode steps, tp_seq",
             model="paper-7b target, full width and depth, bf16",
             prompt=list(prompt.shape), max_len=max_len,
             logits_max_abs_err=errs, tolerance=ATOL["bfloat16"],
             launches=serve_counts, ms=ms,
             dtensor_overhead_ms={
                 "prefill": ms["prefill_sharded"] - ms["prefill_plain"],
                 "decode_step": ms["decode_sharded"] - ms["decode_plain"]})
        del tparams, dtp, cache_p, cache_s
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {k: train_counts[k] + serve_counts[k] for k in train_counts}


def _remat_steps(torch, cfg, batch, steps):
    """``steps`` train steps of ``cfg`` from seeded weights on one batch:
    (losses, step ms under CUDA events, peak bytes)."""
    from repro_torch.training.optimizer import adamw_init, tree_map
    from repro_torch.training.train_loop import make_train_step
    api, step = make_train_step(cfg, base_lr=1e-3, warmup=10)
    params = tree_map(lambda p: p.requires_grad_(True),
                      api.init(device="cuda", seed=0))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        m, params, opt = step(params, opt, batch)
        b.record()
        losses.append(m["loss"].item())          # synchronises
        ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    del params, opt, m
    torch.cuda.empty_cache()
    return losses, ms, peak


def phase_remat(torch):
    """``cfg.remat`` on the training path: the full-width, full-depth bf16
    draft's train step (2 x 4,096, the train phase's shape), 5 steps from
    the same weights at remat none / full / dots: peak
    ``max_memory_allocated`` and the median step ms; full's and dots'
    losses within 2e-2 of none's.  Then fp32 (TF32 off) at 4 layers, 2
    steps: the losses equal none's within 1e-6."""
    from repro_torch import configs
    from repro_torch.training.data import make_batch_iter
    base = configs.get_draft_config("paper-7b")
    reset_counts()
    rows, losses = {}, {}
    for dtype, layers, steps, tol in (("bfloat16", base.num_layers, 5,
                                       ATOL["bfloat16"]),
                                      ("float32", 4, 2, 1e-6)):
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = base.replace(dtype=dtype, num_layers=layers)
        batch = make_batch_iter(cfg.vocab_size, 2, 4096, seed=0,
                                device="cuda")(0)
        for remat in ("none", "full", "dots"):
            ls, ms, peak = _remat_steps(torch, cfg.replace(remat=remat),
                                        batch, steps)
            losses[dtype, remat] = ls
            rows[f"{dtype} {layers} layers, remat {remat}"] = {
                "losses": ls, "median_step_ms": sorted(ms)[len(ms) // 2],
                "step_ms": ms, "max_memory_allocated_bytes": peak}
        for remat in ("full", "dots"):
            err = max(abs(a - b) for a, b in zip(losses[dtype, remat],
                                                 losses[dtype, "none"]))
            rows[f"{dtype} {layers} layers, remat {remat}"][
                "loss_max_abs_err_vs_none"] = err
            assert err <= tol, (dtype, remat, err)
    counts = read_counts()
    assert counts["flash_attention"] > 0, counts
    assert counts["flash_attention_bwd"] > 0, counts
    emit("remat", model="paper-7b draft, full width, batch 2 x 4,096",
         runs=rows, launches=counts)
    return counts


# the dry run's cells on the card: one subprocess with its own fake
# process group on the (32, 8) production mesh.  qwen2-72b train_4k (eager
# DTensor dispatch over 8 microbatches of 80 layers, about 3 minutes) is
# cut to keep the phase near 2 minutes; deepseek-7b and paligemma-3b
# train_4k stand for the train cells (the flash backward's custom op and
# its flop formula on fake CUDA tensors, at head_dim 128 and at 256 with
# MQA and the image prefix).  The full table runs through the CLI (README)
DRYRUN_ARGS = [["--arch", "deepseek-7b", "--shape", "train_4k"],
               ["--arch", "paligemma-3b", "--shape", "train_4k"],
               ["--arch", "qwen2-72b", "--shape", "prefill_32k"],
               ["--arch", "qwen2-72b", "--shape", "decode_32k"],
               ["--arch", "grok-1-314b", "--shape", "decode_32k"],
               ["--arch", "paper-7b", "--shape", "decode_32k", "--spec"]]
DRYRUN_CODE = """import json, sys
from repro_torch.launch import dryrun
rcs = [dryrun.main(argv + ["--json", f"{sys.argv[2]}/dryrun_{i}.json"])
       for i, argv in enumerate(json.loads(sys.argv[1]))]
print(json.dumps({"rcs": rcs}))
"""
# the dry run's local counting held on this PyTorch: a reduced deepseek-7b
# (head_dim 64, so the flash backward takes it) fsdp train step over 8
# data ranks counts 1/8 of the unsharded step's flops per device, both on
# fake tensors of argv[1]'s device
DRYRUN_LOCAL_CODE = """import dataclasses, json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.training.optimizer import adamw_init, tree_map
from repro_torch.training.train_loop import make_train_step
dev = sys.argv[1]
shape = ShapeConfig("train_4k", seq_len=256, global_batch=16, kind="train")
red = configs.reduced(configs.get_config("deepseek-7b")).replace(
    num_heads=2, num_kv_heads=2)
over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
        if f.name not in ("name", "remat")}
with dryrun.fake_world(8):
    mesh = init_device_mesh(dev, (8, 1), mesh_dim_names=("data", "model"))
    res = dryrun.run_cell("deepseek-7b", shape, mesh, verbose=False,
                          cfg_override=over, accum_override=1)
cfg = configs.get_config("deepseek-7b").replace(**over, remat="full")
with FakeTensorMode(), torch.device(dev):
    params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype)
                      .requires_grad_(True), registry.param_specs(cfg))
    batch = configs.input_specs(cfg, shape, device=dev)["batch"]
    _, step = make_train_step(cfg)
    with FlopCounterMode(display=False) as fc:
        step(params, adamw_init(params), batch)
print(json.dumps({"torch": torch.__version__, "device": res["device"],
                  "weight_mode": res["weight_mode"],
                  "flops_per_device": res["flops_per_device"],
                  "unsharded_flops": fc.get_total_flops()}))
"""


def phase_dryrun(torch):
    """``python -m repro_torch.launch.dryrun``'s cells in a subprocess (its
    own fake process group of 256 ranks, fake CUDA tensors, nothing on the
    card): deepseek-7b and paligemma-3b train_4k, qwen2-72b prefill_32k
    and decode_32k, grok-1-314b decode_32k and paper-7b decode_32k
    speculative; each cell's per-device terms
    (H100 data-sheet estimates, not measurements) and its wall
    seconds."""
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", DRYRUN_CODE, json.dumps(DRYRUN_ARGS),
         str(out_dir)], cwd=ROOT, capture_output=True, text=True,
        timeout=900, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["rcs"] == [0] * len(
        DRYRUN_ARGS), (out.stdout[-2000:], out.stderr[-4000:])
    local = subprocess.run(
        [sys.executable, "-c", DRYRUN_LOCAL_CODE, "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert local.returncode == 0, local.stderr[-4000:]
    inv = json.loads(local.stdout.strip().splitlines()[-1])
    ratio = 8 * inv["flops_per_device"] / inv["unsharded_flops"]
    assert inv["device"] == "cuda" and inv["weight_mode"] == "fsdp", inv
    assert abs(ratio - 1) <= 0.01, inv
    emit("dryrun", part="local counting on this PyTorch: reduced deepseek-7b "
         "fsdp train over (8, 1), 8 x per-device flops / unsharded",
         ratio=ratio, tolerance=0.01, torch=inv["torch"],
         fake_device=inv["device"], weight_mode=inv["weight_mode"],
         flops_per_device=inv["flops_per_device"],
         unsharded_flops=inv["unsharded_flops"])
    keys = ("arch", "shape", "mesh", "weight_mode",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_bytes_by_axis",
            "collectives", "peak_bytes_per_device",
            "argument_bytes_per_device", "compute_s", "memory_s",
            "collective_s", "bottleneck", "roofline_fraction",
            "useful_flops_ratio", "fits_hbm", "wall_s")
    cells = 0
    for i, argv in enumerate(DRYRUN_ARGS):
        res = json.loads((out_dir / f"dryrun_{i}.json").read_text())
        assert not res["failures"], res["failures"]
        for r in res["results"]:
            assert r["device"] == "cuda" and r["flops_per_device"] > 0, r
            cells += 1
            emit("dryrun", spec=" ".join(argv), fake_device=r["device"],
                 **{k: r[k] for k in keys},
                 note="H100 SXM data-sheet constants, fake tensors, not "
                      "measured")
    emit("dryrun", cells=cells, wall_s=wall)


# ---------------------------------------------------------------------------


def kernel_line(err, attn_rows, mig_rows, window_rows, flash_err, flash_rows,
                grad_err, grad_rows, by_path):
    """The contract's kernels line.  ``by_path`` holds each main path's
    launches (counts set to 0 just before the path, read just after);
    ``launches`` is their sum."""
    def entry(name, src, replaces, rows, err):
        top = rows[0]
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": sum(paths.values()),
                "launches_by_path": paths,
                "max_abs_err": err, "ms": top["ms"],
                "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"], "library_ms": top["library_ms"],
                "timed_shape": top["shape"], "shapes": rows}
    return {"kernels": [
        entry("paged_attention",
              "src/repro_torch/kernels/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:117", attn_rows,
              err["paged_attention"]),
        # the windowed launches of the same source; the reference has no
        # window
        entry("paged_window_attention",
              "src/repro_torch/kernels/csrc/paged_attention.cu", None,
              window_rows, err["paged_window_attention"]),
        entry("migrate_blocks",
              "src/repro_torch/kernels/csrc/block_migration.cu",
              "src/repro/kernels/block_migration.py:48", mig_rows,
              err["migrate_blocks"]),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:87", flash_rows,
              flash_err),
        # no Pallas counterpart: the reference takes jax.grad of its jnp
        # blockwise_attention
        entry("flash_attention_bwd",
              "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "src/repro/models/common.py:102", grad_rows, grad_err),
    ], **CARD}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    card_info(torch)
    phase_build()
    err, attn_rows, mig_rows, window_rows = phase_kernels(torch)
    flash_err, flash_rows = phase_flash(torch)
    by_path = {}
    by_path["serve"], full_params, serve_outs = phase_serve(torch)
    elastic = phase_elastic_full(torch, full_params)
    assert elastic["migrate_blocks"] == 1, elastic     # one launch per set
    # the dense path's launches: flash_attention runs there, not on the
    # paged path
    by_path["dense_serve"] = phase_dense_serve(torch, full_params)
    by_path["disagg_serve"] = phase_disagg_serve(torch, full_params,
                                                 serve_outs)
    by_path["pressure_serve"] = phase_pressure_serve(torch, full_params,
                                                     serve_outs)
    phase_cswitch(torch, full_params[1])
    del full_params
    torch.cuda.empty_cache()
    by_path["moe_serve"] = phase_moe_serve(torch)
    by_path["vlm_serve"] = phase_vlm_serve(torch)
    by_path["vlm_prefix"] = {"flash_attention": phase_vlm_prefix(torch)}
    by_path["ssm_serve"] = phase_ssm_serve(torch)
    by_path["hybrid_serve"] = phase_hybrid_serve(torch)
    by_path["encdec_prefix"] = {"flash_attention":
                                phase_encdec_prefix(torch)}
    by_path["window_serve"] = phase_window_serve(torch)
    phase_decode_graphs(torch)

    from repro_torch.models import registry
    cfg, dcfg = fp32_cut()
    params = (registry.get_model(cfg).init(device="cuda", seed=1),
              registry.get_model(dcfg).init(device="cuda", seed=2))
    phase_lossless(torch, params)
    phase_elastic(params)
    phase_dense_lossless(torch, params)
    phase_disagg_lossless(torch, params)
    phase_chunked_lossless(torch, params)
    phase_preempt_lossless(torch, params)
    phase_host_tier_lossless(torch, params)
    del params
    torch.cuda.empty_cache()
    phase_moe_lossless(torch)
    phase_ssm_lossless(torch)
    torch.cuda.empty_cache()
    grad_err, grad_rows = phase_flash_grad(torch)
    phase_train_fp32(torch)
    by_path["train"] = phase_train(torch)
    by_path["train_cli"] = phase_train_cli(torch)
    by_path["train_vlm"] = phase_train_vlm(torch)
    by_path["train_cli_reduced"] = phase_train_cli_reduced(torch)
    by_path["sharded"] = phase_sharded(torch)
    by_path["remat"] = phase_remat(torch)
    phase_dryrun(torch)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(kernel_line(err, attn_rows, mig_rows, window_rows,
                                 flash_err, flash_rows, grad_err, grad_rows,
                                 by_path)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
