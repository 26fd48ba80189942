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
  6. elastic — the elastic memory manager offloads the draft on a 24-block
               pool and the streams equal an unmanaged run;
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
               factor 8.0 (no drops): AR, fixed-2, Nightjar and
               target-as-draft greedy streams are equal;
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
               streams equal colocated ones (runs after phase 8).

Phase 2 also holds ``flash_attention`` against its plain version (fp32 with
TF32 off on the CUDA-core kernel, and bf16 on the tensor-core kernel) and
times it beside its bound, the plain version and
``scaled_dot_product_attention``; the paged checks include 2,048-token
contexts that take several splits and the combine pass, and each paged
timing row says how many splits it used.  The new pairs' heads
(paligemma's D = 256 with G = 8, granite's D = 64 with G = 2) are checked
at their served shapes and at 512 / 2,048 tokens, and flash at D = 256
with the image prefix; their timing rows stand beside the paper-7b ones.
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


def attn_bound(q, k_pages, lengths, dtype_name):
    """Least time the card needs for one call: the bytes it must move
    (queries and outputs once, the K/V pages this call's lengths reach,
    the tables) over HBM bandwidth, against the flops over the type's
    peak."""
    B, T, H, D = q.shape
    _, bs, KH, _ = k_pages.shape
    es = q.element_size()
    lens = lengths.tolist()
    pages = sum(-(-n // bs) for n in lens)
    nbytes = 2 * q.numel() * es + 2 * pages * bs * KH * D * es \
        + 4 * B * (pages + 1)
    flops = sum(4 * H * D * max(n - T + t + 1, 0)
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
    del flush
    torch.cuda.empty_cache()
    for row in attn_rows + mig_rows:
        emit("time", **row)
    err = {"paged_attention": max([attn_err["bfloat16"]]
                                  + [r["max_abs_err"] for r in attn_rows]),
           "migrate_blocks": mig_worst}
    return err, attn_rows, mig_rows


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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    return {"paged_attention": paged_attention,
            "migrate_blocks": migrate_blocks,
            "flash_attention": flash_attention}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


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
         summary=m.summary())
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


def fp32_cut(depth=4):
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
        emit("lossless_run", run=name, spec=m.spec_summary(),
             accepted_tokens=accepted[name], launches=counts)
        del engine
    assert accepted["nightjar, draft = target"] > 0, accepted
    for name in ("nightjar", "nightjar, draft = target"):
        assert out[name] == out["ar"], f"fp32 {name} stream != AR stream"
    emit("lossless", model=f"paper-7b full width, {cfg.num_layers} target + "
         f"{dcfg.num_layers} draft layers, fp32, TF32 off",
         requests=len(out["ar"]), equal=True, accepted_tokens=accepted)


def recipe(params, *, memmgr):
    """tests/test_paged_backend.py's elastic-pool engine recipe on the card:
    24 blocks of 4 tokens, four requests."""
    from repro_torch.core.bandits import make_policy
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import BlockManager
    from repro_torch.serving.memory_manager import ElasticMemoryManager
    from repro_torch.serving.real_backend import RealBackend
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    from repro_torch.serving.workload import tiny_requests
    cfg, dcfg = fp32_cut()
    bm = BlockManager(24, 4)
    be = RealBackend(registry.get_model(cfg), registry.get_model(dcfg),
                     device="cuda", params=params, max_batch=4, seed=0,
                     block_manager=bm)
    sched = ContinuousBatchingScheduler(bm, max_batch=4, watermark_frac=0.0)
    mm = None
    if memmgr:
        mm = ElasticMemoryManager(
            bm, draft_blocks=4, t_persist=1, tau_low_frac=0.4,
            offload_fn=be.offload_draft, reload_fn=be.reload_draft,
            migrate_fn=be.migrate_pools, grow_fn=be.grow_pools,
            shrink_fn=be.shrink_pools)
    eng = ServingEngine(be, sched, make_policy("nightjar", 3, seed=0), mm,
                        gamma_max=3)
    reqs = tiny_requests(4, rate_qps=1e6, prompt_len=10, output_len=12,
                         vocab=cfg.vocab_size, seed=5)
    m = eng.run(reqs, max_steps=3000)
    outs = streams(eng, reqs)
    check_run(m, reqs, outs, cfg.vocab_size)
    return outs, m


def phase_elastic(params):
    reset_counts()
    managed, m = recipe(params, memmgr=True)
    counts = read_counts()
    plain, _ = recipe(params, memmgr=False)
    assert m.offload_events >= 1, m.summary()
    assert managed == plain, "elastic-pool streams differ from unmanaged"
    emit("elastic", offload_events=m.offload_events,
         reload_events=m.reload_events, equal=True, launches=counts)


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
    are routed too, as the reference routes them, and count.  The wrappers
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
        self.backend = self.saved = None

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
    reference's reduced() sets it, so no call drops a slot (counted).  The
    greedy streams under AR, fixed-2, Nightjar and Nightjar with the target
    as its own draft (which accepts) are equal token for token."""
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
        engine = build_real_engine(cfg, draft_cfg, device="cuda",
                                   policy=policy, prefix_caching=True,
                                   chunk_tokens=16, seed=0, params=pair)
        reqs = requests(cfg.vocab_size)
        reset_counts()
        with DropCounter(torch, engine.backend) as dc:
            m = engine.run(reqs, max_steps=5000, record_timeline=True)
        counts = read_counts()
        out[name] = streams(engine, reqs)
        check_run(m, reqs, out[name], cfg.vocab_size)
        accepted[name] = sum(g["accepted"] for gam, g in
                             m.spec.get("per_gamma", {}).items() if gam > 0)
        drops[name] = dc.summary()
        assert all(v["dropped"] == 0 for v in drops[name].values()), drops
        if policy != "ar":
            assert m.spec.get("spec_steps", 0) >= 1, m.spec
        emit("moe_lossless_run", run=name, spec=m.spec_summary(),
             accepted_tokens=accepted[name], launches=counts,
             dropped_slots=drops[name])
        del engine
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


def kernel_line(err, attn_rows, mig_rows, flash_err, flash_rows, by_path):
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
        entry("migrate_blocks",
              "src/repro_torch/kernels/csrc/block_migration.cu",
              "src/repro/kernels/block_migration.py:48", mig_rows,
              err["migrate_blocks"]),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:87", flash_rows,
              flash_err),
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
    err, attn_rows, mig_rows = phase_kernels(torch)
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

    from repro_torch.models import registry
    cfg, dcfg = fp32_cut()
    params = (registry.get_model(cfg).init(device="cuda", seed=1),
              registry.get_model(dcfg).init(device="cuda", seed=2))
    phase_lossless(torch, params)
    phase_elastic(params)
    phase_dense_lossless(torch, params)
    phase_disagg_lossless(torch, params)
    del params
    torch.cuda.empty_cache()
    phase_moe_lossless(torch)
    phase_ssm_lossless(torch)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(kernel_line(err, attn_rows, mig_rows, flash_err,
                                 flash_rows, by_path)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
