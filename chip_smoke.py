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
  4. lossless — fp32 (TF32 off) at full width and cut depth: the greedy
               stream under Nightjar equals the AR stream, with the paper's
               draft and with the target as its own draft (which accepts);
  5. elastic — the elastic memory manager offloads the draft on a 24-block
               pool and the streams equal an unmanaged run;
  6. dense_serve — the dense-cache path: the same pair and requests as
               phase 3 through ``DenseSlotBackend`` (monolithic prefill one
               prompt at a time through the flash-attention kernel, dense
               spec / AR steps, draft catch-ups by re-prefill);
  7. dense_lossless — fp32 at full width and cut depth: the dense Nightjar,
               dense AR, paged and dense target-as-draft streams are equal;
  8. cswitch — the paper's Table 3 on the card: the full-width bf16 draft's
               dense prefill timed on the (delta, batch) grid through
               ``CSwitchTable.profile``.

Phase 2 also holds ``flash_attention`` against its plain version (fp32 with
TF32 off on the CUDA-core kernel, and bf16 on the tensor-core kernel) and
times it beside its bound, the plain version and
``scaled_dot_product_attention``; the paged checks include 2,048-token
contexts that take several splits and the combine pass, and each paged
timing row says how many splits it used.

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
# flash attention timings (bf16, causal): label, B, S, H, KH, D
FLASH_TIMED = [("dense serve prefill", 1, 16, 28, 4, 128),
               ("C_switch delta=128 B=2", 2, 128, 14, 2, 64),
               ("C_switch delta=256 B=8", 8, 256, 14, 2, 64),
               ("C_switch delta=512 B=32", 32, 512, 14, 2, 64),
               ("long target prefill", 1, 2048, 28, 4, 128)]
# paged attention timings (bf16, B = 4, 8-position blocks): label, T,
# context
PAGED_TIMED = [("target decode B=4", 1, 32),
               ("target verify gamma=3 B=4", 4, 32),
               ("target prefill T=16 B=4", 16, 16),
               ("draft decode B=4", 1, 32),
               ("target decode B=4 ctx=512", 1, 512),
               ("target decode B=4 ctx=1024", 1, 1024),
               ("target decode B=4 ctx=2048", 1, 2048)]
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
    attn = DRAFT_ATTN if label.startswith("draft") else TARGET_ATTN
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
    from repro_torch.kernels.block_migration import migrate_blocks
    from repro_torch.kernels.paged_attention import (TILE, paged_attention,
                                                     split_plan)
    from repro_torch.kernels.ref import migrate_blocks_ref, paged_attention_ref
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
    # the serve's shapes: one split, so one launch
    for attn in (TARGET_ATTN, DRAFT_ATTN):
        for B in (1, 4):
            for T in (1, 2, 3, 4, 16):
                lens = [T + 5 + 9 * i for i in range(B)]
                cases.append((1, dict(B=B, T=T, bs=8, lengths=lens,
                                      **attn)))
    cases.append((None, dict(B=1, T=256, bs=8, lengths=[300],
                             **TARGET_ATTN)))
    cases.append((None, dict(B=2, T=64, bs=4, lengths=[64, 100],
                             **DRAFT_ATTN)))
    # split-KV: 2,048 tokens of context with ragged lengths in one batch,
    # one sequence shorter than a split and one ending on a split boundary
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for attn in (TARGET_ATTN, DRAFT_ATTN):
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

    # --- block migration: bitwise -------------------------------------
    L, NB = 28, 1024
    mig_shapes = [(3, nb, rs) for nb, rs in ((8, (4, 2, 4)), (16, (2, 8, 16)),
                                             (5, (3, 2, 2)))]
    mig_shapes.append((L, NB + 1, (8, TARGET_ATTN["KH"], TARGET_ATTN["D"])))

    def mig_err(pool, src, dst):
        """Largest difference between the kernel and the plain version on
        copies of ``pool``; the kernel must be bitwise equal."""
        want = migrate_blocks_ref(pool.clone(), src, dst)
        got = migrate_blocks(pool.clone(), src, dst)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert torch.equal(got, want), (pool.dtype, pool.shape, len(src),
                                        err)
        return err

    mig_worst = 0.0
    for dtype_name in ("float32", "bfloat16"):
        for Ls, nb, rs in mig_shapes:
            pool = torch.randn((Ls, nb) + rs, generator=gen,
                               device="cuda").to(getattr(torch, dtype_name))
            perm = torch.randperm(nb, generator=gen,
                                  device="cuda").tolist()
            m = max(nb // 2, 1)
            src, dst = perm[:m], perm[m:2 * m][:m]
            src = src[:len(dst)]
            mig_worst = max(mig_worst, mig_err(pool, src, dst))
            del pool
            torch.cuda.empty_cache()
    emit("check", kernel="migrate_blocks", shapes=len(mig_shapes) * 2,
         bitwise_equal=True, max_abs_err=mig_worst)

    # --- times at the main-path shapes (bf16) ---------------------------
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    bf16 = torch.bfloat16
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
    mig_rows = []
    for label, m in (("CoW fork, 1 block", 1),
                     ("contraction, 64 blocks", 64)):
        pool = torch.randn((L, NB + 1, 8, TARGET_ATTN["KH"],
                            TARGET_ATTN["D"]), generator=gen,
                           device="cuda").to(bf16)
        src = list(range(NB - m, NB))
        dst = list(range(m))
        s_d = torch.tensor(src, device="cuda")
        d_d = torch.tensor(dst, device="cuda")
        seg_bytes = pool[0, 0].numel() * pool.element_size()
        nbytes = 2 * m * L * seg_bytes + 8 * m
        err = mig_err(pool, src, dst)
        mig_worst = max(mig_worst, err)
        mig_rows.append(dict(
            shape=f"{label}, target pool {tuple(pool.shape)}", M=m,
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: migrate_blocks(pool, src, dst),
                       flush=flush),
            plain_ms=cuda_ms(torch, lambda: migrate_blocks_ref(pool, src,
                                                               dst),
                             flush=flush),
            library_ms=cuda_ms(torch, lambda: pool.index_copy_(
                1, d_d, pool.index_select(1, s_d)), flush=flush),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes"))
        del pool
    del flush
    torch.cuda.empty_cache()
    for row in attn_rows + mig_rows:
        emit("time", **row)
    err = {"paged_attention": max([attn_err["bfloat16"]]
                                  + [r["max_abs_err"] for r in attn_rows]),
           "migrate_blocks": mig_worst}
    return err, attn_rows, mig_rows


def flash_bound(B, S, H, KH, D, dtype_name, es):
    """Least time of one causal call: 4 * D flops per visible (query, key)
    pair and head (S (S + 1) / 2 pairs) over the type's peak, against q, k
    and v read once and the output written once over HBM bandwidth."""
    flops = 4 * B * H * D * S * (S + 1) // 2
    nbytes = es * B * S * D * (2 * H + 2 * KH)
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

    worst = {}
    for dtype_name in ("float32", "bfloat16"):
        worst[dtype_name] = 0.0
        for B, Sq, Sk, H, KH, D, causal, prefix in FLASH_CASES:
            args = inputs(B, Sq, Sk, H, KH, D, getattr(torch, dtype_name))
            got = flash_attention(*args, causal=causal, prefix_len=prefix)
            want = flash_attention_ref(*args, causal=causal,
                                       prefix_len=prefix)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), (B, Sq, Sk, H, KH, D)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= FLASH_ATOL[dtype_name], (dtype_name, B, Sq, Sk, H,
                                                   KH, D, causal, prefix, err)
            worst[dtype_name] = max(worst[dtype_name], err)
    emit("check", kernel="flash_attention", cases=len(FLASH_CASES),
         max_abs_err=worst, atol=FLASH_ATOL)

    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    rows = []
    for label, B, S, H, KH, D in FLASH_TIMED:
        q, k, v = inputs(B, S, S, H, KH, D, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_ref(q, k, v, causal=True)
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.transpose(1, 2).float() - want.float()).abs().max()
        assert err <= FLASH_ATOL["bfloat16"], (label, err)
        assert lib_err.item() <= FLASH_ATOL["bfloat16"], (label, lib_err)
        bound, by = flash_bound(B, S, H, KH, D, "bfloat16", q.element_size())
        rows.append(dict(
            shape=f"{label}: B={B} S={S} H={H} KH={KH} D={D}",
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True),
                       flush=flush),
            plain_ms=cuda_ms(torch, lambda: flash_attention_ref(
                q, k, v, causal=True), flush=flush, iters=10),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush=flush),
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
    return counts, params


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
    """``build_dense_engine`` with a counter of draft catch-ups around the
    backend's ``draft_catchup``."""
    from repro_torch.launch.serve import build_dense_engine
    engine = build_dense_engine(cfg, dcfg, device="cuda", policy=policy,
                                params=params)
    be = engine.backend
    be.catchups = {"calls": 0, "tokens": 0, "seconds": 0.0}
    catchup = be.draft_catchup

    def counted(seqs):
        lagging = [s.delta for s in seqs if s.delta > 0]
        dt = catchup(seqs)
        if lagging and be.draft_resident:
            be.catchups["calls"] += 1
            be.catchups["tokens"] += sum(lagging)
            be.catchups["seconds"] += dt
        return dt

    be.draft_catchup = counted
    return engine


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
         spec_steps=m.spec["spec_steps"], draft_catchups=engine.backend.catchups,
         launches=counts,
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


def kernel_line(err, attn_rows, mig_rows, flash_err, flash_rows, counts):
    def entry(name, src, replaces, rows, err, launches):
        top = rows[0]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": top["ms"],
                "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"], "library_ms": top["library_ms"],
                "timed_shape": top["shape"], "shapes": rows}
    return {"kernels": [
        entry("paged_attention",
              "src/repro_torch/kernels/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:117", attn_rows,
              err["paged_attention"], counts["paged_attention"]),
        entry("migrate_blocks",
              "src/repro_torch/kernels/csrc/block_migration.cu",
              "src/repro/kernels/block_migration.py:48", mig_rows,
              err["migrate_blocks"], counts["migrate_blocks"]),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:87", flash_rows,
              flash_err, counts["flash_attention"]),
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
    counts, full_params = phase_serve(torch)
    # the dense path's launches: flash_attention runs there, not on the
    # paged path
    counts["flash_attention"] = phase_dense_serve(torch, full_params)[
        "flash_attention"]
    phase_cswitch(torch, full_params[1])
    del full_params
    torch.cuda.empty_cache()

    from repro_torch.models import registry
    cfg, dcfg = fp32_cut()
    params = (registry.get_model(cfg).init(device="cuda", seed=1),
              registry.get_model(dcfg).init(device="cuda", seed=2))
    phase_lossless(torch, params)
    phase_elastic(params)
    phase_dense_lossless(torch, params)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(kernel_line(err, attn_rows, mig_rows, flash_err,
                                 flash_rows, counts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
