"""Serving entry point of the port: the real execution tier on the card
and the analytical simulated tier.

Real tier (reduced configs, PyTorch over the paged-KV runtime; on the card
by default, ``--device cpu`` asks for the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --tier real --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --tier real --device cpu \
      --dataset templated --chunk-tokens 8 --prefix-caching on

Simulated tier (paper-scale configs on the roofline cost model; its
latencies are the model's output, not a device's):
  PYTHONPATH=src python -m repro_torch.launch.serve --tier sim \
      --rate 20 --requests 300 --policy nightjar
  PYTHONPATH=src python -m repro_torch.launch.serve --tier sim \
      --replicas 4 --router jsq --rate 80 --requests 800
  PYTHONPATH=src python -m repro_torch.launch.serve --tier sim \
      --hw rtx-4090 --dataset mixed --rate 28 --requests 500 \
      --chunk-tokens 128 --max-batch 48 --disaggregate 2:2

The sim tier takes every flag of the reference's (``--replicas``,
``--router``, ``--autoscale``, ``--shed-factor``, ``--num-templates``,
``--bursty``, ``--disaggregate``, ``--handoff-margin``, ``--fault-plan``,
``--brownout``, ``--qa-frac``, ``--gamma-max``, ``--max-batch``, ``--slo``,
the datasets) and prints the same summary for the same arguments;
``--hw`` offers ``h100-sxm`` (the default), ``rtx-4090`` and ``a100-40g``.
``--trace`` / ``--trace-format`` / ``--metrics-out`` work on both tiers; on
the real tier the trace is stamped with ``time.perf_counter`` (wall time,
not the engine's sum of backend latencies) and holds each step's phase
spans.
Unlike the reference, whose default tier is ``sim``, the default here is
``real`` on ``--device cuda``: the entry point runs on the card unless
asked otherwise.  The sim-only flags are refused on the real tier.

``main`` serves ``configs.reduced`` models of any ``--arch`` on the real
tier (the granite-moe-1b-a400m, paligemma-3b, mamba2-780m and zamba2-1.2b
pairs included; whisper-medium's encoder-decoder is not served, as in the
reference); :func:`build_real_engine` and :func:`build_dense_engine` (the
dense-cache tier) take any config pair (``chip_smoke.py`` serves the
full-width paper-7b pair through both, and the full-width granite,
paligemma, mamba2 and zamba2 pairs through the first).  An ssm or hybrid
pair has no paged path: ``build_real_engine`` serves it through
``DenseSlotBackend`` with monolithic prefill, so ``--chunk-tokens``,
``--prefix-caching`` and ``--kv-offload`` are refused for it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Tuple

from .. import configs
from ..configs.base import ModelConfig
from ..core.bandits import make_policy
from ..models import registry
from ..serving.costmodel import (A100_40G, H100_SXM, RTX_4090,
                                 RooflineCostModel)
from ..serving.engine import ServingEngine
from ..serving.kv_cache import BlockManager, HostKVStore
from ..serving.memory_manager import ElasticMemoryManager
from ..serving.paged_runtime import num_blocks_for
from ..serving.real_backend import (DenseSlotBackend, RealBackend,
                                    make_real_backend)
from ..serving.scheduler import ContinuousBatchingScheduler


# the real tier's fixed shape: 8-token blocks, batches of at most 4, a pool
# of at most 1024 blocks, gamma <= 3 (the reference's real tier)
BLOCK_SIZE, MAX_BATCH, MAX_BLOCKS, GAMMA_MAX = 8, 4, 1024, 3


def build_real_engine(cfg: ModelConfig, dcfg: ModelConfig, *,
                      device="cuda", dtype: Optional[str] = None,
                      chunk_tokens: Optional[int] = None,
                      prefix_caching: bool = False, kv_offload: bool = False,
                      memmgr: bool = True, policy: str = "nightjar",
                      prefill_order: str = "fifo", seed: int = 0,
                      params: Optional[Tuple[dict, dict]] = None
                      ) -> ServingEngine:
    """One BlockManager drives both the scheduler's admission and the
    physical paged pools, sized from the H100 memory budget; the backend is
    ``make_real_backend``'s choice (the paged ``RealBackend`` for the
    attention families, ``DenseSlotBackend`` for an ssm or hybrid pair,
    whose monolithic prefill takes no chunk budget and no prefix cache:
    asking for either raises ``ValueError``).  With a ``RealBackend`` the
    elastic memory manager can offload the draft and grow / migrate /
    shrink the pools.  ``dtype`` overrides both configs' dtype.  ``params``
    is a (target, draft) pair of parameter trees; without it both are
    seeded from ``seed``.  Prefix caching needs a chunk budget (the
    monolithic scheduler always recomputes prompts)."""
    if dtype is not None:
        cfg, dcfg = cfg.replace(dtype=dtype), dcfg.replace(dtype=dtype)
    target, draft = registry.get_model(cfg), registry.get_model(dcfg)
    if not (target.supports_paged and draft.supports_paged) and (
            chunk_tokens or prefix_caching or kv_offload):
        raise ValueError(
            f"{cfg.name}: the pair has no paged path, so it is served by "
            f"DenseSlotBackend with monolithic prefill: no chunk_tokens, "
            f"prefix caching or KV offload")
    cm = RooflineCostModel(H100_SXM)
    nb = num_blocks_for(cm, cfg, dcfg, BLOCK_SIZE, max_blocks=MAX_BLOCKS)
    bm = BlockManager(nb, BLOCK_SIZE, prefix_caching=prefix_caching,
                      host_store=HostKVStore(4 * nb) if kv_offload else None)
    backend = make_real_backend(target, draft, device=device, params=params,
                                max_batch=MAX_BATCH, seed=seed,
                                block_manager=bm)
    sched = ContinuousBatchingScheduler(bm, max_batch=MAX_BATCH,
                                        chunk_tokens=chunk_tokens,
                                        prefill_order=prefill_order)
    mm = None
    if memmgr and isinstance(backend, RealBackend):
        # the draft's weight bytes converted to KV blocks, clamped so a
        # reduced model still exercises the grow/migrate path
        draft_blocks = max(min(
            -(-cm.weight_bytes(dcfg) // backend.tkv.bytes_per_block),
            bm.total_blocks // 4), 1)
        mm = ElasticMemoryManager(
            bm, draft_blocks=int(draft_blocks),
            offload_fn=backend.offload_draft,
            reload_fn=backend.reload_draft,
            migrate_fn=backend.migrate_pools,
            grow_fn=backend.grow_pools,
            shrink_fn=backend.shrink_pools)
    return ServingEngine(backend, sched,
                         make_policy(policy, GAMMA_MAX, seed=seed), mm,
                         gamma_max=GAMMA_MAX)


def build_dense_engine(cfg: ModelConfig, dcfg: ModelConfig, *,
                       device="cuda", policy: str = "nightjar",
                       seed: int = 0,
                       params: Optional[Tuple[dict, dict]] = None
                       ) -> ServingEngine:
    """The dense-cache tier at the real tier's shape: ``DenseSlotBackend``
    (fixed slots, one prompt at a time through the flash kernel, draft
    catch-up by re-prefill) under the monolithic scheduler, without the
    elastic memory manager (it manages paged pools)."""
    target, draft = registry.get_model(cfg), registry.get_model(dcfg)
    backend = DenseSlotBackend(target, draft, device=device, params=params,
                               max_batch=MAX_BATCH, seed=seed)
    sched = ContinuousBatchingScheduler(BlockManager(MAX_BLOCKS, BLOCK_SIZE),
                                        max_batch=MAX_BATCH)
    return ServingEngine(backend, sched,
                         make_policy(policy, GAMMA_MAX, seed=seed), None,
                         gamma_max=GAMMA_MAX)


HW_PROFILES = {"h100-sxm": H100_SXM, "rtx-4090": RTX_4090,
               "a100-40g": A100_40G}

# flags of the simulated tier only, with the value that leaves them unset
SIM_ONLY = {"replicas": 1, "router": "jsq", "autoscale": False,
            "shed_factor": 0.0, "num_templates": 1, "bursty": False,
            "hw": "h100-sxm", "disaggregate": None, "handoff_margin": 0.0,
            "fault_plan": None, "brownout": False, "qa_frac": None,
            "gamma_max": 5, "max_batch": 256}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-7b",
                    choices=configs.list_archs())
    ap.add_argument("--policy", default="nightjar")
    ap.add_argument("--tier", choices=["real", "sim"], default="real")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="real tier: where the models run")
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--requests", type=int, default=200,
                    help="requests to serve (the real tier serves at most "
                         "16)")
    ap.add_argument("--dataset", default="sharegpt",
                    help="sim tier: a workload.DATASETS name; the real "
                         "tier serves short random prompts, with a shared "
                         "8-token template for 'templated'")
    ap.add_argument("--qa-frac", type=float, default=None,
                    help="document-QA fraction of the mixed long-prompt/"
                         "long-decode dataset (default: the dataset's "
                         "tuned 0.25; only valid with --dataset mixed)")
    ap.add_argument("--gamma-max", type=int, default=5,
                    help="sim tier: largest speculative length (the real "
                         "tier's is 3)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="sim tier: batch cap (the real tier's is 4)")
    ap.add_argument("--chunk-tokens", default="0",
                    help="per-step prefill token budget for chunked-prefill "
                         "hybrid batching (0 = monolithic; 'auto' derives "
                         "the budget from the roofline compute-bound knee "
                         "on the sim tier, 256 on the real tier)")
    ap.add_argument("--slo", type=float, default=None,
                    help="TTFT deadline in seconds for SLO-attainment/"
                         "goodput (default: per-dataset; <=0 disables)")
    ap.add_argument("--prefix-caching", choices=["on", "off"], default="off")
    ap.add_argument("--prefill-order", choices=["fifo", "slo"],
                    default="fifo")
    ap.add_argument("--kv-offload", action="store_true",
                    help="host-memory KV spill tier (needs --prefix-caching "
                         "on)")
    ap.add_argument("--no-offload", action="store_true",
                    help="no elastic memory manager (draft stays resident)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="sim tier: number of engine replicas (with "
                         "--autoscale the fleet's max size)")
    ap.add_argument("--router", default="jsq",
                    choices=["rr", "jsq", "kv", "slo", "affinity"],
                    help="sim tier: dispatch policy for --replicas > 1")
    ap.add_argument("--autoscale", action="store_true",
                    help="sim tier: start at 1 replica, scale up to "
                         "--replicas on a windowed SLO-attainment signal, "
                         "drain back down when load clears")
    ap.add_argument("--shed-factor", type=float, default=0.0,
                    help="sim tier: shed an arrival when every replica's "
                         "predicted TTFT exceeds slo * factor (0 disables)")
    ap.add_argument("--num-templates", type=int, default=1,
                    help="sim tier, templated dataset: number of distinct "
                         "system-prompt templates")
    ap.add_argument("--bursty", action="store_true",
                    help="sim tier: arrivals from the bursty baseline -> "
                         "spike -> drain trace instead of a constant-rate "
                         "Poisson process")
    ap.add_argument("--hw", default="h100-sxm", choices=sorted(HW_PROFILES),
                    help="sim tier: roofline hardware profile")
    ap.add_argument("--disaggregate", default=None, metavar="P:D",
                    help="sim tier: P prefill + D decode replicas with "
                         "priced KV handoff (requires --chunk-tokens > 0; "
                         "overrides --replicas)")
    ap.add_argument("--handoff-margin", type=float, default=0.0,
                    help="sim tier: a handoff must beat staying put by at "
                         "least this many seconds")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="sim tier: deterministic fault schedule, e.g. "
                         "'crash:1@2.0;straggle:0@1.0..3.0x4;"
                         "handoff:fail@0..5#2;corrupt:0@4.0#1', seeded by "
                         "--seed (forces the cluster path)")
    ap.add_argument("--brownout", action="store_true",
                    help="sim tier: arm the fleet brownout ladder (forces "
                         "the cluster path)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a structured trace of the run (request "
                         "lifecycle spans, engine steps, fleet events) to "
                         "PATH")
    ap.add_argument("--trace-format", choices=["jsonl", "chrome"],
                    default="jsonl",
                    help="trace file format: jsonl or chrome (Perfetto / "
                         "chrome://tracing viewable)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry in Prometheus text "
                         "exposition format to PATH at end of run")
    args = ap.parse_args()

    if args.kv_offload and args.prefix_caching != "on":
        ap.error("--kv-offload requires --prefix-caching on (the host tier "
                 "is keyed by prefix chain hashes)")
    if args.tier == "real":
        for name, unset in SIM_ONLY.items():
            if getattr(args, name) != unset:
                ap.error(f"--{name.replace('_', '-')} runs on the simulated "
                         f"tier only")
    if args.chunk_tokens != "auto":
        try:
            int(args.chunk_tokens)
        except ValueError:
            ap.error("--chunk-tokens takes an integer or 'auto'")

    trace_rec = None
    if args.trace or args.metrics_out:
        from ..serving.observability import TraceRecorder
        trace_rec = TraceRecorder(
            clock=time.perf_counter if args.tier == "real" else None)

    if args.tier == "sim":
        metrics = _run_sim(ap, args, trace_rec)
    else:
        from ..serving.workload import tiny_requests
        cfg = configs.reduced(configs.get_config(args.arch))
        dcfg = configs.reduced(configs.get_draft_config(args.arch))
        chunk = None
        if args.chunk_tokens != "0":
            chunk = (256 if args.chunk_tokens == "auto"
                     else int(args.chunk_tokens))
        engine = build_real_engine(
            cfg, dcfg, device=args.device, chunk_tokens=chunk,
            prefix_caching=args.prefix_caching == "on",
            kv_offload=args.kv_offload, memmgr=not args.no_offload,
            policy=args.policy, prefill_order=args.prefill_order,
            seed=args.seed)
        if trace_rec is not None:
            engine.attach_trace(trace_rec)
        reqs = tiny_requests(min(args.requests, 16), rate_qps=args.rate,
                             prompt_len=16, output_len=16,
                             vocab=cfg.vocab_size, seed=args.seed,
                             template_len=(8 if args.dataset == "templated"
                                           else 0))
        metrics = engine.run(reqs, max_steps=5000)

    if trace_rec is not None:
        if args.trace:
            trace_rec.export(args.trace, fmt=args.trace_format)
        if args.metrics_out:
            with open(args.metrics_out, "w", encoding="utf-8",
                      newline="\n") as f:
                f.write(trace_rec.registry.exposition())

    print(json.dumps(metrics.summary(), indent=1))


def _run_sim(ap, args, trace_rec):
    """The simulated tier: one engine, or a cluster when any fleet flag is
    set.  Returns the run's metrics."""
    from ..serving.simulator import (SimConfig, build_sim_cluster,
                                     build_sim_engine)
    from ..serving.workload import (DATASETS, bursty_trace, mixed_requests,
                                    poisson_requests, session_requests,
                                    templated_requests)

    hw = HW_PROFILES[args.hw]
    target = configs.get_config(args.arch)
    chunk = RooflineCostModel(hw).resolve_chunk_tokens(args.chunk_tokens,
                                                       target)
    cfg = SimConfig(
        target=target, draft=configs.get_draft_config(args.arch),
        hw=hw, gamma_max=args.gamma_max, max_batch=args.max_batch,
        chunk_tokens=chunk, prefix_caching=args.prefix_caching == "on",
        prefill_order=args.prefill_order,
        enable_offload=not args.no_offload, kv_offload=args.kv_offload,
        seed=args.seed)
    if args.dataset in ("templated", "sessions") and args.bursty:
        ap.error(f"--bursty is not supported with --dataset {args.dataset} "
                 f"(that workload generates its own arrival process); pick "
                 f"one")
    if args.dataset == "sessions":
        # --requests is the TOTAL request budget; each session contributes
        # `turns` requests (one per conversation turn)
        turns = DATASETS["sessions"]["turns"]
        reqs = session_requests(max(args.requests // turns, 1),
                                rate_qps=args.rate, seed=args.seed + 1,
                                slo=args.slo)
    elif args.dataset == "templated":
        reqs = templated_requests(args.rate, args.requests,
                                  num_templates=args.num_templates,
                                  seed=args.seed + 1, slo=args.slo)
    elif args.dataset == "mixed":
        if args.bursty:
            ap.error("--bursty is not supported with --dataset mixed")
        reqs = mixed_requests(args.rate, args.requests, qa_frac=args.qa_frac,
                              seed=args.seed + 1, slo=args.slo)
    elif args.bursty:
        trace = bursty_trace(seed=args.seed)
        reqs = trace.sample_requests(args.requests, dataset=args.dataset,
                                     seed=args.seed + 1, slo=args.slo)
    else:
        reqs = poisson_requests(args.rate, args.requests,
                                dataset=args.dataset, seed=args.seed + 1,
                                slo=args.slo)
    if args.qa_frac is not None and args.dataset != "mixed":
        ap.error("--qa-frac only applies to --dataset mixed")
    disaggregate = None
    if args.disaggregate is not None:
        try:
            p, d = (int(x) for x in args.disaggregate.split(":"))
        except ValueError:
            ap.error("--disaggregate takes P:D (e.g. 2:2)")
        if p < 1 or d < 1:
            ap.error("--disaggregate needs at least one replica per pool")
        if chunk <= 0:
            ap.error("--disaggregate requires --chunk-tokens > 0 (the "
                     "prefill pool runs chunked prefill)")
        disaggregate = dict(prefill=p, decode=d,
                            margin_s=args.handoff_margin)
    fault_plan = None
    if args.fault_plan is not None:
        from ..serving.faults import FaultPlan
        try:
            fault_plan = FaultPlan.parse(args.fault_plan)
        except ValueError as e:
            ap.error(f"--fault-plan: {e}")
    brownout = dict(slo=args.slo if args.slo else 1.0) \
        if args.brownout else None
    if (args.replicas > 1 or args.autoscale or args.shed_factor > 0
            or disaggregate is not None or fault_plan is not None
            or brownout is not None):
        autoscale = (dict(min_replicas=1, max_replicas=args.replicas)
                     if args.autoscale else None)
        cluster = build_sim_cluster(
            cfg, args.replicas, args.policy, router=args.router,
            shed_factor=args.shed_factor or None, autoscale=autoscale,
            disaggregate=disaggregate, fault_plan=fault_plan,
            brownout=brownout, trace=trace_rec)
        return cluster.run(reqs)
    return build_sim_engine(cfg, args.policy, trace=trace_rec).run(reqs)


if __name__ == "__main__":
    main()
