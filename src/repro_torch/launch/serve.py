"""Serving entry point of the port (real execution tier).

  PYTHONPATH=src python -m repro_torch.launch.serve --tier real --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --tier real --device cpu \
      --dataset templated --chunk-tokens 8 --prefix-caching on

``main`` serves ``configs.reduced`` models, as the reference's real tier
does; :func:`build_real_engine` takes any config pair (``chip_smoke.py``
serves the full-width paper-7b pair through it).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Tuple

from .. import configs
from ..configs.base import ModelConfig
from ..core.bandits import make_policy
from ..models import registry
from ..serving.costmodel import H100_SXM, RooflineCostModel
from ..serving.engine import ServingEngine
from ..serving.kv_cache import BlockManager, HostKVStore
from ..serving.memory_manager import ElasticMemoryManager
from ..serving.paged_runtime import num_blocks_for
from ..serving.real_backend import RealBackend
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
    physical paged pools, sized from the H100 memory budget; the elastic
    memory manager can offload the draft and grow / migrate / shrink the
    pools.  ``dtype`` overrides both configs' dtype.  ``params`` is a
    (target, draft) pair of parameter trees; without it both are seeded
    from ``seed``.  Prefix caching needs a chunk budget (the monolithic
    scheduler always recomputes prompts)."""
    if dtype is not None:
        cfg, dcfg = cfg.replace(dtype=dtype), dcfg.replace(dtype=dtype)
    target, draft = registry.get_model(cfg), registry.get_model(dcfg)
    cm = RooflineCostModel(H100_SXM)
    nb = num_blocks_for(cm, cfg, dcfg, BLOCK_SIZE, max_blocks=MAX_BLOCKS)
    bm = BlockManager(nb, BLOCK_SIZE, prefix_caching=prefix_caching,
                      host_store=HostKVStore(4 * nb) if kv_offload else None)
    backend = RealBackend(target, draft, device=device, params=params,
                          max_batch=MAX_BATCH, seed=seed, block_manager=bm)
    sched = ContinuousBatchingScheduler(bm, max_batch=MAX_BATCH,
                                        chunk_tokens=chunk_tokens,
                                        prefill_order=prefill_order)
    mm = None
    if memmgr:
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-7b",
                    choices=configs.list_archs())
    ap.add_argument("--policy", default="nightjar")
    ap.add_argument("--tier", choices=["real"], default="real")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--dataset", choices=["tiny", "templated"],
                    default="tiny")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="per-step prefill token budget (0 = monolithic)")
    ap.add_argument("--prefix-caching", choices=["on", "off"], default="off")
    ap.add_argument("--prefill-order", choices=["fifo", "slo"],
                    default="fifo")
    ap.add_argument("--kv-offload", action="store_true",
                    help="host-memory KV spill tier (needs --prefix-caching "
                         "on)")
    ap.add_argument("--no-offload", action="store_true",
                    help="no elastic memory manager (draft stays resident)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.kv_offload and args.prefix_caching != "on":
        ap.error("--kv-offload requires --prefix-caching on")

    from ..serving.workload import tiny_requests
    cfg = configs.reduced(configs.get_config(args.arch))
    dcfg = configs.reduced(configs.get_draft_config(args.arch))
    engine = build_real_engine(
        cfg, dcfg, device=args.device,
        chunk_tokens=args.chunk_tokens or None,
        prefix_caching=args.prefix_caching == "on",
        kv_offload=args.kv_offload, memmgr=not args.no_offload,
        policy=args.policy, prefill_order=args.prefill_order,
        seed=args.seed)
    reqs = tiny_requests(min(args.requests, 16), rate_qps=args.rate,
                         prompt_len=16, output_len=16, vocab=cfg.vocab_size,
                         seed=args.seed,
                         template_len=8 if args.dataset == "templated" else 0)
    metrics = engine.run(reqs, max_steps=5000)
    print(json.dumps(metrics.summary(), indent=1))


if __name__ == "__main__":
    main()
