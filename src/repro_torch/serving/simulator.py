"""Simulated execution backend — paper-scale serving on the analytical tier.

Latencies come from the roofline cost model; acceptance is a per-request
Bernoulli chain (a request's per-token acceptance probability alpha_i is
drawn from the dataset's Beta distribution).  Everything else — scheduler,
planner, elastic memory manager — is the real thing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np

from ..configs.base import ModelConfig
from ..core.bandits import Policy, make_policy
from ..core.cswitch import CSwitchTable
from .cluster import DECODE, PREFILL, ServingCluster
from .controlplane import (AdmissionController, AutoscaleController,
                           BrownoutController, ControlPlane,
                           DecodePoolAutoscaler, HandoffPricer)
from .costmodel import H100_SXM, HardwareProfile, RooflineCostModel, kv_bytes_per_token
from .engine import ServingEngine, StepOutcome
from .kv_cache import BlockManager
from .memory_manager import ElasticMemoryManager
from .request import Request, Sequence
from .router import make_router
from .scheduler import ContinuousBatchingScheduler


class SimulatedBackend:
    def __init__(self, target: ModelConfig, draft: ModelConfig,
                 cost_model: RooflineCostModel, *, seed: int = 0,
                 block_size: int = 16):
        self.target = target
        self.draft = draft
        self.cm = cost_model
        self.rng = np.random.default_rng(seed)
        self.block_size = block_size

    def host_transfer_latency(self, n_spill: int, n_restore: int) -> float:
        """Modelled host KV tier transfer cost for one drain (engine
        ``_drain_host_transfers``).  Restores gate the admitted sequence's
        prefill, so their host→device copy is synchronous and priced at the
        PCIe-analogue ``host_link_bw`` over both pools' block bytes; spills
        ride the async DMA stream (§6.2 semantics, same as draft offload)
        and cost nothing on the critical path."""
        if n_restore <= 0:
            return 0.0
        per_tok = (kv_bytes_per_token(self.target)
                   + kv_bytes_per_token(self.draft))
        return n_restore * self.block_size * per_tok / self.cm.hw.host_link_bw

    def kv_transfer_seconds(self, n_tokens: int) -> float:
        """Modelled prefill→decode KV migration time for one handoff
        (disaggregated fleets): both pools' KV bytes for the prompt, moved
        over the inter-replica interconnect — the chip-to-chip link
        (``ici_bw``) where the profile has one, else the host link (the
        host KV spill path's bandwidth class) — plus one fixed step
        overhead for the batched
        block-descriptor exchange.  This is what the ``HandoffPricer``
        charges against the queue-delay forecast saved."""
        per_tok = (kv_bytes_per_token(self.target)
                   + kv_bytes_per_token(self.draft))
        bw = self.cm.hw.ici_bw or self.cm.hw.host_link_bw
        return n_tokens * per_tok / bw + self.cm.hw.step_overhead

    # ------------------------------------------------------------------
    def _ctx(self, seqs: List[Sequence]) -> int:
        return max((s.context_len for s in seqs), default=1)

    def prefill(self, seqs: List[Sequence], *, with_draft: bool) -> float:
        # continuous batching processes prefill as a token stream (no
        # padded-batch waste): cost ~ total prompt tokens + one weight pass
        total = sum(s.request.prompt_len for s in seqs)
        t = self.cm.prefill_latency(self.target, 1, total)
        if with_draft:
            t += self.cm.prefill_latency(self.draft, 1, total)
        return t

    def draft_catchup(self, seqs: List[Sequence]) -> float:
        delta_max = max((s.delta for s in seqs), default=0)
        if delta_max == 0:
            return 0.0
        return self.cm.prefill_latency(self.draft, len(seqs), delta_max)

    def hybrid_step(self, chunks: List, decode: List[Sequence], gamma: int,
                    *, with_draft: bool) -> StepOutcome:
        """Mixed batch: prefill chunks fused with the decode batch.

        ``n_committed`` is per DECODE sequence; chunk progress is recorded by
        the engine.  With no chunks in flight this is exactly ``step`` (same
        cost, same acceptance draws)."""
        prefill_tokens = sum(n for _, n in chunks)
        if prefill_tokens == 0:
            return self.step(decode, gamma)
        assert gamma == 0, "speculation is disabled while chunks are in flight"
        B = len(decode)
        ctx = self._ctx(decode) if decode else 1
        prefill_ctx = max((s.prefilled + n for s, n in chunks), default=1)
        lat = self.cm.hybrid_step_latency(self.target, prefill_tokens, B, ctx,
                                          prefill_ctx=prefill_ctx)
        if with_draft:
            # the draft prefills the same chunk stream to keep its KV current
            lat += self.cm.prefill_latency(self.draft, 1, prefill_tokens)
        n = [min(1, s.request.output_len - s.generated) for s in decode]
        return StepOutcome(n_committed=n, latency=lat)

    def step(self, seqs: List[Sequence], gamma: int) -> StepOutcome:
        B = len(seqs)
        ctx = self._ctx(seqs)
        if gamma == 0:
            lat = self.cm.ar_step_latency(self.target, B, ctx)
            n = [min(1, s.request.output_len - s.generated) for s in seqs]
            return StepOutcome(n_committed=n, latency=lat)
        lat = self.cm.spec_step_latency(self.target, self.draft, B, ctx, gamma)
        n_committed = []
        for s in seqs:
            # chain acceptance: accept while Bernoulli(alpha) succeeds
            acc = 0
            while acc < gamma and self.rng.uniform() < s.request.alpha:
                acc += 1
            n = acc + 1  # bonus / correction token
            n = min(n, s.request.output_len - s.generated)
            n_committed.append(max(n, 0))
        return StepOutcome(n_committed=n_committed, latency=lat)

    def release(self, seq: Sequence) -> None:
        pass


# ---------------------------------------------------------------------------
# Convenience constructor for paper-style experiments
# ---------------------------------------------------------------------------


@dataclass
class SimConfig:
    target: ModelConfig
    draft: ModelConfig
    hw: HardwareProfile = H100_SXM
    gamma_max: int = 5
    block_size: int = 16
    max_batch: int = 64
    chunk_tokens: int = 0     # >0: chunked-prefill hybrid batching budget
    prefix_caching: bool = False   # CoW prefix sharing (chunked path)
    prefill_order: str = "fifo"    # waiting-queue admission: fifo | slo
    tau_low_frac: float = 0.1
    t_persist: int = 3
    enable_offload: bool = True
    kv_reserve_frac: float = 0.1
    seed: int = 0
    num_blocks: Optional[int] = None  # explicit device pool size (None =
                                      # derive from the roofline HBM budget)
    kv_offload: bool = False  # host-memory spill tier for evicted prefix
                              # blocks (requires prefix_caching)
    host_kv_blocks: int = 0   # host tier capacity (0 = 4x the device pool)


def build_sim_engine(cfg: SimConfig, policy_name: str = "nightjar",
                     *, policy: Optional[Policy] = None,
                     trace=None) -> ServingEngine:
    cm = RooflineCostModel(cfg.hw)
    backend = SimulatedBackend(cfg.target, cfg.draft, cm, seed=cfg.seed,
                               block_size=cfg.block_size)

    capacity_tokens = cm.kv_capacity_tokens(cfg.target, cfg.draft,
                                            reserve_frac=cfg.kv_reserve_frac)
    num_blocks = (cfg.num_blocks if cfg.num_blocks is not None
                  else max(capacity_tokens // cfg.block_size, 64))
    host_store = None
    if cfg.kv_offload and cfg.prefix_caching:
        from .kv_cache import HostKVStore
        host_store = HostKVStore(cfg.host_kv_blocks or 4 * num_blocks)
    bm = BlockManager(num_blocks, cfg.block_size,
                      prefix_caching=cfg.prefix_caching,
                      host_store=host_store)
    sched = ContinuousBatchingScheduler(
        bm, max_batch=cfg.max_batch,
        chunk_tokens=cfg.chunk_tokens if cfg.chunk_tokens > 0 else None,
        prefill_order=cfg.prefill_order)

    block_bytes = cfg.block_size * kv_bytes_per_token(cfg.target)
    draft_blocks = max(math.ceil(cm.weight_bytes(cfg.draft) / block_bytes), 1)

    memmgr = None
    if cfg.enable_offload:
        memmgr = ElasticMemoryManager(
            bm,
            draft_blocks=draft_blocks,
            tau_low_frac=cfg.tau_low_frac,
            t_persist=cfg.t_persist,
            offload_latency=cm.offload_latency(cfg.draft),
            reload_latency=cm.reload_latency(cfg.draft),
            migrate_fn=lambda plan: len(plan) * bm.block_size
            * kv_bytes_per_token(cfg.target) / cfg.hw.hbm_bw,
        )

    if policy is None:
        cswitch = CSwitchTable.from_cost_model(cm, cfg.draft)
        policy = make_policy(policy_name, cfg.gamma_max, cswitch=cswitch,
                             seed=cfg.seed)
    eng = ServingEngine(backend, sched, policy, memmgr,
                        gamma_max=cfg.gamma_max)
    if trace is not None:
        eng.attach_trace(trace)
    return eng


def build_sim_cluster(cfg: SimConfig, n_replicas: int,
                      policy_name: str = "nightjar", *,
                      router: str = "jsq",
                      router_kwargs: Optional[dict] = None,
                      shed_factor: Optional[float] = None,
                      class_weights: Optional[dict] = None,
                      autoscale: Optional[dict] = None,
                      disaggregate: Optional[dict] = None,
                      fault_plan=None,
                      retry_policy=None,
                      brownout=None,
                      cancels=None,
                      trace=None) -> ServingCluster:
    """N independent simulated replicas behind one router + control plane.

    Every replica gets its OWN scheduler, planner, elastic memory manager
    and acceptance RNG (seed offset by replica index so replicas do not see
    correlated acceptance draws), exactly like N separate serving processes
    behind a front-end.  Replicas the autoscaler adds later come from the
    same seeded factory (seed offset by replica id), so an elastic run is
    exactly as reproducible as a static one.

    ``shed_factor`` enables admission control (shed at the door when every
    replica's predicted TTFT exceeds ``slo * shed_factor``); ``autoscale``
    is a kwargs dict for :class:`AutoscaleController` (e.g.
    ``dict(min_replicas=1, max_replicas=4)``) enabling elastic scaling —
    the cluster then STARTS at ``min_replicas`` and grows on demand.

    ``disaggregate`` splits the fleet into prefill and decode pools:
    ``dict(prefill=2, decode=2)`` (overrides ``n_replicas``), optionally
    ``margin_s`` (pricer hysteresis) and ``decode_autoscale`` (kwargs for
    :class:`DecodePoolAutoscaler`).  Arrivals land on the prefill pool
    (which must run chunked prefill) and migrate to a decode replica
    after prefill whenever the priced KV handoff beats staying put.

    ``fault_plan`` (a :class:`~repro_torch.serving.faults.FaultPlan` or a spec
    string for :meth:`FaultPlan.parse`) arms a seeded
    :class:`~repro_torch.serving.faults.FaultInjector` (seed = ``cfg.seed``, so
    the same plan + seed reproduces the exact same fault schedule);
    ``retry_policy`` overrides the crash-recovery
    :class:`~repro_torch.serving.faults.RetryPolicy`.

    ``class_weights`` makes admission shedding priority-aware (per-class
    threshold multipliers — see :class:`AdmissionController`).
    ``brownout`` arms the fleet brownout ladder: a kwargs dict for
    :class:`BrownoutController` (or a pre-built instance); ``cancels`` is
    an explicit client-cancellation schedule of ``(t, req_id)`` pairs
    (e.g. ``workload.cancellation_storm``).

    ``trace`` attaches a :class:`~repro_torch.serving.observability.TraceRecorder`
    through the whole fleet (engines, brownout controller, fault injector;
    replicas added later inherit it)."""

    def factory(i: int) -> ServingEngine:
        return build_sim_engine(replace(cfg, seed=cfg.seed + i), policy_name)

    admission = None
    if shed_factor is not None and shed_factor > 0:
        admission = AdmissionController(shed_factor=shed_factor,
                                        class_weights=class_weights)
    autoscaler = None
    if autoscale is not None:
        autoscaler = AutoscaleController(**autoscale)
        n_replicas = autoscaler.min_replicas
    roles = None
    pricer = None
    decode_autoscaler = None
    if disaggregate is not None:
        if cfg.chunk_tokens <= 0:
            raise ValueError("disaggregation requires chunked prefill "
                             "(cfg.chunk_tokens > 0)")
        n_prefill = int(disaggregate.get("prefill", max(n_replicas // 2, 1)))
        n_decode = int(disaggregate.get("decode",
                                        max(n_replicas - n_prefill, 1)))
        if autoscaler is not None:
            n_prefill = autoscaler.min_replicas
        roles = [PREFILL] * n_prefill + [DECODE] * n_decode
        n_replicas = len(roles)
        da = disaggregate.get("decode_autoscale")
        if da is not None:
            decode_autoscaler = DecodePoolAutoscaler(**da)
    faults = None
    if fault_plan is not None:
        from .faults import FaultInjector, FaultPlan
        plan = (FaultPlan.parse(fault_plan) if isinstance(fault_plan, str)
                else fault_plan)
        if not plan.empty:
            faults = FaultInjector(plan, seed=cfg.seed)
    bo = None
    if brownout is not None:
        bo = (brownout if isinstance(brownout, BrownoutController)
              else BrownoutController(**brownout))
    engines = [factory(i) for i in range(n_replicas)]
    control = ControlPlane(admission=admission, autoscaler=autoscaler)
    if disaggregate is not None:
        pricer = HandoffPricer(control,
                               margin_s=disaggregate.get("margin_s", 0.0))
    cluster = ServingCluster(engines, make_router(router,
                                                  **(router_kwargs or {})),
                             control=control, replica_factory=factory,
                             roles=roles, pricer=pricer,
                             decode_autoscaler=decode_autoscaler,
                             faults=faults, retry_policy=retry_policy,
                             brownout=bo, cancels=cancels)
    if trace is not None:
        cluster.attach_trace(trace)
    return cluster
