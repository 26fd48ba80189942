"""Elastic memory manager — paper §6: squeeze/expand between draft-model
weights and the paged KV pool.

Triggers (§6.1, hysteresis):
  EXPANSION  — speculation disabled AND N_free < tau_low persisting
               T_persist steps: offload the draft weights to host memory,
               then attach N_draft = ceil(S_draft / B_block) blocks to the
               pool at K_boundary.
  CONTRACTION — |Q_wait| == 0 AND N_free > N_draft + tau_low: build the
               migration plan (§6.4), execute the vectorised block moves,
               commit the logical remapping, trim the pool, reload the draft.

Transfers are modelled as asynchronous (CUDA-stream analogue, §6.2): the
manager records a completion time and the engine's clock only blocks if it
*consumes* the resource before the transfer finishes — offload/reload never
stall the decode path.

With a host KV tier attached to the BlockManager (``host_store``), memory
pressure offloads instead of discarding: every cached-reusable block
``plan_contraction`` evicts is spilled to the ``HostKVStore``, and the
``flush_fn`` hook (``RealBackend.apply_host_transfers`` on the real tier)
runs between planning and the §6.4 data movement so those blocks' pages
are captured BEFORE migration reuses their below-boundary targets and
``shrink_fn`` trims the high region.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .kv_cache import BlockManager, MigrationPlan


@dataclass
class MemoryEvent:
    kind: str        # offload | expand | contract | reload
    at: float
    latency: float
    detail: dict = field(default_factory=dict)


class ElasticMemoryManager:
    def __init__(self, bm: BlockManager, *, draft_blocks: int,
                 tau_low_frac: float = 0.1, t_persist: int = 3,
                 offload_latency: float = 0.0, reload_latency: float = 0.0,
                 migrate_fn: Optional[Callable[[MigrationPlan], float]] = None,
                 offload_fn: Optional[Callable[[], None]] = None,
                 reload_fn: Optional[Callable[[], None]] = None,
                 grow_fn: Optional[Callable[[int], None]] = None,
                 shrink_fn: Optional[Callable[[int], None]] = None,
                 flush_fn: Optional[Callable[[], None]] = None):
        self.bm = bm
        self.draft_blocks = draft_blocks          # N_draft
        self.tau_low_frac = tau_low_frac
        self.t_persist = t_persist
        self.offload_latency = offload_latency
        self.reload_latency = reload_latency
        self.migrate_fn = migrate_fn
        self.offload_fn = offload_fn
        self.reload_fn = reload_fn
        # physical-pool hooks (real tier): grow_fn extends the paged page
        # arrays in lockstep with bm.expand; shrink_fn trims them after the
        # logical contraction commits (PagedKVRuntime.grow/shrink via
        # RealBackend.grow_pools/shrink_pools).  None on the simulated tier.
        self.grow_fn = grow_fn
        self.shrink_fn = shrink_fn
        # host-tier spill flush (real tier: RealBackend.apply_host_transfers)
        # — must run after plan_contraction queued its spills and before the
        # migration/shrink overwrite or trim the spilled blocks' pages
        self.flush_fn = flush_fn

        self.draft_resident = True
        self.expanded = False
        self._low_mem_streak = 0
        self._busy_until = 0.0     # async transfer in flight
        # brownout ladder (controlplane.BrownoutController): while set, the
        # draft offloads IMMEDIATELY (no low-memory streak needed — the
        # fleet controller already decided KV capacity beats speculation)
        # and contraction is suppressed until the stage clears
        self.force_offload = False
        self.events: List[MemoryEvent] = []

    # ------------------------------------------------------------------
    @property
    def tau_low(self) -> int:
        return max(int(self.bm.base_blocks * self.tau_low_frac), 1)

    def can_speculate(self, now: float) -> bool:
        """Draft usable: resident and any reload transfer completed."""
        return self.draft_resident and now >= self._busy_until

    # ------------------------------------------------------------------
    def step(self, now: float, *, spec_disabled: bool, waiting: int) -> None:
        """Called once per scheduling step with the current system state."""
        if now < self._busy_until:
            return  # a transfer is still in flight — §6.2 non-blocking

        if self.draft_resident:
            if self.force_offload:
                # brownout draft-offload stage: reclaim the draft's KV share
                # for batch growth NOW, not after a streak
                self._offload_and_expand(now)
                return
            # track the low-memory streak only while speculation is disabled
            # (cached-reusable prefix blocks count as reclaimable capacity:
            # evicting the cache is always cheaper than offloading the draft)
            if spec_disabled and self.bm.num_allocatable < self.tau_low:
                self._low_mem_streak += 1
            else:
                self._low_mem_streak = 0
            if self._low_mem_streak >= self.t_persist:
                self._offload_and_expand(now)
            return

        # draft offloaded: contraction when the queue is drained and there is
        # room for the draft plus the safety buffer (hysteresis, §6.1) —
        # never while the brownout ladder holds the draft off-device
        if (self.expanded and waiting == 0 and not self.force_offload
                and self.bm.num_allocatable > self.draft_blocks + self.tau_low):
            self._contract_and_reload(now)

    # ------------------------------------------------------------------
    def _offload_and_expand(self, now: float) -> None:
        if self.offload_fn is not None:
            self.offload_fn()
        self.draft_resident = False
        self._busy_until = now + self.offload_latency
        self.events.append(MemoryEvent("offload", now, self.offload_latency))
        start, end = self.bm.expand(self.draft_blocks)
        if self.grow_fn is not None:
            self.grow_fn(self.draft_blocks)   # physical pages follow §6.3
        self.expanded = True
        self._low_mem_streak = 0
        self.events.append(MemoryEvent(
            "expand", now, 0.0, {"range": (start, end)}))

    def _contract_and_reload(self, now: float) -> None:
        plan = self.bm.plan_contraction()
        if plan is None and self.bm.total_blocks != self.bm.base_blocks:
            return  # §6.4 step 2 verification failed — retry later
        migrate_latency = 0.0
        if plan is not None:
            if self.flush_fn is not None:
                self.flush_fn()   # capture contraction-time spills first
            if self.migrate_fn is not None:
                migrate_latency = self.migrate_fn(plan) or 0.0
            self.bm.commit_contraction(plan)
            self.events.append(MemoryEvent(
                "contract", now, migrate_latency,
                {"migrated_blocks": len(plan)}))
        else:
            self.bm.total_blocks = self.bm.base_blocks
            self.bm.free = [b for b in self.bm.free if b < self.bm.boundary]
            self.events.append(MemoryEvent("contract", now, 0.0,
                                           {"migrated_blocks": 0}))
        if self.shrink_fn is not None:
            self.shrink_fn(self.bm.base_blocks)  # physical pages follow §6.4
        self.expanded = False
        if self.reload_fn is not None:
            self.reload_fn()
        self.draft_resident = True
        self._busy_until = now + self.reload_latency + migrate_latency
        self.events.append(MemoryEvent("reload", now, self.reload_latency))
