"""Continuous batching scheduler (Orca-style iteration-level scheduling).

Admission is gated on paged-KV block availability through the
:class:`BlockManager`; finished sequences release their blocks at every
step; over-commit is resolved by preempt-and-recompute of the youngest
sequence (vLLM's recompute policy).

Two execution regimes:

  * **monolithic** (``chunk_tokens=None``) — ``schedule()`` admits waiting
    requests whole; the engine prefills the full prompt in one call before
    any decode work happens.  This is the seed behaviour and stays the
    default.
  * **chunked / hybrid** (``chunk_tokens=N``) — ``schedule_chunks()`` emits a
    :class:`ScheduledBatch` mixing prefill *chunks* (at most ``chunk_tokens``
    prompt tokens per step, the per-step token budget) with the decode-ready
    sequences.  A long prompt no longer stalls every running sequence for a
    whole monolithic prefill: its KV blocks are allocated chunk by chunk and
    decode proceeds in the same iterations (Sarathi/vLLM-style chunked
    prefill, the head-of-line fix for p99 TTFT under load).

Scheduling order inside one chunked step is FIFO and progress-guaranteed:
partially prefilled *running* sequences are continued first (so a sequence
mid-prefill is never starved by decode-only steps or newer arrivals), then
the remaining budget admits new requests from the waiting queue.  With
``prefill_order="slo"`` the admission pass picks the waiting request with
the earliest TTFT deadline instead of strict FIFO (FIFO among equal /
absent deadlines); the continue-first progress guarantee is unchanged.

Prefix sharing (``BlockManager(prefix_caching=True)``): admission looks up
the longest cached prefix of the prompt, maps those blocks into the new
sequence's table at refcount+1 and starts the first prefill chunk at the
match boundary — a cached prefix costs no prefill compute and no new
blocks.  Any write range covering a shared block is privatised first via
``fork_for_write`` (copy-on-write).

With a host KV tier attached (``BlockManager(host_store=...)``), the same
``match_prefix`` walk transparently *restores* spilled blocks: a hash that
misses the device index but hits the host store is re-registered into a
free device block (host→device copy queued for the physical tier) and
returned in ``shared`` like any device hit — so admission counts
restorable blocks as cached with no scheduler-side special-casing, and the
watermark arithmetic is unchanged (restores move blocks free→cached, both
sides of ``num_allocatable``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from .kv_cache import BlockManager, OutOfBlocks
from .request import Request, Sequence, class_rank


@dataclass
class ScheduledBatch:
    """One hybrid iteration's worth of work.

    ``prefill_chunks`` holds ``(seq, n_tokens)`` pairs — the prompt tokens
    each sequence prefills this step (KV blocks already reserved).
    ``decode`` holds the decode-ready sequences (prefill complete).
    ``admitted`` is the subset of chunk sequences newly admitted this step.
    """

    prefill_chunks: List[Tuple[Sequence, int]] = field(default_factory=list)
    decode: List[Sequence] = field(default_factory=list)
    admitted: List[Sequence] = field(default_factory=list)

    @property
    def prefill_tokens(self) -> int:
        return sum(n for _, n in self.prefill_chunks)

    @property
    def empty(self) -> bool:
        return not self.prefill_chunks and not self.decode


class ContinuousBatchingScheduler:
    def __init__(self, block_manager: BlockManager, *, max_batch: int = 64,
                 watermark_frac: float = 0.02,
                 chunk_tokens: Optional[int] = None,
                 min_chunk_tokens: Optional[int] = None,
                 prefill_order: str = "fifo"):
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1 (or None)")
        if prefill_order not in ("fifo", "slo"):
            raise ValueError(f"unknown prefill_order {prefill_order!r}")
        self.bm = block_manager
        self.max_batch = max_batch
        self.watermark_frac = watermark_frac
        self.chunk_tokens = chunk_tokens
        self.prefill_order = prefill_order
        # Sarathi-style total-token budget: each decode-ready sequence
        # consumes one of the step's chunk_tokens slots (the decode tokens
        # ride the same fused forward, so this is what actually bounds the
        # step's token count / TPOT spike).  At least min_chunk_tokens —
        # half the budget by default — stay reserved for prefill progress,
        # so a decode batch larger than the budget can never starve
        # admission/chunk progress outright.
        if min_chunk_tokens is None:
            min_chunk_tokens = max(1, (chunk_tokens or 0) // 2)
        self.min_chunk_tokens = min_chunk_tokens
        self.waiting: Deque[Request] = deque()
        self.running: List[Sequence] = []
        self._next_seq = 0
        # observability seam: engine.attach_trace wires these; trace_ctx
        # yields the live (clock, replica_id) so preemption events carry
        # engine time without the scheduler knowing about clocks
        self.trace = None
        self.trace_ctx = None

    # ------------------------------------------------------------------
    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def add_request(self, req: Request) -> None:
        self.waiting.append(req)

    # ------------------------------------------------------------------
    def schedule(self) -> List[Sequence]:
        """Admit waiting requests while blocks + batch slots allow
        (monolithic path: blocks for the WHOLE prompt up front; prefix
        caching is a chunked-path feature — monolithic prefill always
        recomputes)."""
        admitted: List[Sequence] = []
        watermark = int(self.bm.total_blocks * self.watermark_frac)
        while (self.waiting and len(self.running) < self.max_batch):
            req = self.waiting[0]
            need = self.bm.blocks_needed(req.prompt_len + 1)
            if self.bm.num_allocatable - need < watermark:
                break
            self.waiting.popleft()
            seq = Sequence(request=req)
            self.bm.allocate(self._seq_key(seq), req.prompt_len + 1)
            seq.prefilled = req.prompt_len  # engine prefills it whole
            self.running.append(seq)
            admitted.append(seq)
        return admitted

    # ------------------------------------------------------------------
    def schedule_chunks(self) -> ScheduledBatch:
        """Build one hybrid step under the per-step token budget.

        Invariants (regression-tested):
          * total tokens per step are budgeted Sarathi-style: emitted chunk
            tokens never exceed ``chunk_tokens`` minus one slot per
            decode-ready sequence (the decode tokens ride the same fused
            forward), floored at ``min_chunk_tokens`` so decode-heavy
            batches cannot crowd out chunk progress entirely;
          * running sequences mid-prefill are served before new admissions
            (no starvation by decode-only steps);
          * block reservation happens here, per chunk — a preempted
            half-prefilled sequence releases exactly what it reserved.
        """
        assert self.chunk_tokens is not None, "scheduler is monolithic"
        n_decode = sum(1 for s in self.running
                       if s.prompt_remaining == 0 and not s.done)
        budget = max(self.chunk_tokens - n_decode,
                     min(self.min_chunk_tokens, self.chunk_tokens))
        batch = ScheduledBatch()
        watermark = int(self.bm.total_blocks * self.watermark_frac)

        # 1. continue partially prefilled running sequences, FIFO
        for s in list(self.running):
            if budget <= 0:
                break
            rem = s.prompt_remaining
            if rem <= 0:
                continue
            n = min(rem, budget)
            if not self._reserve_chunk(s, n):
                continue  # s was preempted back to the waiting queue
            batch.prefill_chunks.append((s, n))
            budget -= n

        # 2. admit new requests into the remaining budget (earliest-SLO
        #    first under prefill_order="slo", FIFO otherwise; admission
        #    stops at the first request that cannot be served so a blocked
        #    head is never overtaken into starvation)
        while (budget > 0 and self.waiting
               and len(self.running) < self.max_batch):
            req = self._peek_waiting()
            shared: List[int] = []
            cached = 0
            if self.bm.prefix_caching and req.prompt_tokens is not None:
                # may include host-tier restores: blocks re-registered from
                # the HostKVStore count as cached here, their physical
                # host→device copy drains before the step's writes
                shared, matched = self.bm.match_prefix(req.prompt_tokens)
                # at least one prompt position must be recomputed so the
                # step produces logits for the first output token
                cached = min(matched, max(req.prompt_len - 1, 0))
            n = min(req.prompt_len - cached, budget)
            # blocks this admission may consume: table growth past the
            # shared prefix plus worst-case CoW forks of shared blocks the
            # first chunk writes into (the fully-cached-prompt recompute)
            need = max(self.bm.blocks_needed(cached + n) - len(shared), 0) \
                + self.bm.shared_blocks_in_range(shared, cached, cached + n)
            if self.bm.num_allocatable - need < watermark:
                break
            self.waiting.remove(req)
            seq = Sequence(request=req)
            key = self._seq_key(seq)
            try:
                if shared:
                    self.bm.share(key, shared, cached)
                    seq.cached_tokens = cached
                    seq.prefilled = cached
                    self.bm.fork_for_write(key, cached, cached + n)
                    self.bm.grow_to(key, cached + n)
                else:
                    self.bm.allocate(key, n)
            except OutOfBlocks:
                # the conservative `need` estimate can still lose a race
                # against same-step growth: roll back and retry next step
                self.bm.release(key)
                self.waiting.appendleft(req)
                break
            self.running.append(seq)
            batch.admitted.append(seq)
            batch.prefill_chunks.append((seq, n))
            budget -= n

        # chunks whose sequence was preempted later in this same pass are
        # void — drop them by object identity (the same request may have
        # been re-admitted above as a fresh Sequence under the same key)
        alive = {id(s) for s in self.running}
        batch.prefill_chunks = [(s, n) for s, n in batch.prefill_chunks
                                if id(s) in alive]
        batch.admitted = [s for s in batch.admitted if id(s) in alive]
        batch.decode = [s for s in self.running
                        if s.prompt_remaining == 0 and not s.done]
        return batch

    def _peek_waiting(self) -> Request:
        """Next admission candidate: FIFO head, or — under
        ``prefill_order="slo"`` — highest priority class first, then the
        earliest TTFT deadline (arrival + slo; deadline-free requests
        sort last, FIFO among equals).  A single-class queue orders
        exactly as before classes existed."""
        if self.prefill_order == "fifo" or len(self.waiting) <= 1:
            return self.waiting[0]
        return min(self.waiting,
                   key=lambda r: (class_rank(r.priority),
                                  r.arrival + r.slo if r.slo is not None
                                  else float("inf"), r.arrival, r.req_id))

    def _reserve_chunk(self, seq: Sequence, n: int) -> bool:
        """Reserve KV blocks for the next ``n`` prompt tokens of ``seq``;
        on exhaustion evict the youngest other sequence, then ``seq``
        itself (recompute policy, same as the decode commit path).  Any
        shared block the chunk writes into is privatised first (CoW)."""
        key = self._seq_key(seq)
        if key not in self.bm.tables:
            return False
        target = seq.prefilled + n
        try:
            self.bm.fork_for_write(key, seq.prefilled, target)
            self.bm.grow_to(key, target)
            return True
        except OutOfBlocks:
            self._preempt_youngest(exclude=seq)
            try:
                self.bm.fork_for_write(key, seq.prefilled, target)
                self.bm.grow_to(key, target)
                return True
            except OutOfBlocks:
                self._preempt(seq)
                return False

    def _seq_key(self, seq: Sequence) -> int:
        return seq.req_id

    def note_prefill_progress(self, seq: Sequence, *, draft_ok: bool) -> None:
        """Publish freshly materialised full prompt blocks in the prefix
        cache.  Only draft-covered prefixes register: a cached block must be
        valid in BOTH paged pools so a sharing sequence can speculate
        without a draft catch-up write into shared blocks."""
        if draft_ok and self.bm.prefix_caching:
            self.bm.register_prefix(self._seq_key(seq),
                                    seq.request.prompt_tokens, seq.prefilled)

    # ------------------------------------------------------------------
    def commit_tokens(self, seq: Sequence, n: int) -> bool:
        """Record n committed tokens; returns False if the sequence had to be
        preempted (blocks exhausted)."""
        key = self._seq_key(seq)
        if key not in self.bm.tables:
            return False  # already preempted this step
        end = self.bm.lengths[key] + n
        try:
            self.bm.fork_for_write(key, self.bm.lengths[key], end)
            self.bm.append_tokens(key, n)
            seq.generated += n
            return True
        except OutOfBlocks:
            self._preempt_youngest(exclude=seq)
            try:
                self.bm.fork_for_write(key, self.bm.lengths[key], end)
                self.bm.append_tokens(key, n)
                seq.generated += n
                return True
            except OutOfBlocks:
                self._preempt(seq)
                return False

    @staticmethod
    def _age_key(seq: Sequence) -> Tuple[int, float, int]:
        """Strict total preemption order: lowest priority class first,
        age-ordered within a class.  A lower-class sequence is 'younger'
        than every higher-class one regardless of arrival, so interactive
        work can displace older best_effort work but never vice versa;
        a uniform-class batch reduces to the original (arrival, req_id)
        order, preserving the anti-livelock guarantee."""
        return (class_rank(seq.request.priority),
                seq.request.arrival, seq.req_id)

    def _preempt_youngest(self, exclude: Optional[Sequence] = None) -> None:
        """Evict the youngest running sequence to free blocks — but only if
        it is younger than the sequence asking (strict class-then-age
        priority).  A young sequence may never displace older work:
        without this guard two prompts that cannot coexist in the pool
        evict each other in an endless recompute ping-pong (each restart
        re-evicts the other's blocks), and neither ever finishes.  With
        it, the younger of the two preempts itself and waits for the
        elder to complete."""
        candidates = [s for s in self.running if s is not exclude]
        if exclude is not None:
            key = self._age_key(exclude)
            candidates = [s for s in candidates if self._age_key(s) > key]
        if not candidates:
            return
        victim = max(candidates, key=self._age_key)
        self._preempt(victim)

    def preempt(self, seq: Sequence) -> None:
        """Public preempt-and-recompute: the engine preempts sequences whose
        physical KV reservation failed (paged real backend) before the step
        executes, so no write can touch another sequence's blocks."""
        self._preempt(seq)

    def _preempt(self, seq: Sequence) -> None:
        """Recompute policy: release blocks, requeue at the front.  A
        half-prefilled sequence restarts from scratch — the fresh Sequence
        built at re-admission has ``prefilled == generated == 0``."""
        self.bm.release(self._seq_key(seq))
        if seq in self.running:
            self.running.remove(seq)
        req = seq.request
        # recompute from scratch: prompt + already-generated tokens count
        self.waiting.appendleft(req)
        tr = self.trace
        if tr is not None and tr.enabled and self.trace_ctx is not None:
            t, rep = self.trace_ctx()
            tr.instant("engine", "preempt", t, replica=rep,
                       args={"req": seq.req_id, "prefilled": seq.prefilled,
                             "generated": seq.generated})
            tr.req_stage(seq.req_id, t, "stall", rep)

    def finish(self, seq: Sequence) -> None:
        self.bm.release(self._seq_key(seq))
        if seq in self.running:
            self.running.remove(seq)
