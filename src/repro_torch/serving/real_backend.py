"""Real-execution backends: the port's models behind the serving engine.

Two implementations share the backend protocol; :func:`make_real_backend`
picks one per model pair.

:class:`RealBackend`, the paged-KV runtime, allocates
``(L, num_blocks + 1, block_size, KH, hd)`` key/value pools per model ONCE
and drives them by the :class:`BlockManager`'s block tables: admission,
decode, speculative verification, chunked prefill, eviction and completion
touch only int32 tables and sampled tokens — the cache tensors never
travel.  One multi-query
paged-attention kernel serves plain decode (T=1), speculative verify
(T=gamma+1) and prefill / chunked-prefill appends (T=chunk).  The chunked
scheduler's ragged extensions — ``hybrid_step``'s mixed chunk + decode
rows, for the target and the draft, and ``draft_catchup`` — are packed
calls: one model call over exactly their rows' real positions, with logits
only at each row's last one (``models/transformer.decode_step_paged``).
Monolithic ``prefill`` and the pure-decode steps run padded calls.

:class:`DenseSlotBackend` keeps dense ``(L, max_batch, max_seq, KH, hd)``
caches in fixed slots: each step gathers the active slots, runs the
dense-cache spec / AR step and scatters them back, and prefill runs one
prompt at a time through the full-sequence attention (the flash kernel on
the card).  It is the tier for models without a paged path — the ssm
(mamba2) and hybrid (zamba2) families, whose O(1) state lives in the slots
— and the baseline the paged runtime is held equal to.

Latencies are host clock around work that ends in a device synchronise —
what the planner learns from on this tier.

With a clocked ``TraceRecorder`` attached (``ServingEngine.attach_trace``
sets ``RealBackend.spans``), each call into the backend records its phases
inside the engine's ``engine.execute`` span: ``backend.copies`` (host-tier
transfers and CoW forks), ``backend.pack`` (step operands, block tables,
host-to-device uploads; its args count the positions a model call runs,
``positions_run``, against the real ones, ``positions_valid``: equal in a
packed call; for a target with sliding-window layers, also the K/V
positions one full layer and one sliding layer read over the call's real
rows, ``kv_read_full`` and ``kv_read_window``; a pure-decode or spec
step's also lists each real row's context, ``starts``),
``backend.dispatch`` (enqueueing the model call; its ``graph`` arg says
how: ``eager``, or ``capture`` / ``replay`` of a step graph),
``backend.sync`` (the wait in the device synchronise) and
``backend.unpack`` (device-to-host copies, per-sequence bookkeeping).

On the card, with greedy sampling, :meth:`RealBackend.step` replays a
captured graph of its padded-layout model call, one per (batch bucket of
1, 4, 16, ..., table width, gamma), made before serving
(:meth:`RealBackend.capture_steps`, which the engine calls when it is
built; ``serving/step_graphs.py``); every other call, and every call on
the CPU, runs eagerly.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core.spec_decode import (make_ar_step, make_paged_ar_step,
                                make_paged_spec_step, make_spec_step)
from ..models.registry import ModelAPI, tree_to
from .engine import StepOutcome
from .kv_cache import BlockManager, OutOfBlocks
from .paged_runtime import (PagedKVRuntime, apply_copies, bucket_size,
                            num_blocks_for)
from .request import Sequence
from .step_graphs import CudaGraph, StepGraphs, uncounted


def make_real_backend(target: ModelAPI, draft: ModelAPI, **kw):
    """The paged runtime when both models have a paged-KV path (attention
    families); dense slot caches otherwise (the paged-only arguments are
    dropped)."""
    if target.supports_paged and draft.supports_paged:
        return RealBackend(target, draft, **kw)
    for k in ("block_manager", "num_blocks", "block_size", "cost_model"):
        kw.pop(k, None)
    return DenseSlotBackend(target, draft, **kw)


class RealBackend:
    """Zero-copy continuous batching over paged KV pools.

    When ``block_manager`` is the scheduler's own instance, the scheduler's
    logical admission decisions and the physical pool are one and the same
    object (the intended wiring — see ``launch/serve.py``).  Without one, a
    private BlockManager sized for ``max_batch x max_seq`` (or from
    ``cost_model.kv_capacity_tokens``) is created and mirrored internally.

    ``params`` is a (target, draft) pair of parameter trees on ``device``;
    without it both models are initialised from ``seed``.
    """

    def __init__(self, target: ModelAPI, draft: ModelAPI, *,
                 device="cuda", params: Optional[Tuple[dict, dict]] = None,
                 max_batch: int = 8, max_seq: int = 256, seed: int = 0,
                 sampling: str = "greedy", temperature: float = 1.0,
                 block_manager: Optional[BlockManager] = None,
                 block_size: int = 8, num_blocks: Optional[int] = None,
                 cost_model=None):
        if not (target.supports_paged and draft.supports_paged):
            raise NotImplementedError(
                "RealBackend is the paged-KV runtime; both models need a "
                "paged decoder")
        self.device = _device.resolve(device)
        self.target = target
        self.draft = draft
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.sampling = sampling
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        if params is None:
            params = (target.init(device=self.device, seed=seed + 1),
                      draft.init(device=self.device, seed=seed + 2))
        self.tparams, self.dparams = params
        self.dparams_host: Optional[dict] = None  # offloaded copy

        if block_manager is None:
            if num_blocks is None:
                if cost_model is not None:
                    num_blocks = num_blocks_for(cost_model, target.cfg,
                                                draft.cfg, block_size)
                else:
                    num_blocks = (-(-max_batch * max_seq // block_size)
                                  + 2 * max_batch)
            block_manager = BlockManager(num_blocks, block_size)
            self._owns_bm = True
        else:
            self._owns_bm = False
        self.bm = block_manager
        self.tkv = PagedKVRuntime(target, self.bm, device=self.device)
        self.dkv = PagedKVRuntime(draft, self.bm, device=self.device)

        self.last_token: Dict[int, int] = {}
        self.tokens_out: Dict[int, List[int]] = {}
        # the engine's clocked recorder (phase spans), or None
        self.spans = None

        self._spec = make_paged_spec_step(target, draft, sampling=sampling,
                                          temperature=temperature)
        self._ar = make_paged_ar_step(target, sampling=sampling,
                                      temperature=temperature)
        # the pure-decode and spec steps' graphs: on the card, for greedy
        # sampling (rejection sampling's generator is not registered with
        # a graph)
        self._graphs = (StepGraphs(CudaGraph, self.device,
                                   max_batch=self.max_batch,
                                   width=self.graph_width())
                        if self.device.type == "cuda"
                        and sampling == "greedy" else None)

    def graph_width(self) -> int:
        """The table width step graphs are made at: a table that holds a
        full batch's even share of the pool, the context the pool is sized
        for (``max_batch`` x the longest context), as a power of two."""
        return bucket_size(-(-self.bm.total_blocks // self.max_batch))

    # ------------------------------------------------------------------
    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _packed(self, model: str, run: int, valid: int,
                rows: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                **args) -> None:
        """End the caller's ``backend.pack`` span with the positions the
        model call runs and the real ones among them and ``args``, and
        open the call's ``backend.dispatch``.  A target call passes
        its ``rows``, (start, count) host arrays, whose K/V reads a target
        with sliding-window layers counts (:meth:`_kv_reads`)."""
        self.spans.switch("backend.dispatch", model=model,
                          positions_run=run, positions_valid=valid,
                          **self._kv_reads(rows), **args)

    def _kv_reads(self, rows) -> dict:
        """The K/V positions that one full layer (``kv_read_full``) and one
        sliding layer (``kv_read_window``) of the target read over a call's
        real rows: a row of n queries after ``start`` positions reads
        start + n of them in a full layer, and from its first query's
        window start on, min(start + n, n + W - 1), in a sliding one of
        window W.  Empty for a target without a window."""
        W = self.target.cfg.sliding_window
        if not W or rows is None:
            return {}
        start, n = (np.asarray(a, np.int64) for a in rows)
        start, n = start[n > 0], n[n > 0]
        return {"kv_read_full": int((start + n).sum()),
                "kv_read_window": int(np.minimum(start + n, n + W - 1)
                                      .sum())}

    def _synced(self, graph: str = "eager") -> None:
        """The device synchronise that ends a dispatch, as its own
        ``backend.sync`` span; ``graph`` joins the dispatch's args."""
        sp = self.spans
        if sp is None:
            _device.synchronize(self.device)
            return
        sp.switch("backend.sync", graph=graph)
        _device.synchronize(self.device)
        sp.close()

    def _ops(self, tokens, tables, start, valid) -> tuple:
        """A model call's operands: tokens and tables on the device, start
        and valid on the host, where a packed call reads its row layout
        without waiting on the device."""
        return (self._dev(tokens), self._dev(tables), torch.from_numpy(start),
                torch.from_numpy(valid))

    def _extend_target(self, tokens, tables, start, valid) -> np.ndarray:
        """Multi-token extension + next-token sample at each row's last
        valid position (a padded prefill, or a packed call of chunks fused
        with T=1 decode rows); returns the sampled tokens on the host.
        With spans, closes the caller's ``backend.pack``."""
        sp = self.spans
        ops = self._ops(tokens, tables, start, valid)
        # padded rows of several positions are read at their last valid
        # one; a packed call returns each row's last position alone
        last = (self._dev(np.maximum(valid.astype(np.int64) - 1, 0))
                if tokens.shape[1] > 1 else None)
        if sp is not None:
            self._packed("target", tokens.size, int(valid.sum()),
                         (start, valid))
        logits, self.tkv.pages = self.target.decode_step_paged(
            self.tparams, self.tkv.pages, *ops)
        if last is None:
            logits = logits[:, 0]
        else:
            logits = logits[torch.arange(logits.shape[0],
                                         device=self.device), last]
        lg = logits / self.temperature
        if self.sampling == "greedy":
            nxt = lg.argmax(dim=-1)
        else:
            nxt = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                    generator=self.gen)[:, 0]
        self._synced()
        if sp is None:
            return nxt.cpu().numpy()
        sp.open("backend.unpack")
        nxt = nxt.cpu().numpy()
        sp.close()
        return nxt

    def _extend_draft(self, tokens, tables, start, valid) -> None:
        """The draft's extension over the same operands; with spans,
        closes the caller's ``backend.pack``."""
        ops = self._ops(tokens, tables, start, valid)
        if self.spans is not None:
            self._packed("draft", tokens.size, int(valid.sum()))
        _, self.dkv.pages = self.draft.decode_step_paged(
            self.dparams, self.dkv.pages, *ops)
        self._synced()

    def _drop_graphs(self, draft_only: bool) -> None:
        """Drop the step graphs over tensors that move: the spec steps'
        (gamma > 0) when only the draft's weights move, else all."""
        if self._graphs is not None:
            self._graphs.drop(lambda key: not draft_only or key[2] > 0)

    def offload_draft(self) -> None:
        self._drop_graphs(draft_only=True)
        self.dparams_host = tree_to(self.dparams, "cpu")
        self.dparams = None

    def reload_draft(self) -> None:
        assert self.dparams_host is not None
        self._drop_graphs(draft_only=True)
        self.dparams = tree_to(self.dparams_host, self.device)

    @property
    def draft_resident(self) -> bool:
        return self.dparams is not None

    # ------------------------------------------------------------------
    # block-table bookkeeping (int32 only — the pages only move for CoW
    # forks and elastic migration, both batched block-migration launches)
    # ------------------------------------------------------------------
    def _ensure_alloc(self, req_id: int, tokens: int) -> None:
        if req_id in self.bm.tables:
            self.bm.ensure_capacity(req_id, tokens)
        else:
            # private BlockManager: mirror the scheduler's admission
            self.bm.allocate(req_id, tokens)

    def on_admit(self, seq: Sequence) -> None:
        """A sequence admitted with a cached prefix starts with that many
        tokens already materialised — in BOTH pools (only draft-covered
        prefixes are ever registered, see scheduler.note_prefill_progress)."""
        self.tkv.ctx[seq.req_id] = seq.prefilled
        self.dkv.ctx[seq.req_id] = seq.prefilled

    def apply_host_transfers(self) -> None:
        """Drain the BlockManager's host-tier queues: gather freshly
        spilled blocks' pages (BOTH pools) into their ``HostKVStore``
        records, then scatter queued restores back into their target device
        blocks — spills strictly first, so a block spilled and re-matched
        in the same scheduling round restores the payload captured here.
        Runs BEFORE CoW copies and step writes (``_apply_pending_copies``)
        so eviction-time content is read before anything overwrites it."""
        hs = getattr(self.bm, "host_store", None)
        if hs is None:
            return
        spills = self.bm.drain_pending_spills()
        if spills:
            t0 = time.perf_counter()
            ids = [b for b, _ in spills]
            tpay = self.tkv.spill_blocks(ids)
            dpay = self.dkv.spill_blocks(ids)
            for i, (_, h) in enumerate(spills):
                rec = hs.records.get(h)
                if rec is None:
                    continue          # host LRU dropped it before the copy
                rec.data = {f"t:{k}": v[:, i] for k, v in tpay.items()}
                rec.data.update(
                    {f"d:{k}": v[:, i] for k, v in dpay.items()})
                hs.seal(h)  # re-stamp the checksum over the filled pages
                hs.stats["spilled_blocks"] += 1
            hs.stats["spill_s"] += time.perf_counter() - t0
        restores = self.bm.drain_pending_restores()
        if restores:
            t0 = time.perf_counter()
            # a queued restore's record is pinned from match to drain, so a
            # checksum mismatch here is real memory corruption, not noise
            assert all(hs.verify(h) for h, _ in restores), \
                "pinned host record fails its checksum at restore drain"
            recs = [(b, hs.take(h)) for h, b in restores]
            assert all(r is not None and r.data for _, r in recs), \
                "pinned host record lost before its restore drained"
            ids = [b for b, _ in recs]
            self.tkv.restore_blocks(ids, {
                k: np.stack([r.data[f"t:{k}"] for _, r in recs], axis=1)
                for k in self.tkv.pages})
            self.dkv.restore_blocks(ids, {
                k: np.stack([r.data[f"d:{k}"] for _, r in recs], axis=1)
                for k in self.dkv.pages})
            _device.synchronize(self.device)
            hs.stats["restore_s"] += time.perf_counter() - t0

    def _apply_pending_copies(self) -> None:
        """Execute the BlockManager's queued CoW forks on the device (one
        block-migration launch over all four page tensors) BEFORE this
        step's writes, so a privatised block carries its shared content
        when written.  Host-tier spills/restores drain first: a spill must
        read its block's pages before a CoW copy or step write can touch
        them."""
        self.apply_host_transfers()
        copies = self.bm.drain_pending_copies()
        if not copies:
            return
        apply_copies((self.tkv, self.dkv), [c[0] for c in copies],
                     [c[1] for c in copies])

    def reserve(self, seqs: List[Sequence], gamma: int) -> List[Sequence]:
        """Grow block tables to cover this step's gamma+1 KV writes BEFORE
        executing, so a paged write can never land in another sequence's
        blocks; any shared block the write range covers is privatised first
        (copy-on-write).  Returns the sequences whose reservation failed —
        the engine preempts those (recompute policy) instead of running
        them."""
        failed = []
        for s in seqs:
            ctx = self.tkv.ctx.get(s.req_id, 0)
            need = ctx + gamma + 1
            try:
                if self.bm.prefix_caching and s.req_id in self.bm.tables:
                    self.bm.fork_for_write(s.req_id, ctx, need)
                self._ensure_alloc(s.req_id, need)
            except OutOfBlocks:
                failed.append(s)
        return failed

    # ------------------------------------------------------------------
    # elastic physical pool (memory-manager hooks, §6.3/6.4 on real tier)
    # ------------------------------------------------------------------
    def grow_pools(self, extra_blocks: int) -> None:
        """§6.3: extend both physical paged pools in lockstep with
        ``BlockManager.expand`` (ElasticMemoryManager ``grow_fn``)."""
        self._drop_graphs(draft_only=False)
        self.tkv.grow(extra_blocks)
        self.dkv.grow(extra_blocks)

    def shrink_pools(self, to_blocks: Optional[int] = None) -> None:
        """§6.4 step 5: trim both pools after the logical contraction
        committed (ElasticMemoryManager ``shrink_fn``)."""
        nb = self.bm.base_blocks if to_blocks is None else to_blocks
        self._drop_graphs(draft_only=False)
        self.tkv.shrink(nb)
        self.dkv.shrink(nb)

    def migrate_pools(self, plan) -> float:
        """§6.4 step 3: execute the contraction's block moves on both pools
        (ElasticMemoryManager ``migrate_fn``), one block-migration launch
        over all four page tensors; returns wall-clock seconds.
        Contraction-time spills flush first — the spilled high blocks'
        pages must be captured before migration reuses their below-boundary
        targets and before ``shrink_pools`` trims the high region."""
        self.apply_host_transfers()
        t0 = time.perf_counter()
        apply_copies((self.tkv, self.dkv), plan.src, plan.dst)
        _device.synchronize(self.device)
        return time.perf_counter() - t0

    def _fill_rows(self, rows: List[Tuple[Sequence, List[int], int, int]]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """rows of (seq, tokens, start, n_valid) -> padded step operands."""
        Bb = bucket_size(len(rows))
        Tb = bucket_size(max(len(r[1]) for r in rows))
        tokens = np.zeros((Bb, Tb), np.int32)
        start = np.zeros((Bb,), np.int32)
        valid = np.zeros((Bb,), np.int32)
        for i, (_, toks, c, nv) in enumerate(rows):
            tokens[i, :len(toks)] = toks
            start[i] = c
            valid[i] = nv
        return tokens, start, valid, Bb

    def _pack_rows(self, rows: List[Tuple[Sequence, List[int], int, int]],
                   kv: PagedKVRuntime
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """rows of (seq, tokens, start, n_valid), each holding exactly its
        n_valid real tokens -> the packed call's operands: tokens (N, 1)
        row after row, and per row the block tables of ``kv``, start and
        n_valid."""
        tokens = np.concatenate([np.asarray(r[1], np.int32) for r in rows])
        start = np.asarray([r[2] for r in rows], np.int32)
        valid = np.asarray([r[3] for r in rows], np.int32)
        tables, _ = kv.batch_tables([r[0] for r in rows], len(rows))
        return tokens[:, None], tables, start, valid

    # ------------------------------------------------------------------
    def prefill(self, seqs: List[Sequence], *, with_draft: bool) -> float:
        """Batched prefill: every admitted prompt in ONE padded extension
        call (start=0), its KV scattered straight into the paged pool."""
        t0 = time.perf_counter()
        rows = []
        for s in seqs:
            if self._owns_bm and s.req_id in self.bm.tables:
                self.bm.release(s.req_id)  # recompute after preemption
            self._ensure_alloc(s.req_id, s.request.prompt_len + 1)
            toks = list(s.request.prompt_tokens)
            rows.append((s, toks, 0, len(toks)))
        sp = self.spans
        if sp is not None:
            sp.open("backend.copies")
        self._apply_pending_copies()
        if sp is not None:
            sp.switch("backend.pack")
        tokens, start, valid, Bb = self._fill_rows(rows)
        tables, _ = self.tkv.batch_tables(seqs, Bb)
        nxt = self._extend_target(tokens, tables, start, valid)
        do_draft = with_draft and self.draft_resident
        if do_draft:
            if sp is not None:
                sp.open("backend.pack")
            self._extend_draft(tokens, tables, start, valid)
        if sp is not None:
            sp.open("backend.unpack")
        for i, s in enumerate(seqs):
            P = s.request.prompt_len
            self.tkv.ctx[s.req_id] = P
            self.tokens_out[s.req_id] = [int(nxt[i])]
            self.last_token[s.req_id] = int(nxt[i])
            s.generated = 0  # first token counted at the first decode commit
            if do_draft:
                self.dkv.ctx[s.req_id] = P
                s.delta = 0
            else:
                self.dkv.ctx[s.req_id] = 0
                s.delta = P
        if sp is not None:
            sp.close()
        return time.perf_counter() - t0

    def draft_catchup(self, seqs: List[Sequence]) -> float:
        """Re-prefill the draft pool for sequences whose draft state lags
        (the physical C_switch cost) — one batched paged extension."""
        if not self.draft_resident:
            return 0.0
        rows = []
        for s in seqs:
            ctx = self.tkv.ctx.get(s.req_id)
            if ctx is None:
                continue
            dctx = self.dkv.ctx.get(s.req_id, 0)
            if dctx > ctx:
                dctx = 0  # stale (preempt-and-recompute): full re-prefill
            if dctx >= ctx:
                continue
            stream = (list(s.request.prompt_tokens)
                      + self.tokens_out.get(s.req_id, []))
            rows.append((s, stream[dctx:ctx], dctx, ctx - dctx))
        if not rows:
            return 0.0
        t0 = time.perf_counter()
        if self.spans is not None:
            self.spans.open("backend.pack")
        self._extend_draft(*self._pack_rows(rows, self.dkv))
        for s, _, _, _ in rows:
            self.dkv.ctx[s.req_id] = self.tkv.ctx[s.req_id]
            s.delta = 0
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def hybrid_step(self, chunks, decode: List[Sequence], gamma: int,
                    *, with_draft: bool) -> StepOutcome:
        """One fused mixed step: prefill chunks (ragged multi-token appends
        into freshly grown blocks) batched together with the T=1 decode
        rows in a single packed extension call over their real positions
        (and the chunks again in one packed call of the draft)."""
        if not chunks:
            if not decode:
                return StepOutcome(n_committed=[], latency=0.0)
            return self.step(decode, gamma)
        assert gamma == 0, "speculation is disabled while chunks are in flight"
        if self.reserve(decode, 0):
            raise OutOfBlocks("decode rows not reserved — engine must "
                              "preempt before hybrid_step")
        rows = []
        for s, n in chunks:
            c = s.prefilled  # authoritative (survives preempt-and-recompute)
            self.tkv.ctx[s.req_id] = c
            if c == 0:
                self.dkv.ctx[s.req_id] = 0  # fresh / restarted sequence
            self._ensure_alloc(s.req_id, c + n)
            toks = list(s.request.prompt_tokens[c:c + n])
            rows.append((s, toks, c, n))
        n_chunks = len(rows)
        for s in decode:
            rows.append((s, [self.last_token[s.req_id]],
                         self.tkv.ctx[s.req_id], 1))

        t0 = time.perf_counter()
        sp = self.spans
        if sp is not None:
            sp.open("backend.copies")
        # CoW forks queued at schedule/reserve time execute BEFORE the
        # step's writes (their cost is real step latency)
        self._apply_pending_copies()
        if sp is not None:
            sp.switch("backend.pack")
        nxt = self._extend_target(*self._pack_rows(rows, self.tkv))

        if with_draft and self.draft_resident:
            # the draft consumes the same chunk stream to keep its KV current
            # (decode rows stay out: gamma=0 commits are charged to delta)
            drows = [r for r in rows[:n_chunks]
                     if self.dkv.ctx.get(r[0].req_id, 0) == r[2]]
            if drows:
                if sp is not None:
                    sp.open("backend.pack")
                self._extend_draft(*self._pack_rows(drows, self.dkv))
                for s, _, c, n in drows:
                    self.dkv.ctx[s.req_id] = c + n
        latency = time.perf_counter() - t0

        if sp is not None:
            sp.open("backend.unpack")
        for i, (s, _, c, n) in enumerate(rows):
            if i < n_chunks:
                self.tkv.ctx[s.req_id] = c + n
                if c + n == s.request.prompt_len:
                    # final chunk: the sampled token is the first output x_N
                    self.tokens_out[s.req_id] = [int(nxt[i])]
                    self.last_token[s.req_id] = int(nxt[i])
            else:
                self.tokens_out[s.req_id].append(int(nxt[i]))
                self.last_token[s.req_id] = int(nxt[i])
                self.tkv.ctx[s.req_id] = c + 1
        if sp is not None:
            sp.close()
        return StepOutcome(n_committed=[1] * len(decode), latency=latency)

    # ------------------------------------------------------------------
    def _padded_call(self, gamma: int, tables, lengths, last,
                     positions=None) -> tuple:
        """A pure-decode step's model call over device operands: the next
        tokens (gamma = 0), or the spec step's committed tokens, accepted
        counts and last tokens; the pages are written in place.
        ``positions``: the draft chain's starts (``make_paged_spec_step``),
        which a captured step takes as inputs."""
        if gamma == 0:
            nxt, self.tkv.pages = self._ar(self.gen, self.tparams,
                                           self.tkv.pages, tables, lengths,
                                           last)
            return (nxt,)
        res = self._spec(self.gen, self.tparams, self.dparams,
                         self.tkv.pages, self.dkv.pages, tables, lengths,
                         last, gamma, positions)
        self.tkv.pages, self.dkv.pages = res.tcache, res.dcache
        return res.tokens, res.n_accepted, res.last_token

    def _graph_ptrs(self, gamma: int) -> Tuple[int, ...]:
        """The addresses of every tensor a step of ``gamma`` reads or
        writes besides its inputs: the target's parameters and pages, and
        for gamma > 0 the draft's."""
        trees = [self.tparams, self.tkv.pages]
        if gamma:
            trees += [self.dparams, self.dkv.pages]
        out, todo = [], trees
        while todo:
            x = todo.pop()
            if isinstance(x, dict):
                todo.extend(x.values())
            else:
                out.append(x.data_ptr())
        return tuple(out)

    def _graph_inputs(self, tables, lengths, last, gamma: int) -> tuple:
        """A captured step's host inputs: the tables (padded to the
        graph's width by the caller), lengths, last tokens and, for gamma
        > 0, the draft chain's starts N .. N + gamma."""
        host = (tables, lengths, last.astype(np.int64))
        if gamma:
            host += (lengths[None] + np.arange(gamma + 1, dtype=np.int32)
                     [:, None],)
        return host

    def capture_steps(self, gamma_max: int) -> None:
        """Capture the step of each of the runner's batch buckets (1, 4,
        16, ... up to ``max_batch``'s) and every gamma up to ``gamma_max``
        (0 alone while the draft is offloaded) at the runner's width,
        before serving: the engine calls
        it when it is built.  One eager step over write-off tables warms
        cuBLAS and the allocator first; neither it nor the captures add to
        the launch counters.  A no-op without step graphs."""
        g = self._graphs
        if g is None:
            return
        gammas = range(gamma_max + 1 if self.dparams is not None else 1)

        def inputs(Bb, gamma):
            return self._graph_inputs(
                np.full((Bb, g.width), self.tkv.trash, np.int32),
                np.zeros((Bb,), np.int32), np.zeros((Bb,), np.int32), gamma)

        with uncounted():
            warm = [self._dev(a) for a in inputs(1, min(1, gammas[-1]))]
            self._padded_call(min(1, gammas[-1]), *warm)
            _device.synchronize(self.device)
        for Bb in g.buckets:
            for gamma in gammas:
                g.capture((Bb, g.width, gamma), inputs(Bb, gamma),
                          self._graph_ptrs(gamma),
                          lambda *ops, gamma=gamma:
                          self._padded_call(gamma, *ops))

    def step(self, seqs: List[Sequence], gamma: int) -> StepOutcome:
        if self.reserve(seqs, gamma):
            raise OutOfBlocks("decode batch not reserved — engine must "
                              "preempt before step")
        sp = self.spans
        if sp is not None:
            sp.open("backend.copies")
        self._apply_pending_copies()
        if sp is not None:
            sp.switch("backend.pack")
        g = self._graphs
        # graphs are captured at fewer batch buckets than eager steps run at
        Bb = (bucket_size if g is None else g.bucket)(len(seqs))
        tables, lengths = self.tkv.batch_tables(seqs, Bb)
        last = np.zeros((Bb,), np.int32)
        for i, s in enumerate(seqs):
            last[i] = self.last_token[s.req_id]

        t0 = time.perf_counter()
        if g is None:
            mode = "eager"
            ops = (self._dev(tables), self._dev(lengths),
                   self._dev(last).long())
        else:
            key = g.key(len(seqs), tables.shape[1], gamma)
            mode = "replay" if g.captured(key) else "capture"
            # a wider graph's tables: the rest of each row is the
            # write-off block, which no position below a length reaches
            tables = np.pad(tables, ((0, 0), (0, key[1] - tables.shape[1])),
                            constant_values=self.tkv.trash)
            entry = g.load(key, self._graph_inputs(tables, lengths, last,
                                                   gamma))
        if sp is not None:
            # a gamma > 0 step runs the draft chain and the target's verify
            # each over Bb x (gamma + 1) positions; ``starts``: each real
            # row's context, from which a reader counts what a replayed
            # call's kernels read
            starts = [self.tkv.ctx[s.req_id] for s in seqs]
            self._packed("target" if gamma == 0 else "spec",
                         Bb * (gamma + 1), len(seqs) * (gamma + 1),
                         (starts, [gamma + 1] * len(seqs)), starts=starts)
        if g is None:
            outs = self._padded_call(gamma, *ops)
        else:
            outs = g.run(entry, self._graph_ptrs(gamma),
                         lambda *ops: self._padded_call(gamma, *ops))
        self._synced(mode)
        latency = time.perf_counter() - t0
        if sp is not None:
            sp.open("backend.unpack")
        if gamma == 0:
            nxt = outs[0].cpu().numpy()
            n_committed = []
            for i, s in enumerate(seqs):
                self.tokens_out[s.req_id].append(int(nxt[i]))
                self.last_token[s.req_id] = int(nxt[i])
                self.tkv.ctx[s.req_id] += 1
                n_committed.append(1)
            if sp is not None:
                sp.close()
            return StepOutcome(n_committed=n_committed, latency=latency)

        toks, n_acc, last_np = (t.cpu().numpy() for t in outs)
        n_committed = []
        for i, s in enumerate(seqs):
            committed = [int(t) for t in toks[i] if t >= 0]
            self.tokens_out[s.req_id].extend(committed)
            self.last_token[s.req_id] = int(last_np[i])
            n_keep = int(n_acc[i]) + 1
            self.tkv.ctx[s.req_id] += n_keep
            self.dkv.ctx[s.req_id] = self.tkv.ctx[s.req_id]
            n_committed.append(n_keep)
        if sp is not None:
            sp.close()
        return StepOutcome(n_committed=n_committed, latency=latency)

    # ------------------------------------------------------------------
    # disaggregated prefill/decode handoff (physical KV migration)
    # ------------------------------------------------------------------
    def export_handoff(self, seq: Sequence) -> dict:
        """Capture a fully-prefilled sequence's physical state for migration
        to a decode replica: both pools' block payloads (the host-offload
        spill's gather, to host numpy) plus the sampler bookkeeping the
        decode loop needs (materialised lengths, the first sampled output
        token, last-token id).  The engine calls it BEFORE it releases the
        source's block table."""
        rid = seq.req_id
        table = list(self.bm.tables.get(rid, ()))
        out = {
            "ctx": int(self.tkv.ctx.get(rid, 0)),
            "dctx": int(self.dkv.ctx.get(rid, 0)),
            "tokens_out": list(self.tokens_out.get(rid, [])),
            "last_token": self.last_token.get(rid),
            "n_blocks": len(table),
        }
        if table:
            out["tkv"] = self.tkv.spill_blocks(table)
            out["dkv"] = self.dkv.spill_blocks(table)
        return out

    def import_handoff(self, seq: Sequence, payload: dict) -> None:
        """Adopt a migrated sequence: scatter the exported block payloads
        into this replica's freshly allocated blocks (the host-offload
        restore's scatter) and rebuild the decode bookkeeping, so the next
        decode step continues exactly as if the sequence had never
        moved."""
        kv = payload.get("kv")
        if not kv:
            return
        rid = seq.req_id
        ctx = int(kv.get("ctx", 0))
        self._ensure_alloc(rid, max(ctx, 1))
        table = list(self.bm.tables.get(rid, ()))
        # the destination table covers exactly the materialised ctx tokens;
        # a source tail block past ctx (allocation rounding) is never read,
        # so restoring the common prefix is enough
        n = min(len(table), int(kv.get("n_blocks", 0)))
        if n:
            ids = table[:n]
            self.tkv.restore_blocks(
                ids, {k: v[:, :n] for k, v in kv["tkv"].items()})
            self.dkv.restore_blocks(
                ids, {k: v[:, :n] for k, v in kv["dkv"].items()})
        self.tkv.ctx[rid] = ctx
        self.dkv.ctx[rid] = int(kv.get("dctx", 0))
        self.tokens_out[rid] = list(kv.get("tokens_out", []))
        if kv.get("last_token") is not None:
            self.last_token[rid] = int(kv["last_token"])

    # ------------------------------------------------------------------
    def release(self, seq: Sequence) -> None:
        self.tkv.ctx.pop(seq.req_id, None)
        self.dkv.ctx.pop(seq.req_id, None)
        self.last_token.pop(seq.req_id, None)
        # engine flow releases through scheduler.finish first, leaving this a
        # no-op there; direct backend users free their blocks
        if seq.req_id in self.bm.tables:
            self.bm.release(seq.req_id)

    def output_tokens(self, req_id: int) -> List[int]:
        return self.tokens_out.get(req_id, [])


# ---------------------------------------------------------------------------
# Dense slot-cache backend
# ---------------------------------------------------------------------------


def _gather(cache, idx):
    """The slots ``idx`` of every cache tensor, as a new compact cache."""
    return {k: x[idx] if x.dim() == 1 else x[:, idx]
            for k, x in cache.items()}


def _scatter(cache, compact, idx, n_real):
    """Write the first ``n_real`` rows of ``compact`` back into slots
    ``idx[:n_real]`` of ``cache``, in place."""
    dst = idx[:n_real]
    for k, x in cache.items():
        if x.dim() == 1:
            x[dst] = compact[k][:n_real]
        else:
            x[:, dst] = compact[k][:, :n_real]


class DenseSlotBackend:
    """Slot-based continuous batching over dense caches:

      * caches are allocated once for ``max_batch`` slots x ``max_seq``
        positions;
      * each step gathers the active slots into a compact batch (padded to
        a power-of-two bucket with copies of slot 0), runs the dense-cache
        AR / speculative step, and scatters the real rows back;
      * prefill is a one-sequence-at-a-time loop; a draft catch-up
        re-prefills the draft's whole context (the C_switch cost), counted
        in ``catchups`` (calls, tokens, seconds).

    The caches are any family's: attention k / v, an SSM's conv / ssm state
    (rolled back from checkpoints by the speculative step) or a hybrid's
    both.  Only caches with positions bound a request's length by
    ``max_seq``.  An encoder-decoder is refused: prompts carry tokens only
    (the reference's real tier serves no audio).

    ``params`` is a (target, draft) pair of parameter trees on ``device``;
    without it both models are initialised from ``seed``.
    """

    def __init__(self, target: ModelAPI, draft: ModelAPI, *,
                 device="cuda", params: Optional[Tuple[dict, dict]] = None,
                 max_batch: int = 8, max_seq: int = 256, seed: int = 0,
                 sampling: str = "greedy", temperature: float = 1.0):
        if "encdec" in (target.cfg.family, draft.cfg.family):
            raise NotImplementedError(
                "DenseSlotBackend serves token prompts; an encoder-decoder "
                "needs its encoder input (enc_emb), which requests do not "
                "carry")
        self.device = _device.resolve(device)
        # an ssm cache has no position axis: only attention caches bound
        # the positions a request may reach
        self.positional = any(m.cfg.family != "ssm"
                              for m in (target, draft))
        self.catchups = {"calls": 0, "tokens": 0, "seconds": 0.0}
        self.target = target
        self.draft = draft
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        if params is None:
            params = (target.init(device=self.device, seed=seed + 1),
                      draft.init(device=self.device, seed=seed + 2))
        self.tparams, self.dparams = params
        self.dparams_host: Optional[dict] = None  # offloaded copy

        self.tcache = target.init_cache(max_batch, max_seq,
                                        device=self.device)
        self.dcache = draft.init_cache(max_batch, max_seq, device=self.device)
        self.last_token = np.zeros(max_batch, np.int32)
        self.tokens_out: Dict[int, List[int]] = {}
        self.slot_of: Dict[int, int] = {}
        self._free_slots = list(range(max_batch))[::-1]

        self._spec = make_spec_step(target, draft, sampling=sampling,
                                    temperature=temperature)
        self._ar = make_ar_step(target, sampling=sampling,
                                temperature=temperature)

    # ------------------------------------------------------------------
    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _prompt(self, tokens: List[int]) -> dict:
        return {"tokens": self._dev(np.asarray(tokens, np.int32)[None, :])}

    def offload_draft(self) -> None:
        self.dparams_host = tree_to(self.dparams, "cpu")
        self.dparams = None

    def reload_draft(self) -> None:
        assert self.dparams_host is not None
        self.dparams = tree_to(self.dparams_host, self.device)

    @property
    def draft_resident(self) -> bool:
        return self.dparams is not None

    # ------------------------------------------------------------------
    def prefill(self, seqs: List[Sequence], *, with_draft: bool) -> float:
        t0 = time.perf_counter()
        for s in seqs:
            slot = self._free_slots.pop()
            self.slot_of[s.req_id] = slot
            s.slot = slot
            batch = self._prompt(s.request.prompt_tokens)
            idx = self._dev([slot])
            logits, cache1 = self.target.prefill(self.tparams, batch,
                                                 self.max_seq)
            _scatter(self.tcache, cache1, idx, 1)
            nxt = int(logits[0, 0].argmax())
            self.last_token[slot] = nxt
            self.tokens_out[s.req_id] = [nxt]
            s.generated = 0  # first token counted at the first decode commit
            if with_draft and self.draft_resident:
                _, dcache1 = self.draft.prefill(self.dparams, batch,
                                                self.max_seq)
                _scatter(self.dcache, dcache1, idx, 1)
                s.delta = 0
            else:
                s.delta = s.request.prompt_len
        _device.synchronize(self.device)
        return time.perf_counter() - t0

    def draft_catchup(self, seqs: List[Sequence]) -> float:
        """Re-prefill the draft cache for sequences whose draft state lags
        (the physical C_switch cost)."""
        if not self.draft_resident:
            return 0.0
        t0 = time.perf_counter()
        tokens = 0
        for s in seqs:
            if s.delta <= 0:
                continue
            tokens += s.delta
            ctx = (list(s.request.prompt_tokens)
                   + self.tokens_out[s.req_id][:-1])
            _, dcache1 = self.draft.prefill(self.dparams, self._prompt(ctx),
                                            self.max_seq)
            _scatter(self.dcache, dcache1,
                     self._dev([self.slot_of[s.req_id]]), 1)
            s.delta = 0
        _device.synchronize(self.device)
        dt = time.perf_counter() - t0
        if tokens:
            self.catchups["calls"] += 1
            self.catchups["tokens"] += tokens
            self.catchups["seconds"] += dt
        return dt

    # ------------------------------------------------------------------
    def hybrid_step(self, chunks, decode: List[Sequence], gamma: int,
                    *, with_draft: bool) -> StepOutcome:
        """Chunked prefill needs the paged RealBackend; the dense slot tier
        prefills monolithically, so it refuses chunks (build its engine
        with ``chunk_tokens`` unset)."""
        if chunks:
            raise NotImplementedError(
                "chunked prefill needs the paged-KV RealBackend — the dense "
                "slot backend prefills monolithically (chunk_tokens=0)")
        return self.step(decode, gamma)

    def step(self, seqs: List[Sequence], gamma: int) -> StepOutcome:
        n = len(seqs)
        bucket = min(bucket_size(n), self.max_batch)
        slots = np.array([self.slot_of[s.req_id] for s in seqs], np.int32)
        if self.positional:
            for s in seqs:
                # materialised tokens + this step's gamma+1 writes
                need = (s.request.prompt_len
                        + len(self.tokens_out[s.req_id]) + gamma)
                if need > self.max_seq:
                    raise ValueError(f"request {s.req_id}: {need} positions "
                                     f"exceed the dense cache's "
                                     f"{self.max_seq}")
        idx_np = np.concatenate([slots, np.zeros(bucket - n, np.int32)])
        idx = self._dev(idx_np).long()

        tc = _gather(self.tcache, idx)
        last = self._dev(self.last_token[idx_np]).long()

        t0 = time.perf_counter()
        if gamma == 0:
            nxt, tc_new = self._ar(self.gen, self.tparams, tc, last)
            _device.synchronize(self.device)
            latency = time.perf_counter() - t0
            _scatter(self.tcache, tc_new, idx, n)
            nxt_np = nxt.cpu().numpy()
            n_committed = []
            for i, s in enumerate(seqs):
                self.tokens_out[s.req_id].append(int(nxt_np[i]))
                self.last_token[slots[i]] = int(nxt_np[i])
                n_committed.append(1)
            return StepOutcome(n_committed=n_committed, latency=latency)

        dc = _gather(self.dcache, idx)
        res = self._spec(self.gen, self.tparams, self.dparams, tc, dc, last,
                         gamma)
        _device.synchronize(self.device)
        latency = time.perf_counter() - t0
        _scatter(self.tcache, res.tcache, idx, n)
        _scatter(self.dcache, res.dcache, idx, n)
        toks = res.tokens.cpu().numpy()
        n_acc = res.n_accepted.cpu().numpy()
        last_np = res.last_token.cpu().numpy()
        n_committed = []
        for i, s in enumerate(seqs):
            committed = [int(t) for t in toks[i] if t >= 0]
            self.tokens_out[s.req_id].extend(committed)
            self.last_token[slots[i]] = int(last_np[i])
            n_committed.append(int(n_acc[i]) + 1)
        return StepOutcome(n_committed=n_committed, latency=latency)

    # ------------------------------------------------------------------
    def release(self, seq: Sequence) -> None:
        slot = self.slot_of.pop(seq.req_id, None)
        if slot is not None:
            self._free_slots.append(slot)

    def output_tokens(self, req_id: int) -> List[int]:
        return self.tokens_out.get(req_id, [])
