"""Real-execution backend: the paged-KV runtime behind the serving engine.

:class:`RealBackend` allocates ``(L, num_blocks + 1, block_size, KH, hd)``
key/value pools per model ONCE and drives them by the
:class:`BlockManager`'s block tables: admission, decode, speculative
verification, chunked prefill, eviction and completion touch only int32
tables and sampled tokens — the cache tensors never travel.  One multi-query
paged-attention kernel serves plain decode (T=1), speculative verify
(T=gamma+1) and prefill / chunked-prefill appends (T=chunk), so
``hybrid_step`` runs the chunked scheduler's mixed chunk+decode batches.

Latencies are host clock around work that ends in a device synchronise —
what the planner learns from on this tier.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core.spec_decode import make_paged_ar_step, make_paged_spec_step
from ..models.registry import ModelAPI, tree_to
from .engine import StepOutcome
from .kv_cache import BlockManager, OutOfBlocks
from .paged_runtime import PagedKVRuntime, bucket_size, num_blocks_for
from .request import Sequence


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

        self._spec = make_paged_spec_step(target, draft, sampling=sampling,
                                          temperature=temperature)
        self._ar = make_paged_ar_step(target, sampling=sampling,
                                      temperature=temperature)

    # ------------------------------------------------------------------
    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _extend_target(self, tokens, tables, start, valid) -> np.ndarray:
        """Multi-token extension + next-token sample at each row's last
        valid position (batched prefill / chunked-prefill appends fused
        with T=1 decode rows); returns the sampled tokens on the host."""
        valid_d = self._dev(valid)
        logits, self.tkv.pages = self.target.decode_step_paged(
            self.tparams, self.tkv.pages, self._dev(tokens),
            self._dev(tables), self._dev(start), valid_d)
        idx = (valid_d.long() - 1).clamp(min=0)
        lg = logits[torch.arange(logits.shape[0], device=self.device),
                    idx] / self.temperature
        if self.sampling == "greedy":
            nxt = lg.argmax(dim=-1)
        else:
            nxt = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                    generator=self.gen)[:, 0]
        _device.synchronize(self.device)
        return nxt.cpu().numpy()

    def _extend_draft(self, tokens, tables, start, valid) -> None:
        _, self.dkv.pages = self.draft.decode_step_paged(
            self.dparams, self.dkv.pages, self._dev(tokens),
            self._dev(tables), self._dev(start), self._dev(valid))
        _device.synchronize(self.device)

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
        block-migration launch per page tensor) BEFORE this step's writes,
        so a privatised block carries its shared content when written.
        Host-tier spills/restores drain first: a spill must read its
        block's pages before a CoW copy or step write can touch them."""
        self.apply_host_transfers()
        copies = self.bm.drain_pending_copies()
        if not copies:
            return
        src = [c[0] for c in copies]
        dst = [c[1] for c in copies]
        self.tkv.apply_copies(src, dst)
        self.dkv.apply_copies(src, dst)

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
        self.tkv.grow(extra_blocks)
        self.dkv.grow(extra_blocks)

    def shrink_pools(self, to_blocks: Optional[int] = None) -> None:
        """§6.4 step 5: trim both pools after the logical contraction
        committed (ElasticMemoryManager ``shrink_fn``)."""
        nb = self.bm.base_blocks if to_blocks is None else to_blocks
        self.tkv.shrink(nb)
        self.dkv.shrink(nb)

    def migrate_pools(self, plan) -> float:
        """§6.4 step 3: execute the contraction's block moves on both pools
        (ElasticMemoryManager ``migrate_fn``); returns wall-clock seconds.
        Contraction-time spills flush first — the spilled high blocks'
        pages must be captured before migration reuses their below-boundary
        targets and before ``shrink_pools`` trims the high region."""
        self.apply_host_transfers()
        t0 = time.perf_counter()
        self.tkv.apply_plan(plan)
        self.dkv.apply_plan(plan)
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
        self._apply_pending_copies()
        tokens, start, valid, Bb = self._fill_rows(rows)
        tables, _ = self.tkv.batch_tables(seqs, Bb)
        nxt = self._extend_target(tokens, tables, start, valid)
        do_draft = with_draft and self.draft_resident
        if do_draft:
            self._extend_draft(tokens, tables, start, valid)
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
        tokens, start, valid, Bb = self._fill_rows(rows)
        tables, _ = self.dkv.batch_tables([r[0] for r in rows], Bb)
        self._extend_draft(tokens, tables, start, valid)
        for s, _, _, _ in rows:
            self.dkv.ctx[s.req_id] = self.tkv.ctx[s.req_id]
            s.delta = 0
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def hybrid_step(self, chunks, decode: List[Sequence], gamma: int,
                    *, with_draft: bool) -> StepOutcome:
        """One fused mixed step: prefill chunks (ragged multi-token appends
        into freshly grown blocks) batched together with the T=1 decode
        rows in a single padded extension call."""
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
        # CoW forks queued at schedule/reserve time execute BEFORE the
        # step's writes (their cost is real step latency)
        self._apply_pending_copies()
        tokens, start, valid, Bb = self._fill_rows(rows)
        tables, _ = self.tkv.batch_tables([r[0] for r in rows], Bb)
        nxt = self._extend_target(tokens, tables, start, valid)

        if with_draft and self.draft_resident:
            # the draft consumes the same chunk stream to keep its KV current
            # (decode rows stay out: gamma=0 commits are charged to delta)
            drows = [r for r in rows[:n_chunks]
                     if self.dkv.ctx.get(r[0].req_id, 0) == r[2]]
            if drows:
                dtokens, dstart, dvalid, Db = self._fill_rows(drows)
                dtables, _ = self.dkv.batch_tables([r[0] for r in drows], Db)
                self._extend_draft(dtokens, dtables, dstart, dvalid)
                for s, _, c, n in drows:
                    self.dkv.ctx[s.req_id] = c + n
        latency = time.perf_counter() - t0

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
        return StepOutcome(n_committed=[1] * len(decode), latency=latency)

    # ------------------------------------------------------------------
    def step(self, seqs: List[Sequence], gamma: int) -> StepOutcome:
        if self.reserve(seqs, gamma):
            raise OutOfBlocks("decode batch not reserved — engine must "
                              "preempt before step")
        self._apply_pending_copies()
        Bb = bucket_size(len(seqs))
        tables, lengths = self.tkv.batch_tables(seqs, Bb)
        last = np.zeros((Bb,), np.int32)
        for i, s in enumerate(seqs):
            last[i] = self.last_token[s.req_id]

        t0 = time.perf_counter()
        tables_d, lengths_d = self._dev(tables), self._dev(lengths)
        last_d = self._dev(last).long()
        if gamma == 0:
            nxt, self.tkv.pages = self._ar(self.gen, self.tparams,
                                           self.tkv.pages, tables_d,
                                           lengths_d, last_d)
            _device.synchronize(self.device)
            latency = time.perf_counter() - t0
            nxt = nxt.cpu().numpy()
            n_committed = []
            for i, s in enumerate(seqs):
                self.tokens_out[s.req_id].append(int(nxt[i]))
                self.last_token[s.req_id] = int(nxt[i])
                self.tkv.ctx[s.req_id] += 1
                n_committed.append(1)
            return StepOutcome(n_committed=n_committed, latency=latency)

        res = self._spec(self.gen, self.tparams, self.dparams,
                         self.tkv.pages, self.dkv.pages, tables_d, lengths_d,
                         last_d, gamma)
        _device.synchronize(self.device)
        latency = time.perf_counter() - t0
        self.tkv.pages, self.dkv.pages = res.tcache, res.dcache
        toks = res.tokens.cpu().numpy()
        n_acc = res.n_accepted.cpu().numpy()
        last_np = res.last_token.cpu().numpy()
        n_committed = []
        for i, s in enumerate(seqs):
            committed = [int(t) for t in toks[i] if t >= 0]
            self.tokens_out[s.req_id].extend(committed)
            self.last_token[s.req_id] = int(last_np[i])
            n_keep = int(n_acc[i]) + 1
            self.tkv.ctx[s.req_id] += n_keep
            self.dkv.ctx[s.req_id] = self.tkv.ctx[s.req_id]
            n_committed.append(n_keep)
        return StepOutcome(n_committed=n_committed, latency=latency)

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
