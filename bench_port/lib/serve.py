"""The engine of a cell and the wall-clock loop that offers it traffic.

The engine is built from the port's public pieces, wired as
``repro_torch.launch.serve.build_real_engine`` wires them, at the sizes of
the configuration file's ``deployment`` (not the real tier's toy
constants).  The loop keeps its own clock (``time.perf_counter``): the
engine's clock is the sum of its backend's latencies and jumps to the next
arrival when idle, so it is not wall time.  The loop submits each
request when it falls due and not before, calls ``engine.step(now=...)``
(each backend step ends in a device synchronise), and after every step
reads which requests run, how far their prompts are prefilled and how many
tokens each has been served (``RealBackend.tokens_out``), stamping every
change with its own clock.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

# the planner's exploration is seeded by the deployment, not the run: a
# server's planner does not change with its traffic, and a run seed that
# reseeded it would change the work from seed to seed
PLANNER_SEED = 0

# seconds after the window closes that the run waits for the first token
# of every request due in the window; a request still without one counts
# in ``failed``
DRAIN_CAP_S = 30.0


@dataclass
class ReqRecord:
    req_id: int
    due: float                  # seconds after the traffic started
    prompt_len: int
    output_len: int
    in_window: bool
    admitted: float = -1.0      # start of the step that ran its first chunk
    token_times: List[float] = field(default_factory=list)
    prefilled: int = 0          # prompt positions materialised so far


@dataclass
class StepRecord:
    index: int
    t_start: float
    t_end: float
    kind: str                   # decode | idle
    batch: int                  # decode rows
    gamma: int
    tokens: int                 # tokens the engine committed
    prefill_tokens: int
    waiting: int                # requests queued after the step
    # (req_id, first position, count) of prompt positions prefilled
    chunks: List[tuple] = field(default_factory=list)
    # (req_id, first output index, count) of tokens served by this step
    served: List[tuple] = field(default_factory=list)

    @property
    def pure_decode(self) -> bool:
        return self.kind == "decode" and self.batch > 0 \
            and self.prefill_tokens == 0


@dataclass
class Run:
    """What one run saw: the readers of ``metrics/`` take it."""
    seconds: float
    window_open: float
    window_close: float
    end: float
    setup_s: float
    requests: Dict[int, ReqRecord]
    steps: List[StepRecord]
    target_sizes: dict
    trace: Optional[object] = None          # device_trace.Slice
    lateness: List[float] = field(default_factory=list)


def build_engine(tcfg, dcfg, deployment: dict, params, device: str = "cuda",
                 wrap: Optional[Callable] = None):
    """A ``ServingEngine`` at the deployment's sizes.  ``wrap`` may replace
    each model's ``ModelAPI`` (the traced run records its paged calls).
    A deployment with ``host_tier_blocks`` (absent: none) spills evicted
    prefix-cache blocks to a host tier of that many blocks, as
    ``build_real_engine``'s ``kv_offload`` does."""
    from repro_torch.core.bandits import make_policy
    from repro_torch.models import registry
    from repro_torch.serving.costmodel import H100_SXM, RooflineCostModel
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import BlockManager, HostKVStore
    from repro_torch.serving.memory_manager import ElasticMemoryManager
    from repro_torch.serving.real_backend import RealBackend, make_real_backend
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    dep = deployment
    host_blocks = int(dep.get("host_tier_blocks", 0))
    if host_blocks and not dep["prefix_caching"]:
        raise ValueError("the host KV tier spills prefix-cache blocks: it "
                         "needs prefix_caching")
    target, draft = registry.get_model(tcfg), registry.get_model(dcfg)
    if wrap is not None:
        target, draft = wrap(target), wrap(draft)
    bm = BlockManager(int(dep["num_blocks"]), int(dep["block_size"]),
                      prefix_caching=bool(dep["prefix_caching"]),
                      host_store=HostKVStore(host_blocks) if host_blocks
                      else None)
    backend = make_real_backend(target, draft, device=device, params=params,
                                max_batch=int(dep["max_batch"]),
                                seed=PLANNER_SEED, block_manager=bm)
    sched = ContinuousBatchingScheduler(
        bm, max_batch=int(dep["max_batch"]),
        chunk_tokens=dep["chunk_tokens"] or None)
    mm = None
    if dep["memory_manager"] and isinstance(backend, RealBackend):
        cm = RooflineCostModel(H100_SXM)
        draft_blocks = max(min(
            -(-cm.weight_bytes(dcfg) // backend.tkv.bytes_per_block),
            bm.total_blocks // 4), 1)
        mm = ElasticMemoryManager(
            bm, draft_blocks=int(draft_blocks),
            offload_fn=backend.offload_draft,
            reload_fn=backend.reload_draft,
            migrate_fn=backend.migrate_pools, grow_fn=backend.grow_pools,
            shrink_fn=backend.shrink_pools)
    gamma_max = int(dep["gamma_max"])
    return ServingEngine(backend, sched,
                         make_policy(dep["policy"], gamma_max,
                                     seed=PLANNER_SEED),
                         mm, gamma_max=gamma_max)


def to_port_requests(reqs):
    from repro_torch.serving.request import Request
    return [Request(r.req_id, r.arrival, len(r.prompt), r.output_len,
                    prompt_tokens=r.prompt.tolist()) for r in reqs]


class OpenLoop:
    """Offers ``requests`` to ``engine`` open loop on the wall clock."""

    def __init__(self, engine, requests, *, clock=time.perf_counter,
                 sleep=time.sleep):
        self.engine = engine
        self.backend = engine.backend
        self.port_reqs = to_port_requests(requests)
        self.recs = {r.req_id: ReqRecord(r.req_id, r.arrival, len(r.prompt),
                                         r.output_len, r.in_window)
                     for r in requests}
        self.steps: List[StepRecord] = []
        self.lateness: List[float] = []
        self.clock, self.sleep = clock, sleep
        self.t0 = None
        self._next = 0
        self._open: Dict[int, ReqRecord] = {}   # submitted, not fully served

    def now(self) -> float:
        return self.clock() - self.t0

    def _submit_due(self, now: float, stop_at: float) -> None:
        while self._next < len(self.port_reqs):
            r = self.port_reqs[self._next]
            if r.arrival > now or r.arrival >= stop_at:
                break
            self.engine.submit(r)
            self.lateness.append(now - r.arrival)
            self._open[r.req_id] = self.recs[r.req_id]
            self._next += 1

    def _observe(self, step: StepRecord) -> None:
        """Stamp what the step changed: admissions, prefill progress and
        served tokens (capped at each request's output length)."""
        t = step.t_end
        for s in self.engine.scheduler.running:
            rec = self._open.get(s.req_id)
            if rec is None:
                continue
            if rec.admitted < 0:
                rec.admitted = step.t_start
            if s.prefilled > rec.prefilled:
                step.chunks.append((s.req_id, rec.prefilled,
                                    s.prefilled - rec.prefilled))
                rec.prefilled = s.prefilled
        outs = self.backend.tokens_out
        done = []
        for rid, rec in self._open.items():
            n = min(len(outs.get(rid, ())), rec.output_len)
            have = len(rec.token_times)
            if n > have:
                if rec.prefilled < rec.prompt_len:
                    # the final chunk and the first token land together
                    step.chunks.append((rid, rec.prefilled,
                                        rec.prompt_len - rec.prefilled))
                    rec.prefilled = rec.prompt_len
                step.served.append((rid, have, n - have))
                rec.token_times.extend([t] * (n - have))
            if len(rec.token_times) >= rec.output_len:
                done.append(rid)
        for rid in done:
            del self._open[rid]

    def step_once(self, now: float) -> Optional[StepRecord]:
        t_start = now
        rep = self.engine.step(now=now)
        t_end = self.now()
        if rep is None:
            return None
        st = StepRecord(len(self.steps), t_start, t_end, rep.kind, rep.batch,
                        rep.gamma, rep.tokens, rep.prefill_tokens,
                        self.engine.scheduler.num_waiting)
        self._observe(st)
        self.steps.append(st)
        return st

    def run(self, *, lead_in_s: float, seconds: float,
            on_step: Optional[Callable] = None) -> float:
        """Offer the traffic from now; the window is [lead_in_s,
        lead_in_s + seconds).  Nothing is sent after the window closes; the
        run then goes on until every request due in the window has its
        first token, or for ``DRAIN_CAP_S`` at most.  ``on_step(loop,
        now)`` runs before each step (the traced run starts and stops the
        profiler there).  Returns the time the run stopped."""
        self.t0 = self.clock()
        close = lead_in_s + seconds
        window = [r for r in self.recs.values() if r.in_window]
        while True:
            now = self.now()
            self._submit_due(now, close)
            if now >= close and (now >= close + DRAIN_CAP_S or all(
                    r.token_times for r in window)):
                return now
            if on_step is not None:
                on_step(self, now)
            if self.engine.has_work():
                if self.step_once(now) is not None:
                    continue
            nxt = (self.port_reqs[self._next].arrival
                   if self._next < len(self.port_reqs) else close)
            self.sleep(max(min(nxt, close) - self.now(), 0.0) or 1e-4)


def served_streams(backend, recs: Dict[int, ReqRecord]) -> Dict[int, list]:
    """Each fully served request's tokens, as the user received them."""
    out = {}
    for rid, rec in recs.items():
        toks = backend.tokens_out.get(rid, [])
        if len(rec.token_times) >= rec.output_len and \
                len(toks) >= rec.output_len:
            out[rid] = [int(t) for t in toks[:rec.output_len]]
    return out


class CallLog:
    """The paged decoder calls of a traced slice: each call's model, its
    padded token shape, block tables, ``start`` and ``valid`` (device
    tensors kept as they are, read on the host once the slice is over, so
    recording adds no synchronise)."""

    def __init__(self):
        self.on = False
        self.calls: List[tuple] = []

    def wrap(self, api):
        log = self
        inner = api.decode_step_paged

        def decode_step_paged(params, pages, tokens, tables, start,
                              valid=None):
            if log.on:
                trash = pages["k_pages"].shape[1] - 1
                log.calls.append((api.cfg, tuple(tokens.shape), tables,
                                  trash, start, valid))
            return inner(params, pages, tokens, tables, start, valid)

        return dataclasses.replace(api, decode_step_paged=decode_step_paged)

    def rows(self):
        """(cfg, [(start, n_valid) of each real row]) per call.  A padded
        row's block table is all write-off ("trash") blocks, and a real
        row in a prefill or mixed step has ``valid`` > 0."""
        out = []
        for cfg, (B, T), tables, trash, start, valid in self.calls:
            real = tables[:, 0].cpu().numpy() != trash
            s = start.cpu().numpy().astype(np.int64)
            v = (np.full(B, T, np.int64) if valid is None
                 else valid.cpu().numpy().astype(np.int64))
            out.append((cfg, [(int(a), int(n)) for a, n, r in zip(s, v, real)
                              if r and n > 0]))
        return out
