"""The real tier under memory pressure, the port against the JAX package:
chunked prefill at odd budgets and preempt-and-recompute on a pool too small
for its load (the host KV tier: tests/test_torch_host_tier.py).  The
reduced fp32 paper-7b pair on bridged weights, through
``tests/test_torch_engine.py``'s recipe; greedy streams must be equal.

On the squeezed pool the reference never finishes (ROADMAP C15): its
``ServingEngine._reserve_kv`` preempts the youngest of the sequences whose
reservation failed, which is the elder whenever the younger ones' blocks
are what it lacks.  The port displaces only younger work."""
import pytest

torch = pytest.importorskip("torch")

from repro.core.bandits import make_policy as jmake_policy  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import request as jrequest  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch.core.bandits import make_policy  # noqa: E402
from repro_torch.serving import engine, kv_cache, request, scheduler  # noqa: E402
from test_torch_engine import _bridged, _run  # noqa: E402


def test_chunked_prefill_matches_monolithic_and_jax():
    """Chunk budgets 4, 7 and 16 give the streams of monolithic prefill,
    which equal the JAX RealBackend's, and some step mixes prefill chunks
    with decode rows (tests/test_paged_backend.py:398 on the port)."""
    want, _, jbe = _run("jax", policy="nightjar", prompt=24, out=8)
    params = _bridged(jbe)
    mono, _, _ = _run("torch", policy="nightjar", params=params, prompt=24,
                      out=8)
    assert mono == want
    for chunk in (4, 7, 16):
        mixed = []

        def watch(be, mm):
            hybrid = be.hybrid_step

            def step(chunks, decode, gamma, *, with_draft):
                mixed.append(bool(chunks) and bool(decode))
                return hybrid(chunks, decode, gamma, with_draft=with_draft)
            be.hybrid_step = step
        got, m, _ = _run("torch", policy="nightjar", params=params,
                         chunk=chunk, prompt=24, out=8, watch=watch)
        assert got == mono, chunk
        assert len(m.requests) == 4 and any(mixed), chunk


def test_preempt_recompute_under_pressure_lossless(monkeypatch):
    """tests/test_paged_backend.py:411 on the port: 10 blocks of 4 under
    four requests of 10 + 16 tokens force preempt-and-recompute; all four
    finish, with the streams of a roomy run and of the JAX roomy run."""
    want, _, jbe = _run("jax", policy="nightjar", out=16)
    params = _bridged(jbe)
    roomy, _, _ = _run("torch", policy="nightjar", params=params, out=16)
    assert roomy == want
    preempted = []
    orig = scheduler.ContinuousBatchingScheduler._preempt

    def preempt(self, seq):
        preempted.append(seq.req_id)
        return orig(self, seq)
    monkeypatch.setattr(scheduler.ContinuousBatchingScheduler, "_preempt",
                        preempt)
    for policy in ("nightjar", "ar"):
        preempted.clear()
        squeezed, m, _ = _run("torch", policy=policy, params=params,
                              chunk=6, blocks=10, block_size=4, out=16)
        assert len(m.requests) == 4, policy
        assert squeezed == roomy, policy
        assert len(preempted) > 0, policy


class _TightBackend:
    """Prefills and decodes for free; while no sequence has been preempted
    since the first reservation, the eldest running sequence's reservation
    fails, as when the younger sequences hold the blocks it must grow
    into."""

    def __init__(self, sched, outcome):
        self.sched, self.outcome, self.running0 = sched, outcome, None

    def prefill(self, seqs, *, with_draft):
        return 0.0

    def reserve(self, seqs, gamma):
        n = len(self.sched.running)
        if self.running0 is None:
            self.running0 = n
        if n < self.running0:
            return []
        return [min(seqs, key=self.sched._age_key)]

    def step(self, seqs, gamma):
        return self.outcome([1] * len(seqs), 1e-3)

    def draft_catchup(self, seqs):
        return 0.0

    def release(self, seq):
        pass


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_reserve_failure_displaces_only_younger_work(pkg):
    """ROADMAP C15: when the eldest sequence's KV reservation fails, the
    reference's engine preempts that elder (the youngest of the failed);
    the port preempts the youngest running sequence and the elder decodes."""
    eng_mod, kv, req_mod, sch, mkpol = {
        "jax": (jengine, jkv, jrequest, jscheduler, jmake_policy),
        "torch": (engine, kv_cache, request, scheduler, make_policy)}[pkg]
    sched = sch.ContinuousBatchingScheduler(kv.BlockManager(64, 4),
                                            max_batch=4, watermark_frac=0.0)
    be = _TightBackend(sched, eng_mod.StepOutcome)
    eng = eng_mod.ServingEngine(be, sched, mkpol("ar", 3, seed=0),
                                gamma_max=3)
    for i in range(3):
        eng.submit(req_mod.Request(i, 0.0, 8, 4, 0.9,
                                   prompt_tokens=list(range(8))))
    eng.step()
    waiting = [r.req_id for r in sched.waiting]
    running = sorted(s.req_id for s in sched.running)
    if pkg == "jax":
        assert waiting == [0] and running == [1, 2]   # the elder evicted
    else:
        assert waiting == [2] and running == [0, 1]   # the youngest yields
        assert all(s.generated == 1 for s in sched.running)


def test_port_waits_when_alone_and_out_of_blocks():
    """A sequence alone in the pool whose reservation fails is not
    preempted (its recompute would need the same blocks): it keeps its KV
    and skips the step."""
    sched = scheduler.ContinuousBatchingScheduler(
        kv_cache.BlockManager(64, 4), max_batch=4, watermark_frac=0.0)
    be = _TightBackend(sched, engine.StepOutcome)
    eng = engine.ServingEngine(be, sched, make_policy("ar", 3, seed=0),
                               gamma_max=3)
    eng.submit(request.Request(0, 0.0, 8, 4, 0.9,
                               prompt_tokens=list(range(8))))
    report = eng.step()
    assert report.kind == "idle" and not sched.waiting
    (seq,) = sched.running
    assert seq.generated == 0 and sched.bm.tables[0]
