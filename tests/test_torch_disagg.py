"""Disaggregated prefill/decode on the port.

* The real tier's handoff (the reference's contract,
  tests/test_disagg.py::test_real_tier_handoff_streams_identical): a
  request prefilled on one ``RealBackend`` and decoded on another, its KV
  blocks moved through ``export_handoff`` / ``import_handoff``, gives the
  colocated greedy stream (fp32, reduced deepseek-7b, on the CPU).  The
  port's colocated stream is held to the reference's by
  tests/test_torch_engine.py.
* The payload is a plain host object: numpy arrays, bf16 pages as int16
  bit patterns, restored bit for bit.
* The handoff pricer's decision flip (tests/test_disagg.py) gives the
  reference's quotes to the bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.serving import controlplane as jcp  # noqa: E402
from repro.serving import costmodel as jcm  # noqa: E402
from repro.serving import request as jrequest  # noqa: E402
from repro.serving import simulator as jsim  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.bandits import make_policy  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import controlplane as cp  # noqa: E402
from repro_torch.serving import costmodel as cm  # noqa: E402
from repro_torch.serving import request  # noqa: E402
from repro_torch.serving import simulator as sim  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import BlockManager  # noqa: E402
from repro_torch.serving.real_backend import RealBackend  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler)
from repro_torch.serving.workload import tiny_requests  # noqa: E402


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _real_engine(dtype="float32", blocks=64, chunk=8):
    """The reference test's engine: chunked prefill (a migration candidate,
    fully prefilled with nothing generated, exists only on the chunked
    path), AR policy, no memory manager."""
    def api(draft=False):
        get = configs.get_draft_config if draft else configs.get_config
        return registry.get_model(
            configs.reduced(get("deepseek-7b")).replace(dtype=dtype))

    target, draft = api(), api(draft=True)
    bm = BlockManager(blocks, 8)
    be = RealBackend(target, draft, device="cpu", max_batch=4, max_seq=96,
                     seed=0, block_manager=bm)
    sched = ContinuousBatchingScheduler(bm, max_batch=4, chunk_tokens=chunk,
                                        watermark_frac=0.0)
    eng = ServingEngine(be, sched, make_policy("ar", 3, seed=0), None,
                        gamma_max=3)
    return eng, be, target.cfg.vocab_size


def _migrate_all(src, dst, check=None):
    """Step ``src``; hand every fully prefilled, not yet decoded sequence
    to ``dst``; then run ``dst`` to the end."""
    for _ in range(3000):
        if not src.has_work():
            break
        src.step()
        for seq in list(src.scheduler.running):
            if seq.prompt_remaining == 0 and not seq.done \
                    and seq.generated == 0:
                payload = src.extract_for_handoff(seq)
                if check is not None:
                    check(payload)
                dst.accept_handoff(seq.request, t_ready=dst.clock,
                                   payload=payload)
    for _ in range(3000):
        if not dst.has_work():
            break
        dst.step()


def test_real_tier_handoff_streams_identical():
    """Prefill on one RealBackend, migrate the KV blocks (export_handoff ->
    spill_blocks gather, import_handoff -> restore_blocks scatter), decode
    on another: the greedy streams equal a colocated run's."""
    out = 8
    base_eng, base_be, vocab = _real_engine()
    reqs = tiny_requests(3, rate_qps=1e6, prompt_len=12, output_len=out,
                         vocab=vocab, seed=5)
    base_eng.run(list(reqs), max_steps=3000)
    base = {r.req_id: base_be.output_tokens(r.req_id)[:out + 1]
            for r in reqs}

    src, _, _ = _real_engine()
    dst, dst_be, _ = _real_engine()
    src.replica_id, dst.replica_id = 0, 1
    for r in reqs:
        src.submit(r)

    def check(payload):
        assert payload["kv"]["n_blocks"] > 0   # bytes travelled
    _migrate_all(src, dst, check)
    assert dst.handoffs_in == 3 and dst.handoffs_refused == 0
    got = {r.req_id: dst_be.output_tokens(r.req_id)[:out + 1] for r in reqs}
    assert got == base
    assert all(len(s) == out + 1 for s in got.values())


def test_handoff_payload_is_host_numpy_bf16_bits():
    """A bf16 payload is host numpy (int16 bit patterns) for both pools,
    and the destination's imported blocks hold the source's bits."""
    src, src_be, vocab = _real_engine(dtype="bfloat16")
    dst, dst_be, _ = _real_engine(dtype="bfloat16")
    req = tiny_requests(1, prompt_len=20, output_len=4, vocab=vocab,
                        seed=1)[0]
    src.submit(req)
    while not any(s.prompt_remaining == 0 for s in src.scheduler.running):
        src.step()
    seq = src.scheduler.running[0]
    table = list(src_be.bm.tables[seq.req_id])
    want = {k: v[:, table].clone() for k, v in src_be.tkv.pages.items()}
    payload = src.extract_for_handoff(seq)
    kv = payload["kv"]
    assert kv["n_blocks"] == len(table) == 3 and kv["ctx"] == 20
    for pool in ("tkv", "dkv"):
        for arr in kv[pool].values():
            assert isinstance(arr, np.ndarray) and arr.dtype == np.int16
            assert arr.shape[1] == len(table)
    dst.accept_handoff(req, t_ready=0.0, payload=payload)
    dst.step()   # adopts the handoff, then decodes (writing position 20)
    ids = list(dst_be.bm.tables[req.req_id])[:len(table)]

    def positions(pages):   # (L, n, bs, KH, hd) -> the 20 prompt positions
        L, n, bs = pages.shape[:3]
        return pages.reshape(L, n * bs, *pages.shape[3:])[:, :20] \
            .view(torch.int16)
    for k, v in dst_be.tkv.pages.items():
        assert torch.equal(positions(v[:, ids]), positions(want[k]))
    assert dst_be.output_tokens(req.req_id)[0] \
        == kv["tokens_out"][0] == kv["last_token"]


def _sim_cfg(ns_sim, ns_cm, ns_cfg):
    return ns_sim.SimConfig(
        target=ns_cfg.get_config("paper-7b"),
        draft=ns_cfg.get_draft_config("paper-7b"),
        hw=ns_cm.HardwareProfile(**dataclasses.asdict(jcm.RTX_4090)),
        seed=0, max_batch=256, chunk_tokens=128)


@pytest.mark.parametrize("backlog_reqs,margin,expect", [
    (40, 0.0, True), (0, 0.0, False), (40, 1e4, False)])
def test_handoff_pricing_matches_reference(backlog_reqs, margin, expect):
    """accept <=> forecast_ttft(src) - forecast_ttft(dst) >
    kv_transfer_seconds(prompt) + margin, with the reference's quotes."""
    quotes = []
    for simm, cmm, cfgm, cpm, reqm in (
            (sim, cm, configs, cp, request),
            (jsim, jcm, jconfigs, jcp, jrequest)):
        src = simm.build_sim_engine(_sim_cfg(simm, cmm, cfgm), "nightjar")
        dst = simm.build_sim_engine(_sim_cfg(simm, cmm, cfgm), "nightjar")
        src.replica_id, dst.replica_id = 0, 1
        for i in range(backlog_reqs):
            src.submit(reqm.Request(100 + i, 0.0, 1024, 8))
        pricer = cpm.HandoffPricer(cpm.ControlPlane(), margin_s=margin)
        req = reqm.Request(0, 0.0, 512, 64)
        saved, cost = pricer.quote(src, dst, req, 0.0)
        assert cost >= pricer.transfer_seconds(src, req.prompt_len) > 0.0
        assert pricer.decide(src, dst, req, 0.0) is expect
        quotes.append((saved, cost))
    assert quotes[0] == quotes[1]


def test_traced_engine_is_freed_without_a_collect():
    """An engine with a trace recorder attached holds no reference cycle:
    dropping it frees its backend (and the weights) at once, with the
    cyclic collector off.  The recorder's context closures once held the
    engine strongly through its own scheduler and block manager, which
    kept both replicas of the handoff phase on the card alive."""
    import gc
    import weakref

    from repro_torch.serving.observability import TraceRecorder
    gc.collect()
    gc.disable()
    try:
        eng, be, vocab = _real_engine()
        eng.attach_trace(TraceRecorder())
        eng.run(tiny_requests(2, prompt_len=12, output_len=4, vocab=vocab,
                              seed=3), max_steps=500)
        assert eng.trace.events
        ref = weakref.ref(be)
        del eng, be
        assert ref() is None
    finally:
        gc.enable()
