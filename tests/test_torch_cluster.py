"""The port's fleet layer against the reference's: the same seeded cluster
run in both packages (router, control plane, autoscaler, admission,
disaggregated pools with the priced handoff, fault injection, brownout)
gives byte-identical ``summary()`` JSON and trace bytes, jsonl and Chrome.

Every case runs paper-7b (a dense pair, so the cost model's terms are the
reference's to the bit) at tens of requests, with a hardware profile
built from the reference's ``RTX_4090`` or, for the chip-to-chip branch of
``SimulatedBackend.kv_transfer_seconds``, its ``TPU_V5E`` (the port ships
no such profile)."""
import dataclasses
import json
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.serving import costmodel as jcm  # noqa: E402
from repro.serving import observability as jobs  # noqa: E402
from repro.serving import simulator as jsim  # noqa: E402
from repro.serving import workload as jwl  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.serving import costmodel as cm  # noqa: E402
from repro_torch.serving import observability as obs  # noqa: E402
from repro_torch.serving import simulator as sim  # noqa: E402
from repro_torch.serving import workload as wl  # noqa: E402

REF = SimpleNamespace(configs=jconfigs, cm=jcm, obs=jobs, sim=jsim, wl=jwl)
PORT = SimpleNamespace(configs=configs, cm=cm, obs=obs, sim=sim, wl=wl)


def _cfg(ns, hw=jcm.RTX_4090, **kw):
    """paper-7b on a profile with the reference profile's values."""
    kw.setdefault("max_batch", 256)
    return ns.sim.SimConfig(
        target=ns.configs.get_config("paper-7b"),
        draft=ns.configs.get_draft_config("paper-7b"),
        hw=ns.cm.HardwareProfile(**dataclasses.asdict(hw)), seed=0, **kw)


def _bursty(ns):
    tr = ns.wl.bursty_trace(base_s=2.0, spike=80.0, spike_s=3.0,
                            drain_s=4.0, seed=0)
    return tr.sample_requests(120, dataset="sharegpt", seed=1)


def _surge_storm(ns, rec):
    tr = ns.wl.surge_trace(base=15.0, surge_mult=3.0, base_s=2.0,
                           surge_s=4.0, recover_s=2.0, seed=5)
    reqs = ns.wl.surge_requests(70, trace=tr, dataset="alpaca", seed=3)
    storm = ns.wl.cancellation_storm(reqs, frac=0.2, start=1.0, end=5.0,
                                     seed=6)
    cl = ns.sim.build_sim_cluster(
        _cfg(ns), 2, "nightjar", shed_factor=1.5,
        brownout=dict(slo=0.001, enter_factor=1.01, exit_factor=0.5,
                      cooldown_s=0.1, check_interval_s=0.05),
        cancels=storm, trace=rec)
    return cl.run(reqs)


def _run(router, **kw):
    def go(ns, rec):
        n = kw.get("replicas", 2)
        ckw = {k: v for k, v in kw.items()
               if k not in ("replicas", "cfg", "reqs")}
        cl = ns.sim.build_sim_cluster(
            _cfg(ns, **kw.get("cfg", {})), n, "nightjar", router=router,
            trace=rec, **ckw)
        reqs = kw.get("reqs", lambda ns: ns.wl.poisson_requests(
            20, 40, dataset="alpaca", seed=1))(ns)
        return cl.run(reqs)
    return go


SCENARIOS = {
    "rr": _run("rr"),
    "jsq": _run("jsq"),
    "kv": _run("kv"),
    "slo": _run("slo"),
    "affinity": _run(
        "affinity", cfg=dict(chunk_tokens=384, prefix_caching=True),
        reqs=lambda ns: ns.wl.templated_requests(30, 40, num_templates=4,
                                                 seed=1)),
    "autoscale_shed_bursty": _run(
        "slo", shed_factor=1.5,
        autoscale=dict(min_replicas=1, max_replicas=2), reqs=_bursty),
    "disagg_mixed": _run(
        "jsq", cfg=dict(chunk_tokens=128, max_batch=48),
        disaggregate=dict(prefill=1, decode=1),
        reqs=lambda ns: ns.wl.mixed_requests(28, 40, seed=1)),
    "disagg_ici_profile": _run(
        "jsq", cfg=dict(hw=jcm.TPU_V5E, chunk_tokens=128, max_batch=48),
        disaggregate=dict(prefill=1, decode=1),
        reqs=lambda ns: ns.wl.poisson_requests(30, 40, dataset="alpaca",
                                               seed=1)),
    "faults": _run(
        "jsq", replicas=4, cfg=dict(chunk_tokens=128, max_batch=48),
        disaggregate=dict(prefill=2, decode=2),
        fault_plan="crash:1@2.0;straggle:0@1..5x3;handoff:fail@2..4#2",
        reqs=lambda ns: ns.wl.mixed_requests(20, 50, seed=3)),
    "brownout_surge_storm": _surge_storm,
}


def _traced(ns, name):
    rec = ns.obs.TraceRecorder()
    m = SCENARIOS[name](ns, rec)
    return m, (json.dumps(m.summary(), sort_keys=True), rec.jsonl_bytes(),
               json.dumps(rec.chrome_events(), sort_keys=True))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cluster_matches_reference(name):
    m, got = _traced(PORT, name)
    _, want = _traced(REF, name)
    assert got[1].count(b"\n") > 100
    assert got == want
    # each case exercises what it names
    s = m.summary()
    if name.startswith("disagg") or name == "faults":
        assert m.handoffs
    if name == "faults":
        assert m.crashes and m.handoff_failures > 0
    if name == "autoscale_shed_bursty":
        assert m.autoscale_events and m.shed
    if name == "brownout_surge_storm":
        assert m.brownout_events and m.cancelled
        assert s["brownout"]["transitions"] == len(m.brownout_events)


def test_kv_transfer_seconds_matches_reference():
    """Both branches of the handoff price: the host link (RTX_4090 has no
    chip-to-chip link) and ``ici_bw`` (TPU_V5E's), to the bit."""
    for hw in (jcm.RTX_4090, jcm.TPU_V5E):
        got = sim.build_sim_engine(_cfg(PORT, hw=hw)).backend
        want = jsim.build_sim_engine(_cfg(REF, hw=hw)).backend
        for n in (1, 192, 4096):
            assert got.kv_transfer_seconds(n) == want.kv_transfer_seconds(n)
            assert got.host_transfer_latency(0, n) \
                == want.host_transfer_latency(0, n)
    assert cm.H100_SXM.ici_bw == 0.0
