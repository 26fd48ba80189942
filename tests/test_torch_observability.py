"""The port's flight recorder against the reference's
(tests/test_observability.py): a same-seed simulated run traced in both
packages exports byte-identical jsonl and Chrome files, so the
reference's ``benchmarks/trace_report.py`` reads the port's traces and
finds the same waterfalls, speculation surface and restart episodes; the
metrics exposition is byte-identical; and the reference's invariants
hold on the port's own run (span balance, outcome counts equal to the
metrics, an untraced summary equal to the traced one, a disabled
recorder recording nothing)."""
import dataclasses
import json
import os
import sys

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

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks.trace_report import (analyze, load_trace,  # noqa: E402
                                     restart_episodes, stage_waterfalls)

PKGS = {"port": (configs, cm, obs, sim, wl),
        "ref": (jconfigs, jcm, jobs, jsim, jwl)}


def _cluster_run(pkg, trace=None, brownout=None):
    """The reference test's run: paper-7b, 2 replicas, jsq, 40 alpaca
    requests at 20 qps, on a profile with RTX_4090's values."""
    cfgs, cmod, _, simm, wlm = PKGS[pkg]
    cfg = simm.SimConfig(
        target=cfgs.get_config("paper-7b"),
        draft=cfgs.get_draft_config("paper-7b"),
        hw=cmod.HardwareProfile(**dataclasses.asdict(jcm.RTX_4090)),
        max_batch=256, seed=0)
    cl = simm.build_sim_cluster(cfg, 2, "nightjar", router="jsq",
                                trace=trace, brownout=brownout)
    return cl.run(wlm.poisson_requests(20, 40, dataset="alpaca", seed=1))


BROWNOUT = dict(slo=0.001, enter_factor=1.01, exit_factor=0.5,
                cooldown_s=0.1, check_interval_s=0.05)


@pytest.fixture(scope="module")
def traced():
    """(recorder, metrics) of each package's run, plain and with the
    brownout ladder armed."""
    out = {}
    for pkg in PKGS:
        for kind, bo in (("plain", None), ("brownout", BROWNOUT)):
            rec = PKGS[pkg][2].TraceRecorder()
            out[pkg, kind] = rec, _cluster_run(pkg, rec, bo)
    return out


def test_stages_and_outcomes_match_reference():
    assert obs.STAGES == jobs.STAGES and obs.OUTCOMES == jobs.OUTCOMES
    assert obs.EVENT_RING_CAP == jobs.EVENT_RING_CAP


@pytest.mark.parametrize("kind", ["plain", "brownout"])
def test_exports_byte_identical_to_reference(traced, kind, tmp_path):
    files = {}
    for pkg in PKGS:
        rec = traced[pkg, kind][0]
        for fmt in ("jsonl", "chrome"):
            p = tmp_path / f"{pkg}.{fmt}"
            rec.export(str(p), fmt=fmt)
            files[pkg, fmt] = p.read_bytes()
        files[pkg, "prom"] = rec.registry.exposition().encode()
        assert rec.dropped == 0 and len(rec.events) > 100
    for fmt in ("jsonl", "chrome", "prom"):
        assert files["port", fmt] == files["ref", fmt], fmt
    # the reference's analyser reads the port's file and reports the same
    got = analyze(load_trace(str(tmp_path / "port.jsonl")))
    want = analyze(load_trace(str(tmp_path / "ref.jsonl")))
    assert got == want and got["spec_surface"]


def test_restart_episodes_on_port_trace(traced):
    """The brownout run sheds speculation and resumes it: the reference's
    episode detection finds the same, closed, episodes in the port's
    trace."""
    eps = restart_episodes(
        [json.loads(ln) for ln in traced["port", "brownout"][0]
         .jsonl_lines()])
    assert eps and eps[0]["restart_cost_s"] is not None
    assert eps == restart_episodes(
        [json.loads(ln) for ln in traced["ref", "brownout"][0]
         .jsonl_lines()])


def test_span_balance_and_outcomes_on_port_run(traced):
    """Every terminated request's stage durations sum to its end-to-end
    latency; finished outcomes equal the replicas' finished requests."""
    rec, m = traced["port", "plain"]
    wf = stage_waterfalls([json.loads(ln) for ln in rec.jsonl_lines()])
    assert len([r for r in wf.values() if r["outcome"] == "finished"]) >= 30
    for rid, r in wf.items():
        assert set(r["stages"]) <= set(obs.STAGES)
        assert r["outcome"] in obs.OUTCOMES
        assert sum(r["stages"].values()) == pytest.approx(r["e2e"],
                                                          abs=1e-6), rid
    for rid in rec.open_spans():
        assert rid not in rec.outcomes
    fin = sum(1 for o in rec.outcomes.values() if o == "finished")
    assert fin == sum(len(rm.latencies) for rm in m.per_replica)


def test_untraced_summary_identical_on_port(traced):
    _, m_traced = traced["port", "plain"]
    m_plain = _cluster_run("port")
    rec_off = obs.TraceRecorder(enabled=False)
    m_off = _cluster_run("port", rec_off)
    assert len(rec_off.events) == 0 and rec_off.registry._metrics == {}
    s_plain = json.dumps(m_plain.summary(), sort_keys=True)
    assert s_plain == json.dumps(m_off.summary(), sort_keys=True)
    s_traced = dict(m_traced.summary())
    assert "spec" in s_traced and "spec" not in m_plain.summary()
    s_traced.pop("spec")
    assert s_plain == json.dumps(s_traced, sort_keys=True)


def test_registry_exposition_matches_reference():
    def build(mod):
        reg = mod.MetricsRegistry()
        reg.counter("a_total", "a help").inc(3)
        reg.gauge("g").set(2.5)
        h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        return reg
    got, want = build(obs), build(jobs)
    assert got.exposition() == want.exposition()
    with pytest.raises(ValueError):
        got.gauge("a_total")
