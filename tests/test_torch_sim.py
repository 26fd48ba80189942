"""The port's simulated tier against the reference's: the roofline cost
model's latency half, the simulated backend under one engine, and the
``--tier sim`` command line.

* Single-engine runs of paper-7b (ar, fixed and nightjar; chunked prefill
  with a TTFT SLO; the templated workload with prefix caching; sessions
  with the host KV tier) give byte-identical ``summary()`` JSON and trace
  bytes in both packages, on a profile built from the reference's
  ``RTX_4090``.
* The cost model equals the reference's to the bit on every dense config.
  On the configs with fp32 leaves (granite's MoE router, the SSM layers'
  A_log / D / dt_bias: ROADMAP C7) it differs by exactly the term that
  reads ``weight_bytes``.
* The reference's ``test_sim_crossover_exists`` and
  ``test_sim_nightjar_tracks_best_arm`` (tests/test_spec_engine.py) hold
  on the port, the crossover also under the port's ``H100_SXM``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import cswitch as jcswitch  # noqa: E402
from repro.serving import costmodel as jcm  # noqa: E402
from repro.serving import observability as jobs  # noqa: E402
from repro.serving import simulator as jsim  # noqa: E402
from repro.serving import workload as jwl  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import cswitch  # noqa: E402
from repro_torch.serving import costmodel as cm  # noqa: E402
from repro_torch.serving import observability as obs  # noqa: E402
from repro_torch.serving import simulator as sim  # noqa: E402
from repro_torch.serving import workload as wl  # noqa: E402

REF = SimpleNamespace(configs=jconfigs, cm=jcm, obs=jobs, sim=jsim, wl=jwl)
PORT = SimpleNamespace(configs=configs, cm=cm, obs=obs, sim=sim, wl=wl)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _hw(ns, ref_profile):
    """A profile of ``ns``'s package with ``ref_profile``'s values."""
    return ns.cm.HardwareProfile(**dataclasses.asdict(ref_profile))


def _cfg(ns, **kw):
    kw.setdefault("max_batch", 256)
    return ns.sim.SimConfig(
        target=ns.configs.get_config("paper-7b"),
        draft=ns.configs.get_draft_config("paper-7b"),
        hw=_hw(ns, jcm.RTX_4090), seed=0, **kw)


def _engine(policy, reqs, **kw):
    def go(ns, rec):
        eng = ns.sim.build_sim_engine(_cfg(ns, **kw), policy, trace=rec)
        return eng.run(reqs(ns))
    return go


def _sharegpt(ns):
    return ns.wl.poisson_requests(10, 40, dataset="sharegpt", seed=1)


SCENARIOS = {
    "ar": _engine("ar", _sharegpt),
    "fixed": _engine("fixed-3", _sharegpt),
    "nightjar": _engine("nightjar", _sharegpt),
    "chunked_slo": _engine(
        "nightjar", lambda ns: ns.wl.poisson_requests(
            30, 50, dataset="sharegpt", seed=1, slo=0.5),
        chunk_tokens=256),
    "templated_prefix": _engine(
        "nightjar", lambda ns: ns.wl.templated_requests(40, 40, seed=1),
        chunk_tokens=384, prefix_caching=True),
    "sessions_kv_offload": _engine(
        "nightjar", lambda ns: ns.wl.session_requests(8, rate_qps=0.5,
                                                      seed=1),
        chunk_tokens=384, prefix_caching=True, kv_offload=True,
        num_blocks=160),
}


def _traced(ns, name):
    rec = ns.obs.TraceRecorder()
    m = SCENARIOS[name](ns, rec)
    return m, (json.dumps(m.summary(), sort_keys=True), rec.jsonl_bytes(),
               json.dumps(rec.chrome_events(), sort_keys=True))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_reference(name):
    m, got = _traced(PORT, name)
    _, want = _traced(REF, name)
    assert got[1].count(b"\n") > 100
    assert got == want
    if name in ("templated_prefix", "sessions_kv_offload"):
        assert m.prefix["hits"] > 0 and m.prefix["saved_tokens"] > 0
    if name == "sessions_kv_offload":
        assert m.host["restores"] > 0


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


C7_ARCHS = ("granite-moe-1b-a400m", "mamba2-780m", "zamba2-1.2b")
DENSE_ARCHS = tuple(a for a in jconfigs.list_archs()
                    if a not in C7_ARCHS + ("grok-1-314b",))


def _latencies(model, t, d):
    out = []
    for B in (1, 8, 256):
        for ctx in (128, 512, 4096):
            out += [model.decode_latency(t, B, ctx),
                    model.decode_latency(t, B, ctx, 4),
                    model.prefill_latency(t, B, ctx),
                    model.prefill_latency(d, B, ctx),
                    model.ar_step_latency(t, B, ctx),
                    model.spec_step_latency(t, d, B, ctx, 3),
                    model.hybrid_step_latency(t, 256, B, ctx),
                    model.hybrid_step_latency(t, 64, B, ctx, 2, 300)]
    out += [model.knee_chunk_tokens(t), model.knee_chunk_tokens(t, batch=32),
            model.resolve_chunk_tokens("auto", t),
            model.resolve_chunk_tokens("auto"),
            model.resolve_chunk_tokens("96", t), model.offload_latency(d),
            model.reload_latency(d), model.kv_capacity_tokens(t, d)]
    return out


def _pair(arch, profile, **kw):
    """(port model, reference model, port pair, reference pair); each
    model gets a profile of its own package with ``profile``'s values."""
    return (cm.RooflineCostModel(_hw(PORT, profile), **kw),
            jcm.RooflineCostModel(_hw(REF, profile), **kw),
            (configs.get_config(arch), configs.get_draft_config(arch)),
            (jconfigs.get_config(arch), jconfigs.get_draft_config(arch)))


@pytest.mark.parametrize("hw", [jcm.RTX_4090, jcm.A100_40G, jcm.TPU_V5E])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_costmodel_matches_reference_dense(arch, hw):
    """Every latency of a config without fp32 leaves is the reference's to
    the bit, with no substitution (also at other mfu / bwu)."""
    port, ref, (t, d), (jt, jd) = _pair(arch, hw)
    assert _latencies(port, t, d) == _latencies(ref, jt, jd)
    port, ref, _, _ = _pair(arch, hw, mfu=0.45, bwu=0.9)
    assert _latencies(port, t, d) == _latencies(ref, jt, jd)


@pytest.mark.parametrize("arch", C7_ARCHS)
def test_costmodel_differs_only_by_fp32_leaves(arch):
    """ROADMAP C7: with the port's ``weight_bytes`` substituted on the
    reference *instance*, the reference's latencies equal the port's to
    the bit; without it, the weight-read term differs (granite at B = 1
    and B = 256 by 1,572,864 B over 0.8 of the H100 profile's HBM rate:
    0.587 µs per decode step)."""
    for hw in (jcm.RTX_4090, cm.H100_SXM):
        port, ref, (t, d), (jt, jd) = _pair(arch, hw)
        assert port._params(t) == ref._params(jt)
        assert port._params(d) == ref._params(jd)
        plain = _latencies(ref, jt, jd)
        by_ref = {jt: t, jd: d}
        ref.weight_bytes = lambda c: port.weight_bytes(by_ref[c])
        assert _latencies(port, t, d) == _latencies(ref, jt, jd)
        assert _latencies(port, t, d) != plain
    port, ref, (t, _), (jt, _) = _pair(arch, cm.H100_SXM)
    extra = port.weight_bytes(t) - ref.weight_bytes(jt)
    assert extra == {"granite-moe-1b-a400m": 1_572_864,
                     "mamba2-780m": 13_824, "zamba2-1.2b": 14_592}[arch]
    if arch == "granite-moe-1b-a400m":
        for B in (1, 256):
            delta = port.decode_latency(t, B, 512) \
                - ref.decode_latency(jt, B, 512)
            assert delta == pytest.approx(extra / (3.35e12 * 0.8),
                                          rel=1e-6)


def test_cswitch_from_cost_model_matches_reference():
    port, ref, (_, d), (_, jd) = _pair("paper-7b", jcm.RTX_4090)
    got = cswitch.CSwitchTable.from_cost_model(port, d)
    want = jcswitch.CSwitchTable.from_cost_model(ref, jd)
    assert got.table == want.table and got.c_max == want.c_max


@pytest.mark.parametrize("profile", ["rtx4090", "h100-sxm"])
def test_sim_crossover_exists(profile):
    """The reference's contract on the port: SD beats AR at B = 1, loses at
    B = 256.  Under the H100 profile a gamma = 3 step at B = 256 is
    30.3 ms against an AR step of 8.5 ms (compute-bound), so hi ~ 0.70,
    and lo ~ 1.96."""
    hw = {"rtx4090": cm.RTX_4090, "h100-sxm": cm.H100_SXM}[profile]
    t = configs.get_config("paper-7b")
    d = configs.get_draft_config("paper-7b")
    model = cm.RooflineCostModel(hw)
    exp_tokens = 2.5  # E[committed] per seq at alpha~0.65, gamma=3
    lo = (exp_tokens / model.spec_step_latency(t, d, 1, 512, 3)) / \
         (1.0 / model.ar_step_latency(t, 1, 512))
    hi = (exp_tokens / model.spec_step_latency(t, d, 256, 512, 3)) / \
         (1.0 / model.ar_step_latency(t, 256, 512))
    assert lo > 1.2, lo     # memory-bound regime: SD wins
    assert hi < 1.0, hi     # compute-bound regime: SD loses
    if profile == "h100-sxm":
        assert lo == pytest.approx(1.96, abs=0.01)
        assert hi == pytest.approx(0.70, abs=0.01)
        assert model.spec_step_latency(t, d, 256, 512, 3) \
            == pytest.approx(30.3e-3, abs=0.05e-3)
        assert model.ar_step_latency(t, 256, 512) \
            == pytest.approx(8.5e-3, abs=0.05e-3)


def test_sim_nightjar_tracks_best_arm():
    """The reference's contract on the port: Nightjar ends within 15 % of
    the better of (AR, SD) at both load extremes."""
    t = configs.get_config("paper-7b")
    d = configs.get_draft_config("paper-7b")
    res = {}
    for rate in (4, 30):
        row = {}
        for pol in ("ar", "sd", "nightjar"):
            eng = sim.build_sim_engine(
                sim.SimConfig(target=t, draft=d, hw=cm.RTX_4090,
                              max_batch=256, seed=0), pol)
            reqs = wl.poisson_requests(rate, min(int(rate * 15), 300),
                                       dataset="sharegpt", seed=1)
            row[pol] = eng.run(reqs, max_steps=300_000).throughput
        res[rate] = row
    for rate, row in res.items():
        best = max(row["ar"], row["sd"])
        assert row["nightjar"] > 0.85 * best, (rate, row)


def test_simconfig_defaults_to_h100():
    assert sim.SimConfig(target=configs.get_config("paper-7b"),
                         draft=configs.get_draft_config("paper-7b")).hw \
        is cm.H100_SXM


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _cli(module, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", module, *args], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [
    (),
    ("--replicas", "2", "--router", "affinity", "--dataset", "templated",
     "--num-templates", "4", "--chunk-tokens", "384",
     "--prefix-caching", "on", "--rate", "40"),
])
def test_cli_sim_matches_reference(extra, tmp_path):
    """``--tier sim`` prints the reference's stdout for the same arguments,
    and ``--trace`` / ``--metrics-out`` write the same bytes."""
    outs = {}
    for module in ("repro_torch.launch.serve", "repro.launch.serve"):
        d = tmp_path / module.split(".")[0]
        d.mkdir()
        r = _cli(module, "--tier", "sim", "--hw", "rtx-4090", "--requests",
                 "40", "--trace", str(d / "t.jsonl"), "--metrics-out",
                 str(d / "m.prom"), *extra)
        assert r.returncode == 0, r.stderr
        outs[module] = (r.stdout, (d / "t.jsonl").read_bytes(),
                        (d / "m.prom").read_bytes())
    got, want = outs.values()
    assert json.loads(got[0])["elapsed_s"] > 0
    assert got == want


@pytest.mark.parametrize("flags", [
    ("--replicas", "2"), ("--fault-plan", "crash:1@2.0"), ("--brownout",),
    ("--disaggregate", "1:1"), ("--hw", "rtx-4090")])
def test_cli_refuses_sim_flags_on_real_tier(flags, monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--tier", "real", "--device",
                                      "cpu", *flags])
    with pytest.raises(SystemExit) as e:
        serve.main()
    assert e.value.code == 2
    assert "simulated tier only" in capsys.readouterr().err
