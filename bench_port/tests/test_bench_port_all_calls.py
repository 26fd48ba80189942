"""The attention rooflines over every call of a traced slice
(``lib/call_rows.py``): the call log's calls, and each replayed
pure-decode or spec step's calls read from its ``backend.pack`` span's
``starts``; a captured step is the call log's, and a step outside the
slice counts nothing.  Without replays they read as the call log's
metrics."""
import json

import pytest

from conftest import ROOT
from bench_port.lib import call_rows, device_trace, model, spec
from bench_port.lib.serve import Run, StepRecord

from test_bench_port_spans import FakeClock

CASES = {
    # metric, the call-log metric it extends, configuration, kernel
    "paged_attn_roofline.all_calls": ("paged_attn_roofline", "paper-7b",
                                      "paged_attention_kernel<bf16>"),
    "window_attn_roofline.all_calls": ("window_attn_roofline",
                                       "mellum2-12b-a2.5b",
                                       "paged_window_attention_kernel<bf16>"),
}


def _pair(config):
    path = ROOT / "bench_port" / "configs" / f"{config}.json"
    return model.pair(json.loads(path.read_text()), ROOT)


def _step(rec, clk, t, *, gamma, starts, graph):
    clk.t = t
    rec.open("step")
    rec.open("engine.plan")
    rec.switch("engine.execute")
    rec.open("backend.pack")
    args = dict(positions_run=4 * (gamma + 1),
                positions_valid=len(starts) * (gamma + 1))
    if graph is not None:
        args["starts"] = starts
    rec.switch("backend.dispatch", model="spec" if gamma else "target",
               **args)
    clk.t += 0.01
    rec.switch("backend.sync", **({} if graph is None else {"graph": graph}))
    rec.close()
    rec.close()
    rec.close_step("decode")


def _run(config, *, graphs=True, logged=True):
    """Five steps in the window [5, 15), the first four in the slice: a
    replayed gamma 0 step, a replayed gamma 2 step, a captured step and
    an eager mixed step (the call log's), then a replayed step past the
    slice."""
    from repro_torch.serving.observability import TraceRecorder
    tcfg, dcfg = _pair(config)
    clk = FakeClock()
    rec = TraceRecorder(clock=clk)
    plan = [(6.0, 0, [10, 20], "replay"), (6.5, 2, [11, 21], "replay"),
            (7.0, 1, [30], "capture"), (7.5, 0, [40], "eager"),
            (9.0, 3, [50, 60], "replay")]
    steps = []
    for i, (t, gamma, starts, graph) in enumerate(plan):
        _step(rec, clk, t, gamma=gamma, starts=starts,
              graph=graph if graphs else None)
        span = [e for e in rec.events if e.get("name") == "step"][-1]
        steps.append(StepRecord(i, span["t"] - 1e-4,
                                span["t"] + span["dur"] + 1e-4, "decode",
                                len(starts), gamma, len(starts), 0, 0))
    # the call log: the capture's calls and the mixed step's
    log = [(dcfg, [(30, 1)]), (dcfg, [(31, 1)]), (tcfg, [(30, 2)]),
           (tcfg, [(0, 40), (40, 1)]), (dcfg, [(0, 40)])]
    kernels = CASES[next(m for m, c in CASES.items() if c[1] == config)][2]
    trace = device_trace.Slice(
        wall_s=3.0, kernel_s={kernels: 2e-3, "nvjet_gemm": 1.0},
        kernels_by_step={0: 10, 1: 10, 2: 10, 3: 10},
        calls=log if logged else [])
    tarch, darch = model.archs(json.loads(
        (ROOT / "bench_port" / "configs" / f"{config}.json").read_text()),
        ROOT)
    return Run(seconds=10.0, window_open=5.0, window_close=15.0, end=16.0,
               setup_s=1.0, requests={}, steps=steps, target_sizes={},
               trace=trace, arch=tarch,
               archs={tcfg.name: tarch, dcfg.name: darch}, spans=rec), log


def _need(metric, run, calls):
    def need(arch, cfg, rows, elem):
        if metric.startswith("window"):
            if not hasattr(arch, "window_need"):
                return 0.0
            return call_rows.least_time([arch.window_need(cfg, rows, elem)])
        return call_rows.least_time(arch.attention_need(cfg, rows, elem))
    return sum(need(run.arch_of(c), c, rows, 2) for c, rows in calls)


@pytest.mark.parametrize("logged", [True, False])
@pytest.mark.parametrize("metric", list(CASES))
def test_replayed_steps_count_their_rows(metric, logged):
    """The replayed gamma 0 step ran the target on (10, 1) and (20, 1);
    the replayed gamma 2 step ran the draft on (11 + i, 1) and (21 + i, 1)
    for i = 0, 1, 2, then the target on (11, 3) and (21, 3).  With no
    call in the log, the models are the configuration file's."""
    run, log = _run(CASES[metric][1], logged=logged)
    tcfg, dcfg = _pair(CASES[metric][1])
    calls = (log if logged else []) + [
        (tcfg, [(10, 1), (20, 1)]),
        (dcfg, [(11, 1), (21, 1)]), (dcfg, [(12, 1), (22, 1)]),
        (dcfg, [(13, 1), (23, 1)]), (tcfg, [(11, 3), (21, 3)])]
    assert [(c.name, r) for c, r in call_rows.every_call(run)] == \
        [(c.name, r) for c, r in calls]
    got = spec.load_reader(metric, ROOT)(run)
    assert got == pytest.approx(100.0 * _need(metric, run, calls) / 2e-3,
                                rel=1e-12)
    assert 0 < got < 100


@pytest.mark.parametrize("metric", list(CASES))
def test_without_replays_it_reads_as_the_call_log(metric):
    run, _ = _run(CASES[metric][1], graphs=False)
    old = spec.load_reader(CASES[metric][0], ROOT)(run)
    assert spec.load_reader(metric, ROOT)(run) == pytest.approx(old,
                                                                rel=1e-12)
    assert old > 0
    run.spans = None
    assert spec.load_reader(metric, ROOT)(run) is None


def test_a_model_without_a_window_reads_no_window_share():
    run, _ = _run("paper-7b")
    assert spec.load_reader("window_attn_roofline.all_calls", ROOT)(run) \
        is None


def test_the_metrics_are_the_benchmarks():
    bench = spec.load_benchmark(ROOT)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for metric, (old, _, _) in CASES.items():
        assert per_layer[metric] == dict(per_layer[old], name=metric)
