"""The flight recorder on the wall clock: phase spans nested by cause in the
engine and the paged backend, the padded-position counters against the
operands the models receive, request lanes on the recorder's clock, the
profiler alignment, the served streams unchanged by the recorder, the
real tier's ``--trace`` on the wall clock, and the span readings of
``tools/span_readings.py`` (idle time by phase, the seven readers) on
synthetic and on CPU runs of the benchmark's harness."""
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.bandits import make_policy  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import BlockManager  # noqa: E402
from repro_torch.serving.observability import TraceRecorder  # noqa: E402
from repro_torch.serving.real_backend import RealBackend  # noqa: E402
from repro_torch.serving.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serving.workload import tiny_requests  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


spans_mod = _load("span_readings", ROOT / "tools" / "span_readings.py")

ENGINE_PHASES = ("engine.admit", "engine.memmgr", "engine.plan",
                 "engine.reserve", "engine.catchup", "engine.execute",
                 "engine.commit")
BACKEND_PHASES = ("backend.copies", "backend.pack", "backend.dispatch",
                  "backend.sync", "backend.unpack")


class FakeClock:
    """A clock that moves one millisecond at every reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _spans(rec):
    return [e for e in rec.events if "id" in e]


def _check_nesting(spans):
    """Every child lies inside its parent and names it; ids are unique."""
    by_id = {e["id"]: e for e in spans}
    assert len(by_id) == len(spans)
    for e in spans:
        assert e["dur"] >= 0
        if e["parent"] is None:
            continue
        p = by_id[e["parent"]]
        assert p["t"] <= e["t"] and e["t"] + e["dur"] <= p["t"] + p["dur"] \
            + 1e-9, (e, p)
    return by_id


# ---------------------------------------------------------------------------
# the recorder alone
# ---------------------------------------------------------------------------


def test_fake_clock_spans_nest_by_cause():
    rec = TraceRecorder(clock=FakeClock())
    for _ in range(3):
        rec.open("step", 2)
        rec.open("engine.admit")
        rec.switch("engine.execute")
        rec.open("backend.pack")
        rec.switch("backend.dispatch", model="target", positions_run=32,
                   positions_valid=5)
        rec.close()
        rec.close()
        rec.open("engine.commit")
        rec.step_span(0.0, 0.0, 2, batch=4, gamma=1, tokens=6, accepted=2)
        rec.close_step("decode")    # closes the open engine.commit too
    spans = _spans(rec)
    by_id = _check_nesting(spans)
    steps = [e for e in spans if e["name"] == "step"]
    assert len(steps) == 3 and all(e["parent"] is None for e in steps)
    for e in spans:
        assert e["pid"] == 2
        if e["name"].startswith("engine."):
            assert by_id[e["parent"]]["name"] == "step"
        if e["name"].startswith("backend."):
            assert by_id[e["parent"]]["name"] == "engine.execute"
    pack = [e for e in spans if e["name"] == "backend.pack"]
    assert pack[0]["args"] == {"model": "target", "positions_run": 32,
                               "positions_valid": 5}
    assert steps[0]["args"] == {"B": 4, "gamma": 1, "tokens": 6,
                                "accepted": 2, "prefill_tokens": 0,
                                "draft_ok": True, "forced_off": False,
                                "kind": "decode"}
    assert rec.registry.counter("steps_total").value == 3
    assert rec._spans == []


def test_clocked_lanes_and_instants_take_the_clock():
    """A clocked recorder stamps every event with its clock, whatever time
    the caller passes; a clockless one keeps the caller's."""
    rec = TraceRecorder(clock=FakeClock())
    rec.req_submit(7, 100.0, 0)
    rec.req_stage(7, 200.0, "prefill")
    rec.instant("kv", "spill", 300.0, replica=0)
    rec.req_end(7, 400.0, "finished")
    # submit, queue (closed by the prefill stamp), the instant, prefill
    # (closed by the end), finished
    assert [e["t"] for e in rec.events] == pytest.approx(
        [0.001, 0.001, 0.003, 0.002, 0.004], abs=1e-12)
    plain = TraceRecorder()
    plain.req_submit(7, 100.0, 0)
    assert plain.events[0]["t"] == 100.0


def test_align_profiler_pairs_step_ranges():
    """Steps recorded under a CPU profiler pair with its nightjar.step
    ranges; the offset holds across them."""
    from torch.profiler import ProfilerActivity, profile
    rec = TraceRecorder(clock=time.perf_counter)
    rec.open("step")                     # before the profiler: not paired
    rec.close_step("idle")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for n in (64, 128, 96):
            rec.open("step")
            rec.open("engine.execute")
            torch.randn(n, n) @ torch.randn(n, n)
            rec.close_step("decode")
    got = rec.align_profiler(prof.events())
    assert got["pairs"] == got["ranges"] == got["spans"] == 3
    assert got["max_dur_diff_s"] < 1e-3 and got["max_skew_s"] < 1e-3
    names = {e.name for e in prof.events()}
    assert {"nightjar.step", "nightjar.engine.execute"} <= names
    clock = [e for e in rec.events if e["cat"] == "clock"]
    assert len(clock) == 1 and clock[0]["args"]["offset_s"] == pytest.approx(
        got["offset_s"])


# ---------------------------------------------------------------------------
# a CPU RealBackend engine at tiny widths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    cfg = configs.reduced(configs.get_config("paper-7b")).replace(
        dtype="float32")
    dcfg = configs.reduced(configs.get_draft_config("paper-7b")).replace(
        dtype="float32")
    return (cfg, dcfg, registry.get_model(cfg).init(device="cpu", seed=1),
            registry.get_model(dcfg).init(device="cpu", seed=2))


def _wrap(api, name, calls):
    """``api`` with its paged decoder recording each call's model, padded
    positions and real positions."""
    inner = api.decode_step_paged

    def decode_step_paged(params, pages, tokens, tables, start, valid=None):
        B, T = tokens.shape
        if valid is None:
            trash = pages["k_pages"].shape[1] - 1
            real = int((tables[:, 0] != trash).sum()) * T
        else:
            real = int(valid.sum())
        calls.append((name, B * T, real))
        return inner(params, pages, tokens, tables, start, valid)

    return dataclasses.replace(api, decode_step_paged=decode_step_paged)


def _serve(pair, chunk, traced, *, n=6, rate_qps=100.0):
    cfg, dcfg, tp, dp = pair
    calls = []
    target = _wrap(registry.get_model(cfg), "target", calls)
    draft = _wrap(registry.get_model(dcfg), "draft", calls)
    bm = BlockManager(256, 8, prefix_caching=chunk is not None)
    be = RealBackend(target, draft, device="cpu", params=(tp, dp),
                     max_batch=4, block_manager=bm)
    eng = ServingEngine(be, ContinuousBatchingScheduler(
        bm, max_batch=4, chunk_tokens=chunk),
        make_policy("nightjar", 3, seed=0), None, gamma_max=3)
    rec = TraceRecorder(clock=time.perf_counter) if traced else None
    if rec is not None:
        eng.attach_trace(rec)
    reqs = tiny_requests(n, rate_qps=rate_qps, prompt_len=24, output_len=12,
                         vocab=cfg.vocab_size, seed=0)
    eng.run(reqs, max_steps=3000)
    streams = {r.req_id: be.output_tokens(r.req_id) for r in reqs}
    return SimpleNamespace(rec=rec, calls=calls, streams=streams, eng=eng)


@pytest.fixture(scope="module", params=[16, None], ids=["chunked", "mono"])
def served(request, pair):
    return (_serve(pair, request.param, False),
            _serve(pair, request.param, True))


def test_streams_unchanged_by_the_recorder(served):
    plain, traced = served
    assert traced.streams == plain.streams
    assert all(len(s) >= 12 for s in plain.streams.values())
    assert plain.eng.spans is None and plain.eng.backend.spans is None
    assert traced.eng.backend.spans is traced.rec


def test_steps_nest_and_children_cover_them_in_order(served):
    rec = served[1].rec
    spans = _spans(rec)
    by_id = _check_nesting(spans)
    assert rec.dropped == 0 and rec._spans == []
    kids = {}
    for e in spans:
        kids.setdefault(e["parent"], []).append(e)
    steps = [e for e in spans if e["name"] == "step"]
    assert {e["args"]["kind"] for e in steps} >= {"decode", "mixed"}
    names = {e["name"] for e in spans}
    assert set(ENGINE_PHASES) - {"engine.catchup"} <= names
    assert set(BACKEND_PHASES) <= names
    cover = []
    for st in steps:
        ch = sorted(kids.get(st["id"], []), key=lambda e: e["t"])
        assert all(e["name"] in ENGINE_PHASES for e in ch)
        for a, b in zip(ch, ch[1:]):     # one after another, no overlap
            assert a["t"] + a["dur"] <= b["t"] + 1e-9
        if st["args"]["kind"] != "idle":
            assert ch[-1]["name"] == "engine.commit"
            cover.append(sum(e["dur"] for e in ch) / st["dur"])
    assert sorted(cover)[len(cover) // 2] >= 0.95
    for e in spans:
        if e["name"].startswith("backend."):
            assert by_id[e["parent"]]["name"] in ("engine.execute",
                                                  "engine.catchup")


def test_request_lanes_balance_on_the_wall_clock(served):
    rec = served[1].rec
    lanes = {}
    for e in rec.events:
        if e.get("req") is not None:
            lanes.setdefault(e["req"], []).append(e)
    assert len(lanes) == 6 and not rec.open_spans()
    steps = [e for e in _spans(rec) if e["name"] == "step"]
    admits = [e for e in _spans(rec) if e["name"] == "engine.admit"]
    lo = min(e["t"] for e in steps)
    hi = max(e["t"] + e["dur"] for e in steps)
    for rid, evs in lanes.items():
        submit = next(e for e in evs if e["name"] == "submit")
        end = next(e for e in evs if e["name"] == "finished")
        stages = [e for e in evs if e["ph"] == "X"]
        assert [e["name"] for e in stages][:1] == ["queue"]
        assert stages[0]["t"] == submit["t"]
        # every arrival lies ahead of the engine's clock at the submit: the
        # lane opens in the step that drains it
        assert any(a["t"] <= submit["t"] <= a["t"] + a["dur"]
                   for a in admits)
        assert sum(e["dur"] for e in stages) == pytest.approx(
            end["t"] - submit["t"], abs=1e-6)
        assert lo <= end["t"] <= hi


@pytest.mark.parametrize("chunk", [16, None], ids=["chunked", "mono"])
def test_queue_lanes_start_at_the_arrival_not_the_submit(pair, chunk):
    """``run`` submits every request up front; arrivals half a second apart
    on the engine's clock open their lanes when its clock reaches them, in
    the ``engine.admit`` of the step that drains them, so no queue span
    and no e2e latency holds the wait for the arrival."""
    got = _serve(pair, chunk, True, n=4, rate_qps=2.0)
    rec = got.rec
    spans = _spans(rec)
    steps = [e for e in spans if e["name"] == "step"]
    admits = [e for e in spans if e["name"] == "engine.admit"]
    queue = {e["req"]: e for e in rec.events if e.get("req") is not None
             and e["name"] == "queue" and e["ph"] == "X"}
    done = {e["req"]: e["t"] for e in rec.events if e["name"] == "finished"}
    assert len(queue) == len(done) == 4 and not rec.open_spans()
    for rid, q in queue.items():
        assert any(a["t"] <= q["t"] <= a["t"] + a["dur"] for a in admits), q
        if rid:
            assert q["t"] > steps[0]["t"] + steps[0]["dur"]
    e2e = rec.registry.histogram("request_e2e_seconds")
    assert e2e.count == 4 and e2e.sum == pytest.approx(
        sum(done[r] - q["t"] for r, q in queue.items()), abs=1e-5)
    # the arrivals span over a second of the engine's clock: each request
    # waited for its arrival in ``_pending``, on no lane
    assert got.eng.clock > 1.0


def test_positions_counters_equal_the_models_operands(served):
    traced = served[1]
    want = {"target": [0, 0], "draft": [0, 0]}
    for name, run, real in traced.calls:
        want[name][0] += run
        want[name][1] += real
    got = {"target": [0, 0], "draft": [0, 0]}
    for e in _spans(traced.rec):
        if e["name"] != "backend.pack":
            continue
        a = e["args"]
        for m in (("target", "draft") if a["model"] == "spec"
                  else (a["model"],)):
            got[m][0] += a["positions_run"]
            got[m][1] += a["positions_valid"]
    assert got == want
    assert want["target"][0] > want["target"][1] > 0


def test_an_untraced_cluster_recorder_keeps_virtual_time(pair):
    """A clockless recorder on the real tier records no phase spans."""
    cfg, dcfg, tp, dp = pair
    from repro_torch.launch.serve import build_real_engine
    eng = build_real_engine(cfg, dcfg, device="cpu", chunk_tokens=16,
                            seed=0, params=(tp, dp))
    rec = TraceRecorder()
    eng.attach_trace(rec)
    eng.run(tiny_requests(2, prompt_len=16, output_len=4,
                          vocab=cfg.vocab_size, seed=0), max_steps=500)
    assert eng.spans is None and not _spans(rec)
    assert any(e["name"] == "step" for e in rec.events)


def test_serve_cli_real_tier_traces_wall_time(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve
    out = tmp_path / "trace.jsonl"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--tier", "real", "--device", "cpu", "--requests", "3",
        "--chunk-tokens", "8", "--trace", str(out)])
    serve.main()
    capsys.readouterr()
    evs = [json.loads(ln) for ln in out.read_text().splitlines()]
    spans = [e for e in evs if "id" in e]
    steps = [e for e in spans if e["name"] == "step"
             and e["args"]["kind"] != "idle"]
    assert steps and all(e["dur"] > 0 for e in steps)
    by_id = _check_nesting(spans)
    assert any(by_id[e["parent"]]["name"] == "engine.execute"
               for e in spans if e["name"] == "backend.dispatch")


# ---------------------------------------------------------------------------
# the span readings
# ---------------------------------------------------------------------------


def test_idle_by_phase_on_synthetic_events():
    """Device busy [0, 1) and [5, 6) in a slice [0, 10): idle [1, 5) and
    [6, 10).  The gap [1, 5) is split between a dispatch nested in a step
    ([0, 3)) and the engine's commit ([3, 4.5)); [4.5, 5) is outside."""
    dev = [(0.0, 1.0), (5.0, 6.0)]
    phases = [(0.0, 4.5, "nightjar.step"),
              (0.5, 3.0, "nightjar.engine.execute"),
              (0.6, 3.0, "nightjar.backend.dispatch"),
              (3.0, 4.5, "nightjar.engine.commit"),
              (6.0, 8.0, "nightjar.step"),
              (6.0, 7.0, "nightjar.engine.admit")]
    got = spans_mod.idle_by_phase(dev, phases, 0.0, 10.0)
    assert got == pytest.approx({"backend.dispatch": 2.0,
                                 "engine.commit": 1.5, "engine.admit": 1.0,
                                 "step": 1.0, "outside": 2.5})
    assert sum(got.values()) == pytest.approx(8.0)
    assert spans_mod.idle_by_phase(dev, [], 0.0, 10.0) == {"outside": 8.0}


def _synthetic_run():
    """A Run of two window steps (pure decode, then mixed) and two window
    requests, with a recorder holding their spans and lanes."""
    from bench_port.lib import device_trace, serve
    clk = FakeClock()
    rec = TraceRecorder(clock=clk)
    rec.req_submit(1, 0.0, 0)          # t 0.001
    rec.req_submit(2, 0.0, 0)          # t 0.002
    clk.t = 10.0
    rec.open("step")
    rec.req_stage(1, 0.0, "prefill")   # queue 1: 10.002 - 0.001
    rec.open("engine.admit")
    rec.switch("engine.execute")
    rec.open("backend.pack")
    rec.switch("backend.dispatch", model="target", positions_run=8,
               positions_valid=8)
    rec.switch("backend.sync")
    rec.close()
    rec.switch("engine.commit")
    rec.close_step("decode")
    clk.t = 11.0
    rec.open("step")
    rec.open("engine.execute")
    rec.open("backend.pack")
    rec.switch("backend.dispatch", model="target", positions_run=64,
               positions_valid=16)
    rec.close()
    rec.open("backend.pack")
    rec.switch("backend.dispatch", model="draft", positions_run=32,
               positions_valid=8)
    rec.close()
    rec.close_step("mixed")
    steps = [e for e in rec.events if e.get("name") == "step"]
    recs = [serve.StepRecord(i, e["t"] - 1e-4, e["t"] + e["dur"] + 1e-4,
                             "decode", 2, 0, 2, pt, 0)
            for i, (e, pt) in enumerate(zip(steps, (0, 16)))]
    reqs = {1: serve.ReqRecord(1, 0.0, 4, 4, True, admitted=9.9),
            2: serve.ReqRecord(2, 0.0, 4, 4, True)}
    trace = device_trace.Slice(wall_s=3.0, busy_s=1.0)
    trace.idle_by_phase = {"backend.dispatch": 1.0, "engine.commit": 0.25,
                           "engine.admit": 0.25, "engine.execute": 0.3,
                           "outside": 0.2}
    run = serve.Run(seconds=10.0, window_open=5.0, window_close=15.0,
                    end=20.0, setup_s=1.0, requests=reqs, steps=recs,
                    target_sizes={}, trace=trace)
    run.spans = rec
    return run, steps


def test_readers_on_a_synthetic_run():
    run, steps = _synthetic_run()
    got = {k: f(run) for k, f in spans_mod.READERS.items()}
    decode = steps[0]
    kids = [e for e in run.spans.events if e.get("parent") == decode["id"]]
    execute = next(e for e in kids if e["name"] == "engine.execute")
    disp = next(e for e in run.spans.events
                if e["name"] == "backend.dispatch"
                and e["parent"] == execute["id"])
    sync = next(e for e in run.spans.events if e["name"] == "backend.sync")
    assert got["mixed_position_yield"] == pytest.approx(25.0)
    assert got["engine_host_ms.decode"] == pytest.approx(
        1e3 * (decode["dur"] - execute["dur"]))
    assert got["dispatch_ms.decode"] == pytest.approx(1e3 * disp["dur"])
    assert got["sync_wait_ms.decode"] == pytest.approx(1e3 * sync["dur"])
    # request 1 queued 10.002 - 0.001 s; request 2 never left the queue
    # and waited until the run stopped, 20 - 0.002 s
    from bench_port.lib import stats
    assert got["queue_span_p95_ms"] == pytest.approx(
        1e3 * stats.p95([10.002 - 0.001, 20.0 - 0.002]))
    assert got["idle_in_dispatch_share"] == pytest.approx(50.0)
    assert got["idle_in_engine_share"] == pytest.approx(25.0)
    # the backend's phases at any depth under the step, and no deeper
    sp = spans_mod.Spans(run.spans)
    assert sp.under(decode["id"], "backend.dispatch") == [disp]
    assert sp.under(disp["id"], "backend.dispatch") == []


@pytest.mark.parametrize("name", list(spans_mod.READERS))
def test_readers_return_none_without_spans(name):
    run, _ = _synthetic_run()
    read = spans_mod.READERS[name]
    assert read(run) is not None
    rec, run.spans = run.spans, None
    assert read(run) is None
    run.spans, run.trace = rec, None
    assert read(run) is None
    run.trace = _synthetic_run()[0].trace
    rec.dropped = 1
    assert read(run) is None


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    conftest = _load("bench_port_tiny_conftest",
                     ROOT / "bench_port" / "tests" / "conftest.py")
    return conftest.tiny_root(tmp_path_factory.mktemp("bench_spans"))


SEED = 2**31 + 7654321


def test_run_cell_without_trace_leaves_the_engine_untraced(tiny_bench):
    from bench_port.lib import cellrun, spec
    cell = spec.find_cell("paper7b-chat-steady", tiny_bench)
    engines = []
    out = cellrun.run_cell(cell, seed=SEED, seconds=1.0, trace=False,
                           t_process=time.time(), device="cpu",
                           root=tiny_bench, fault=engines.append)
    assert out.correct and engines[0].trace is None
    assert engines[0].spans is None and engines[0].backend.spans is None
    assert getattr(out.run, "spans", None) is None


def test_span_run_pairs_steps_with_the_loops_records(tiny_bench):
    """The readings script on the harness's CPU run: the recorder attached
    after the warm-up on the loop's clock, each window step's span inside
    its record, the queue spans beside the harness's queue waits."""
    from bench_port.lib import device_trace, spec, stats
    cell = spec.find_cell("paper7b-chat-steady", tiny_bench)
    out, extra = spans_mod.run(cell, seed=SEED, seconds=1.5, trace=False,
                               device="cpu", root=tiny_bench)
    run = out.run
    assert out.correct and run.spans is not None and run.trace is None
    assert extra == {}
    c = spans_mod.checks(run)
    worked = spans_mod.Spans(run.spans).steps(run, lambda r: r.kind
                                              == "decode")
    assert c["dropped"] == 0 and c["steps_matched"] == len(worked) == len(
        [s for s in stats.window_steps(run) if s.kind == "decode"]) > 0
    assert all(r.t_start <= e["t"] and e["t"] + e["dur"] <= r.t_end
               for e, r in worked)
    assert c["min_child_cover"] > 0
    # a queue span starts at the submit, at or after the due time, and
    # ends inside the step whose start the harness stamps as the admission
    assert c["queue_span_p95_ms"] <= c["queue_from_due_p95_ms"]
    assert c["queue_wait_p95_ms"] <= c["queue_from_due_p95_ms"]
    assert all(f(run) is None for f in spans_mod.READERS.values())
    run.trace = device_trace.Slice(wall_s=1.0)
    run.trace.idle_by_phase = {"outside": 1.0}
    got = {k: f(run) for k, f in spans_mod.READERS.items()}
    assert got["queue_span_p95_ms"] == pytest.approx(c["queue_span_p95_ms"])
    assert (got["dispatch_ms.decode"] is None) == (
        c["decode_step_span_ms"] is None)
    assert 0 < got["mixed_position_yield"] <= 100
    assert got["idle_in_dispatch_share"] == 0.0
    # attached after the warm-up: every span is on the loop's clock, which
    # starts with the traffic
    assert min(e["t"] for e in run.spans.events) >= 0.0
