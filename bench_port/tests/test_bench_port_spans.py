"""The per-layer metrics that read the program's phase spans, and the traced
slice's reading with the program's profiler ranges laid over it.

The seven span metrics read a synthetic run (a recorder driven by a fake
clock through decode, spec and mixed steps, request lanes, and a slice's
idle time by phase) to the numbers ``tools/span_readings.py``'s readers
gave on the same run, frozen here as ``float.hex``.  The slice's reading
keeps the ``nightjar.*`` ranges, on the host and their copies on the
device, out of busy time, kernel time, the kernel count, the top device
operations and the gaps' labels: those equal the same events' reading
without the ranges, and the idle time by phase sums to the slice's idle
time."""
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from bench_port.lib import device_trace, spec
from bench_port.lib.serve import ReqRecord, Run, StepRecord


class FakeClock:
    """A clock that moves one millisecond at every reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _decode_step(rec, clk, t, *, catchup=False, gamma=0, sync_reads=1):
    clk.t = t
    rec.open("step")
    rec.open("engine.admit")
    rec.switch("engine.plan")
    if catchup:
        rec.switch("engine.catchup")
        rec.open("backend.pack")
        rec.switch("backend.dispatch", model="draft", positions_run=3,
                   positions_valid=3)
        rec.close()
    rec.switch("engine.execute")
    rec.open("backend.pack")
    rec.switch("backend.dispatch", model="spec" if gamma else "target",
               positions_run=4 * (gamma + 1), positions_valid=3 * (gamma + 1))
    clk.t += 0.02 * (gamma + 1)
    rec.switch("backend.sync")
    clk.t += 1e-3 * sync_reads
    rec.close()
    rec.switch("engine.commit")
    rec.close_step("decode")


def _mixed_step(rec, clk, t, chunk, decode_rows):
    clk.t = t
    rec.open("step")
    rec.open("engine.admit")
    rec.switch("engine.execute")
    rec.open("backend.pack")
    rec.switch("backend.dispatch", model="target",
               positions_run=chunk + decode_rows + 6,
               positions_valid=chunk + decode_rows)
    clk.t += 0.05
    rec.switch("backend.sync")
    rec.close()
    rec.open("backend.pack")
    rec.switch("backend.dispatch", model="draft", positions_run=chunk,
               positions_valid=chunk)
    rec.close()
    rec.switch("engine.commit")
    rec.close_step("mixed")


def synthetic_run():
    """A window [5, 15) of decode, spec, catch-up and mixed steps, five
    requests (one admitted before the window, one never), and a slice's
    idle time by phase."""
    from repro_torch.serving.observability import TraceRecorder
    clk = FakeClock()
    rec = TraceRecorder(clock=clk)
    for rid, t in ((1, 4.0), (2, 5.5), (3, 6.0), (4, 9.0), (5, 14.0)):
        clk.t = t
        rec.req_submit(rid, 0.0, 0)
    plan = [("decode", 4.5, {}), ("decode", 5.2, {"gamma": 2}),
            ("mixed", 6.1, (40, 1)), ("decode", 6.5, {"catchup": True}),
            ("decode", 7.0, {"sync_reads": 7}), ("mixed", 9.1, (12, 2)),
            ("decode", 9.6, {"gamma": 3}), ("decode", 10.2, {}),
            ("decode", 16.0, {})]
    admits = {0: (1,), 2: (2, 3), 5: (4,)}   # step -> requests it admits
    records = []
    for i, (kind, t, arg) in enumerate(plan):
        for rid in admits.get(i, ()):
            clk.t = t
            rec.req_stage(rid, 0.0, "prefill")
        if kind == "decode":
            _decode_step(rec, clk, t, **arg)
        else:
            _mixed_step(rec, clk, t, *arg)
        span = [e for e in rec.events if e.get("name") == "step"][-1]
        records.append(StepRecord(
            i, span["t"] - 2e-4, span["t"] + span["dur"] + 3e-4, "decode",
            2, arg.get("gamma", 0) if kind == "decode" else 0, 2,
            arg[0] if kind == "mixed" else 0, 0))
    reqs = {1: ReqRecord(1, 4.0, 8, 4, False, admitted=4.5),
            2: ReqRecord(2, 5.5, 40, 4, True, admitted=6.1),
            3: ReqRecord(3, 6.0, 12, 4, True, admitted=6.1),
            4: ReqRecord(4, 9.0, 12, 4, True, admitted=9.1),
            5: ReqRecord(5, 14.0, 12, 4, True)}
    trace = device_trace.Slice(wall_s=3.0, busy_s=0.5)
    trace.idle_by_phase = {"backend.dispatch": 1.25, "backend.sync": 0.125,
                           "engine.commit": 0.25, "engine.admit": 0.0625,
                           "engine.execute": 0.3, "step": 0.05,
                           "outside": 0.2}
    run = Run(seconds=10.0, window_open=5.0, window_close=15.0, end=20.0,
              setup_s=1.0, requests=reqs, steps=records, target_sizes={},
              trace=trace, spans=rec)
    return run


# what ``tools/span_readings.py``'s ``READERS`` read from ``synthetic_run``
TOOL = {
    "mixed_position_yield": "0x1.485bb39503d22p+6",
    "engine_host_ms.decode": "0x1.0666666666666p+3",
    "dispatch_ms.decode": "0x1.499999999999ap+5",
    "sync_wait_ms.decode": "0x1.999999999999ap+1",
    "queue_span_p95_ms": "0x1.4452666666666p+12",
    "idle_in_dispatch_share": "0x1.beed6866f8d97p+5",
    "idle_in_engine_share": "0x1.beed6866f8d97p+3",
}


@pytest.mark.parametrize("name", list(TOOL))
def test_a_span_metric_reads_what_the_tool_read(name):
    read = spec.load_reader(name, ROOT)
    run = synthetic_run()
    assert read(run).hex() == TOOL[name]
    # nothing to read: no recorder, no slice, or a recorder that dropped
    run.spans = None
    assert read(run) is None
    run = synthetic_run()
    run.trace = None
    assert read(run) is None
    run = synthetic_run()
    run.spans.dropped = 1
    assert read(run) is None


def test_the_span_metrics_are_the_benchmarks():
    bench = spec.load_benchmark(ROOT)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in TOOL:
        m = per_layer[name]
        assert m["workloads"] == [w["name"] for w in bench["workloads"]]


# ---------------------------------------------------------------------------
# the traced slice with the program's ranges laid over it
# ---------------------------------------------------------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start_us, end_us, dev=CPU):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


def _base_events():
    """Two steps on the host, kernels, a copy and host operators on the
    device's and host's timelines (µs)."""
    tag = device_trace.STEP_TAG
    return [
        _ev(f"{tag}7", 1_000, 5_000), _ev(f"{tag}7", 1_100, 4_900, CUDA),
        _ev(f"{tag}8", 6_000, 9_000),
        _ev("aten::mm", 1_100, 1_400), _ev("aten::add", 2_000, 2_100),
        _ev("cudaLaunchKernel", 2_100, 2_150), _ev("aten::silu", 6_500, 6_600),
        _ev("paged_attention_kernel", 1_200, 1_500, CUDA),
        _ev("gemm", 1_450, 2_000, CUDA),
        _ev("Memcpy HtoD", 2_200, 2_300, CUDA),
        _ev("gemm", 3_000, 3_200, CUDA), _ev("gemm", 6_100, 6_300, CUDA),
        _ev("silu_kernel", 7_000, 7_050, CUDA),
    ]


def _ranges():
    """``nightjar.*`` ranges over the steps and the gaps, and their copies
    on the device's timeline, one reaching past every other event."""
    p = device_trace.PHASE_PREFIX
    host = [(f"{p}step", 1_050, 4_950), (f"{p}engine.execute", 1_060, 4_000),
            (f"{p}backend.dispatch", 1_080, 2_900),
            (f"{p}backend.sync", 2_900, 3_900),
            (f"{p}engine.commit", 4_000, 4_900),
            (f"{p}step", 6_050, 9_500), (f"{p}engine.admit", 6_050, 6_400),
            (f"{p}backend.dispatch", 6_400, 9_400)]
    return ([_ev(n, a, b) for n, a, b in host]
            + [_ev(n, a + 30, b + 30, CUDA) for n, a, b in host])


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_the_programs_ranges_stay_out_of_the_device_reading():
    kinds = {7: "decode", 8: "mixed"}
    plain = device_trace.read(_Prof(_base_events()), kinds, [], 0.01)
    both = device_trace.read(_Prof(_base_events() + _ranges()), kinds, [],
                             0.01)
    assert both.busy_s == plain.busy_s > 0
    assert both.kernel_s == plain.kernel_s
    assert not any(n.startswith("nightjar.") for n in both.kernel_s)
    assert both.kernels_by_step == plain.kernels_by_step == {7: 3, 8: 2}
    assert both.device_ops == plain.device_ops
    assert both.idle_gaps == plain.idle_gaps
    assert not any("nightjar." in label for label, _ in both.idle_gaps)
    # busy: [1.2, 2.0), [2.2, 2.3), [3.0, 3.2), [6.1, 6.3), [7.0, 7.05) ms;
    # idle by phase over the events' whole span, 1.0 to 9.53 ms, by hand
    assert both.busy_s == pytest.approx(1_350e-6, abs=1e-12)
    want_us = {"outside": 50 + 1_100 + 30, "step": 10 + 50 + 100,
               "engine.execute": 20 + 100,
               "backend.dispatch": 120 + 200 + 600 + 600 + 2_350,
               "backend.sync": 100 + 700, "engine.commit": 900,
               "engine.admit": 50 + 100}
    assert both.idle_by_phase == pytest.approx(
        {k: v / 1e6 for k, v in want_us.items()}, abs=1e-12)
    assert sum(both.idle_by_phase.values()) == pytest.approx(
        (9_530 - 1_000) / 1e6 - both.busy_s, abs=1e-12)
    # without ranges, all of the idle time lies outside any phase
    assert plain.idle_by_phase == pytest.approx(
        {"outside": (9_000 - 1_000) / 1e6 - plain.busy_s}, abs=1e-12)
