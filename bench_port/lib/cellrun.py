"""One run of one cell, from the seed to the result's line.

In order: the configuration's weights made on the device from the seed;
the engine built at the deployment's sizes; the step shapes the traffic
starts with warmed up (a few requests of its own draw); in a traced run,
the program's phase spans recorded from here on; the traffic offered open
loop through the lead-in and the measured window, with the device's peak
memory counted over the window alone; the program's state freed; the
served tokens compared with the target's plain reference (its
architecture module's); the metrics read.
"""
from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from . import check, device_trace, model, serve, spec, stats, traffic


@dataclass
class Outcome:
    run: serve.Run
    correct: bool
    number: str             # the reading compared
    gap: float              # its value
    limit: float
    readings: dict          # every reading of the served tokens' gaps
    compared_tokens: int
    compared_requests: int
    memory_peak_bytes: int
    attempted: int
    failed: int
    control: Optional[dict] = None          # the control's readings
    control_correct: Optional[bool] = None  # the same decision on them


WARM_REQUESTS = 8       # requests of the traffic's own draw in the warm-up
WARM_TOKENS = 8         # tokens each of them is served
# the warm-up's ids come from this offset of the run's seed, a stream no
# run's own seed reaches
WARM_SEED_OFFSET = 2**40


class PeakWatch:
    """The device's peak allocation over the measured window: the count
    restarts when the window opens (the warm-up's and the lead-in's
    transients are not the window's) and is read when it closes."""

    def __init__(self, dev, open_s: float, close_s: float):
        self.dev, self.open_s, self.close_s = dev, open_s, close_s
        self.started = False
        self.peak: Optional[int] = None

    def on_step(self, loop, now: float) -> None:
        if self.dev.type != "cuda":
            return
        if not self.started and now >= self.open_s:
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.started = True
        if self.peak is None and now >= self.close_s:
            self.peak = int(torch.cuda.max_memory_allocated(self.dev))

    def read(self) -> int:
        if self.dev.type != "cuda":
            return 0
        if self.peak is None:
            self.peak = int(torch.cuda.max_memory_allocated(self.dev))
        return self.peak


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             root=spec.ROOT, fault=None, control: bool = False) -> Outcome:
    """Run ``cell`` once.  ``t_process`` is the process's start on
    ``time.time()``.  ``fault(engine)``, for tests, breaks the timed path
    before the traffic starts.  With ``control`` the control is put in the
    program's place on the same sample once the run is judged, and judged
    by the same decision (``control.py``; the benchmark's own runs never
    do)."""
    dev = torch.device(device)
    tarch, darch = model.archs(cell.config, root)
    tcfg, dcfg = model.pair(cell.config, root)
    dep = cell.config["deployment"]
    params = model.make_pair_weights(tcfg, dcfg, seed, dev)
    log = serve.CallLog() if trace else None
    engine = serve.build_engine(tcfg, dcfg, dep, params, device=device,
                                wrap=log.wrap if log else None)
    lead_in = float(cell.cell["lead_in_s"])
    shape = dict(rate=float(cell.cell["rate_per_s"]), lead_in_s=lead_in,
                 seconds=seconds, vocab=tcfg.vocab_size,
                 bench_dir=Path(root) / "bench_port")
    port_warm = serve.to_port_requests(traffic.warmup(
        cell.traffic, seed=int(seed) + WARM_SEED_OFFSET, count=WARM_REQUESTS,
        output_len=WARM_TOKENS, **shape))
    engine.run(port_warm, max_steps=100_000)
    if trace:
        device_trace.warm_profiler()
    if fault is not None:
        fault(engine)
    reqs = traffic.generate(cell.traffic, seed=seed, **shape)
    # request ids after the warm-up's, so no stream of the warm-up is
    # mistaken for one of the run's
    base = len(port_warm)
    for r in reqs:
        r.req_id += base
    if dev.type == "cuda":
        torch.cuda.synchronize()
    loop = serve.OpenLoop(engine, reqs)
    if trace and engine.trace is None:
        # the program's phase spans on the loop's clock, from the end of
        # the warm-up; a recorder a caller attached already is kept
        from repro_torch.serving.observability import TraceRecorder
        engine.attach_trace(TraceRecorder(clock=loop.now))
    tracer = (device_trace.Tracer(lead_in + device_trace.TRACE_OFFSET_S, log)
              if trace else None)
    watch = PeakWatch(dev, lead_in, lead_in + seconds)

    def on_step(lp, now):
        watch.on_step(lp, now)
        if tracer is not None:
            tracer.on_step(lp, now)

    t_traffic = time.time()
    end = loop.run(lead_in_s=lead_in, seconds=seconds, on_step=on_step)
    if tracer is not None:
        tracer.finish(loop)
    peak = watch.read()
    run = serve.Run(
        seconds=seconds, window_open=lead_in,
        window_close=lead_in + seconds, end=end,
        setup_s=t_traffic + lead_in - t_process, requests=loop.recs,
        steps=loop.steps, target_sizes=tarch.sizes(cell.config),
        trace=tracer.slice(loop) if tracer else None,
        lateness=loop.lateness, arch=tarch,
        archs={tcfg.name: tarch, dcfg.name: darch},
        spans=engine.trace if trace else None)
    streams = serve.served_streams(engine.backend, loop.recs)
    prompts = {r.req_id: r.prompt for r in reqs}
    # free the program's state before the reference runs: the weights are
    # the benchmark's own and stay
    del engine, loop, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ids = check.sample(streams, prompts, seed)
    rule = cell.config["correct"]
    sizes = run.target_sizes
    reads, n_tok = (check.served_readings(tarch, params[0], sizes, ids,
                                          streams, prompts)
                    if ids else ({}, 0))
    ctl = (check.control_readings(tarch, params[0], sizes, ids, streams,
                                  prompts)
           if control and ids else None)
    window = stats.window_requests(run)
    return Outcome(run=run, correct=check.decide(rule, reads, n_tok),
                   number=rule["number"],
                   gap=reads.get(rule["number"], float("inf")),
                   limit=float(rule["limit"]), readings=reads,
                   compared_tokens=n_tok,
                   compared_requests=len(ids), memory_peak_bytes=peak,
                   attempted=len(window),
                   failed=sum(1 for r in window if not r.token_times),
                   control=ctl,
                   control_correct=(None if ctl is None
                                    else check.decide(rule, ctl, n_tok)))


def _quartiles(xs):
    """Quartiles and 90th percentile in ms (inclusive method), or None."""
    if len(xs) < 2:
        return None
    q = statistics.quantiles(sorted(xs), n=20, method="inclusive")
    return [1e3 * q[i] for i in (4, 9, 14, 17)]


def _gap_quantiles(run):
    """``stats.token_gaps_s``'s p50, p90, p95, p99 in ms."""
    g = stats.token_gaps_s(run)
    if len(g) < 2:
        return None
    q = statistics.quantiles(sorted(g), n=100, method="inclusive")
    return [1e3 * q[i] for i in (49, 89, 94, 98)]


def summary(out: Outcome) -> dict:
    """What the run saw beyond its metrics, for the line before the
    result: counts, the generator's lateness and the tails (which above
    the knee are recorded, not judged)."""
    run = out.run
    ttft, tpot = stats.p95(stats.ttft_s(run)), stats.p95(stats.tpot_s(run))
    late = sorted(run.lateness)
    return {
        "requests_due_in_window": out.attempted,
        "without_first_token": out.failed,
        "served_in_full": sum(1 for r in run.requests.values()
                              if len(r.token_times) >= r.output_len),
        "steps": len(run.steps),
        "window_steps": len(stats.window_steps(run)),
        "queue_at_close": next((s.waiting for s in reversed(run.steps)
                                if s.t_end < run.window_close), None),
        "queue_at_open": next((s.waiting for s in run.steps
                               if s.t_end >= run.window_open), None),
        "ttft_p95_ms": None if ttft is None else 1e3 * ttft,
        "tpot_p95_ms": None if tpot is None else 1e3 * tpot,
        "ttft_ms_quartiles": _quartiles(stats.ttft_s(run)),
        "tpot_ms_quartiles": _quartiles(stats.tpot_s(run)),
        "tpot_samples": len(stats.tpot_s(run)),
        "token_gap_ms_p50_p90_p95_p99": _gap_quantiles(run),
        "generator_late_p95_ms": 1e3 * (stats.p95(late) or 0.0),
        "generator_late_max_ms": 1e3 * (late[-1] if late else 0.0),
        "compared_requests": out.compared_requests,
        "compared_tokens": out.compared_tokens,
        "readings": out.readings,
        "run_end_s": run.end,
    }


def result(cell: spec.Cell, out: Outcome, *, trace: bool, kind: str,
           root=spec.ROOT, power_limit: Optional[str] = None) -> dict:
    """The result's line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and ``breakdown`` when traced), then the
    numbers compared beside their limits, last."""
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                out.run, root)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if power_limit:
        device["power_limit"] = power_limit
    res = {"correct": out.correct, "attempted": out.attempted,
           "failed": out.failed, "metrics": metrics, "device": device}
    tr = out.run.trace
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.wall_s
        res["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    res["checks"] = {out.number: {"value": out.gap, "limit": out.limit}}
    return res
