"""A new architecture joins the benchmark by added files and entries alone.

In a copy of the benchmark at tiny widths, the test adds an architecture
module (``archs/toy.py``: the ``gqa`` layout with granite's logits
scaling, which divides the logits and leaves every greedy token as it is,
so its reference and its counts differ from ``gqa``'s), a configuration
that names it, a cell, and a metric that reads the run's spans and its
architecture module.  It drives them through ``spec.find_cell``,
``model.pair``, ``check.served_readings`` and ``spec.read_metrics`` in a
traced run of the CPU engine (the profiler, which needs a card, replaced
by a slice of the call log), sees the toy's reference and counts used, and
finds no file of the copy changed."""
import dataclasses
import hashlib
import json
import time

import pytest

from conftest import tiny_root
from bench_port.lib import cellrun, check, device_trace, model, spec, stats

SEED = 2**31 + 424242
CELL = "toy-chat-steady"

TOY = '''"""toy: the gqa layout with granite's logits scaling: the logits
divided by ``logits_scaling``, which the port does not do and which leaves
every greedy token as it is; a token's flops add the division, one per
vocabulary entry; the attention need comes in two groups of layers, timed
against ``gqa``'s kernels and ``toy_attention_kernel``."""
from pathlib import Path

from bench_port.lib import spec

GQA = spec.load_arch("gqa", Path(__file__).resolve().parents[2])
ATTENTION_KERNELS = GQA.ATTENTION_KERNELS + ("toy_attention_kernel",)


def _gqa_group(group):
    return {k: v for k, v in group.items() if k != "logits_scaling"}


def sizes(group):
    return dict(GQA.sizes(_gqa_group(group)),
                logits_scaling=float(group.get("logits_scaling", 1.0)))


def port_config(name, group, port):
    return GQA.port_config(name, _gqa_group(group), port)


def logits(params, sizes, sequences, score_from, *, precision="fp32"):
    return [lg / sizes["logits_scaling"] for lg in GQA.logits(
        params, sizes, sequences, score_from, precision=precision)]


def token_flops(sizes, ctx):
    return GQA.token_flops(sizes, ctx) + sizes["vocab"]


def attention_need(cfg, rows, elem_bytes):
    [(n, f, b)] = GQA.attention_need(cfg, rows, elem_bytes)
    return [(1, f, b), (n - 1, f, b)]
'''

METRIC = '''"""toy_step_flops: the window's step spans times one token's
flops at context 1, as the target's architecture module counts them."""
from bench_port.lib import stats


def read(run):
    if run.spans is None:
        return None
    steps = sum(1 for e in run.spans.events if e.get("name") == "step"
                and stats.in_window(run, e["t"]))
    return float(steps * run.arch.token_flops(run.target_sizes, 1))
'''


def snapshot(root):
    files = [root / "BENCHMARK.json"] + sorted(
        p for p in (root / "bench_port").rglob("*") if p.is_file()
        and "__pycache__" not in p.parts)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in files}


def add_toy(root):
    """The toy's files and entries; returns the BENCHMARK.json before."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    before = json.loads(json.dumps(b))
    bp = root / "bench_port"
    (bp / "archs/toy.py").write_text(TOY)
    (bp / "metrics/toy_step_flops.py").write_text(METRIC)
    cfg = json.loads((bp / "configs/paper-7b.json").read_text())
    cfg.update(name="toy-7b", logits_scaling=2.0)
    cfg["port"]["arch"] = "toy"
    (bp / "configs/toy-7b.json").write_text(json.dumps(cfg))
    (bp / f"cells/{CELL}.json").write_text(
        json.dumps({"rate_per_s": 20.0, "lead_in_s": 0.5}))
    b["configs"].append({"name": "toy-7b", "source": "a test",
                         "file": "bench_port/configs/toy-7b.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": CELL, "config": "toy-7b",
                           "traffic": "chat", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    b["per_layer"].append({"name": "toy_step_flops", "unit": "flops",
                           "better": "lower", "source": "program_span",
                           "layer": "engine / planner",
                           "moves": "output_tok_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return before


class CallLogSlice:
    """Stands in for ``device_trace.Tracer`` on the CPU: it records every
    paged call of the traffic and hands them to a slice whose device time
    lies in ``toy_attention_kernel`` alone."""

    def __init__(self, start_at, call_log):
        self.log = call_log
        call_log.on = True

    def on_step(self, loop, now):
        pass

    def finish(self, loop):
        self.log.on = False

    def slice(self, loop):
        return device_trace.Slice(
            wall_s=1.0, busy_s=0.25, calls=self.log.rows(),
            kernel_s={"toy_attention_kernel": 1e-3},
            idle_by_phase={"backend.dispatch": 0.5, "outside": 0.25})


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("bench_port_toy"))
    files = snapshot(root)
    return root, files, add_toy(root)


@pytest.fixture(scope="module")
def traced(toy):
    root = toy[0]
    gqa = spec.load_arch("gqa", root)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_trace, "Tracer", CallLogSlice)
        mp.setattr(device_trace, "warm_profiler", lambda: None)
        served = check.served_readings
        mp.setattr(check, "served_readings",
                   lambda arch, *a: seen.append((arch, a)) or served(arch,
                                                                     *a))
        cell = spec.find_cell(CELL, root)
        out = cellrun.run_cell(cell, seed=SEED, seconds=1.5, trace=True,
                               t_process=time.time(), device="cpu",
                               root=root, control=True)
    return root, cell, out, seen, gqa


def test_the_configuration_names_its_architecture(toy):
    root = toy[0]
    cell = spec.find_cell(CELL, root)
    tarch, darch = model.archs(cell.config, root)
    assert (tarch.__name__, darch.__name__) == ("bench_port_arch_toy",
                                                "bench_port_arch_gqa")
    assert tarch.sizes(cell.config)["logits_scaling"] == 2.0
    # the port serves the gqa model: the toy's port config is gqa's
    t, d = model.pair(cell.config, root)
    plain = model.pair(spec.find_cell("paper7b-chat-steady", root).config,
                       root)
    assert (t, d) == (dataclasses.replace(plain[0], name="toy-7b"),
                      dataclasses.replace(plain[1], name="toy-7b-draft"))


def test_the_toys_reference_decides_correct(traced):
    _, _, out, seen, gqa = traced
    assert out.correct and out.failed == 0 and out.compared_tokens > 50
    [(arch, args)] = seen
    assert arch.__name__ == "bench_port_arch_toy"
    plain, n = check.served_readings(gqa, *args)
    assert n == out.compared_tokens
    # logits halved: every gap halves exactly, the greedy tokens hold; the
    # served tokens' gaps may all be 0, the float8 control's are not
    control = check.control_readings(gqa, *args)
    assert control["max_logit_gap"] > 0 and out.control_correct is False
    for k in ("max_logit_gap", "mean_logit_gap"):
        assert out.readings[k] == plain[k] / 2
        assert out.control[k] == control[k] / 2
    assert out.control["mismatch_share"] == control["mismatch_share"]


def test_the_traced_run_carries_spans_and_architecture(traced):
    root, cell, out, _, gqa = traced
    run = out.run
    assert run.arch.__name__ == "bench_port_arch_toy"
    assert {n: a.__name__ for n, a in run.archs.items()} == {
        "toy-7b": "bench_port_arch_toy",
        "toy-7b-draft": "bench_port_arch_gqa"}
    # attached after the warm-up, on the loop's clock
    steps = [e for e in run.spans.events if e.get("name") == "step"]
    assert steps and min(e["t"] for e in run.spans.events) >= 0.0
    got = spec.read_metrics(cell.per_layer, run, root)
    n = sum(1 for e in steps if stats.in_window(run, e["t"]))
    assert got["toy_step_flops"]["value"] == n * (
        gqa.token_flops(run.target_sizes, 1) + run.target_sizes["vocab"])
    # step_mfu counts with the toy's token flops
    with_gqa = dataclasses.replace(run, arch=gqa)
    assert stats.useful_flops(run) > stats.useful_flops(with_gqa) > 0
    # the roofline's time lies in the toy's kernel alone, its need in its
    # two groups of layers
    need = 0.0
    for cfg, rows in run.trace.calls:
        [(layers, f, b)] = gqa.attention_need(cfg, rows, 4)
        need += layers * max(f / 989e12, b / 3.35e12)
    assert run.trace.calls
    roofline = spec.load_reader("paged_attn_roofline", root)
    assert roofline(run) == pytest.approx(100.0 * need / 1e-3, rel=1e-12)
    gqa_only = dataclasses.replace(run, archs={k: gqa for k in run.archs})
    assert roofline(gqa_only) is None
    e2e = spec.read_metrics(cell.end_to_end, run, root)
    assert {"output_tok_s", "ttft_p95_ms", "itl_p99_ms", "setup_s"} \
        <= set(e2e)


def test_no_file_that_was_there_changed(toy, traced):
    root, files, before = toy
    now = snapshot(root)
    changed = [p for p, h in files.items() if now.get(p) != h]
    assert changed == ["BENCHMARK.json"]
    # BENCHMARK.json gained entries and the new cell's name in the lists
    # of the end-to-end metrics it reports, and nothing else
    b = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert b[key][:len(before[key])] == before[key]
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].remove(CELL)
    assert b["end_to_end"] == before["end_to_end"]
    assert {k: v for k, v in b.items() if not isinstance(v, list)} == \
        {k: v for k, v in before.items() if not isinstance(v, list)}
    assert sorted(set(now) - set(files)) == sorted([
        "bench_port/archs/toy.py", "bench_port/metrics/toy_step_flops.py",
        "bench_port/configs/toy-7b.json", f"bench_port/cells/{CELL}.json"])
