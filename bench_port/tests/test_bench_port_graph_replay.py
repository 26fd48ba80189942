"""``graph_replay_share.decode`` on the synthetic run of the span metrics'
tests: the share of the pure-decode steps' model calls whose dispatch
replayed a step graph; nothing to read where no dispatch says how it
ran."""
import pytest

from conftest import ROOT
from bench_port.lib import spec
from test_bench_port_spans import synthetic_run

NAME = "graph_replay_share.decode"


def _dispatches(run):
    return [e for e in run.spans.events if e.get("name") == "backend.dispatch"]


def _labelled(modes):
    """The synthetic run with its dispatch spans' ``graph`` args set in
    order from ``modes``."""
    run = synthetic_run()
    spans = _dispatches(run)
    assert len(spans) == len(modes)
    for e, m in zip(spans, modes):
        e["args"]["graph"] = m
    return run


# the synthetic run's dispatches in order: decode (before the window),
# spec, mixed target + draft, catch-up draft, decode, decode, mixed
# target + draft, spec, decode, decode (after the window)
ORDER = ["decode", "spec", "mixed", "mixed", "catchup", "decode", "decode",
         "mixed", "mixed", "spec", "decode", "decode"]


@pytest.mark.parametrize("modes,want", [
    # the window's five pure-decode model calls: every one replayed
    ({"decode": "replay", "spec": "replay"}, 100.0),
    # the first spec step captured: 4 of 5
    ({"decode": "replay", "spec": ["capture", "replay"]}, 80.0),
    # nothing replayed yet
    ({"decode": "eager", "spec": "capture"}, 0.0),
])
def test_the_share_counts_the_pure_decode_steps_model_calls(modes, want):
    labels, seen = [], {}
    for kind in ORDER:
        m = modes.get(kind, "eager")
        if isinstance(m, list):
            m = m[min(seen.get(kind, 0), len(m) - 1)]
        seen[kind] = seen.get(kind, 0) + 1
        labels.append(m)
    run = _labelled(labels)
    assert spec.load_reader(NAME, ROOT)(run) == want
    # a catch-up or a mixed step that replayed would not count: they run
    # packed calls, which stay eager
    run = _labelled([("replay" if k in ("catchup", "mixed") else m)
                     for k, m in zip(ORDER, labels)])
    assert spec.load_reader(NAME, ROOT)(run) == want


def test_a_program_without_step_graphs_reads_nothing():
    read = spec.load_reader(NAME, ROOT)
    assert read(synthetic_run()) is None
    run = synthetic_run()
    run.spans = None
    assert read(run) is None


def test_the_metric_is_the_benchmarks():
    bench = spec.load_benchmark(ROOT)
    m = {x["name"]: x for x in bench["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_counter",
                 "layer": "backend / model step", "moves": "itl_p99_ms",
                 "workloads": [w["name"] for w in bench["workloads"]]}
