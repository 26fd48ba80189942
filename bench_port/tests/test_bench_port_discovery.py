"""BENCHMARK.json against the contract's shape, and the harness finding a
cell's configuration, traffic, cell file and metric readers by name alone,
including ones a test adds as files."""
import json
import re
import shutil

import pytest

from conftest import ROOT, tiny_root
from bench_port.lib import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_are_the_contracts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_readers(w):
    cell = spec.find_cell(w)
    assert cell.config["name"] == cell.config_name
    assert cell.cell["rate_per_s"] > 0 and cell.cell["lead_in_s"] >= 0
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_reader(m["name"]))


def test_moves_name_an_end_to_end_metric_the_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
            assert spec.applies(target, w), (m["name"], w)


def test_the_port_config_matches_the_ports_own(tmp_path):
    from repro_torch import configs
    from bench_port.lib import model
    cfg = json.loads((ROOT / "bench_port/configs/paper-7b.json").read_text())
    t, d = model.pair(cfg)
    assert t.replace(max_position_embeddings=0) == configs.get_config(
        "paper-7b").replace(max_position_embeddings=0)
    assert d.replace(rope_theta=0) == configs.get_draft_config(
        "paper-7b").replace(rope_theta=0)
    g = json.loads((ROOT / "bench_port/configs/granite-moe-1b-a400m.json")
                   .read_text())
    t, d = model.pair(g)
    assert t == configs.get_config("granite-moe-1b-a400m")
    assert d == configs.get_draft_config("granite-moe-1b-a400m")


def test_a_metric_traffic_and_cell_added_as_files(tmp_path):
    root = tiny_root(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench_port/metrics/answer_count.py").write_text(
        "def read(run):\n    return 42.0\n")
    b["per_layer"].append({"name": "answer_count", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine / planner",
                           "moves": "output_tok_s",
                           "workloads": ["paper7b-chat-burst"]})
    shutil.copy(root / "bench_port/traffic/chat.json",
                root / "bench_port/traffic/chat-burst.json")
    (root / "bench_port/cells/paper7b-chat-burst.json").write_text(
        json.dumps({"rate_per_s": 5.0, "lead_in_s": 1.0}))
    b["workloads"].append({"name": "paper7b-chat-burst",
                           "config": "paper-7b", "traffic": "chat-burst",
                           "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.find_cell("paper7b-chat-burst", root)
    assert cell.traffic_name == "chat-burst"
    assert cell.cell["rate_per_s"] == 5.0
    assert [m["name"] for m in cell.per_layer][-1] == "answer_count"
    got = spec.read_metrics([m for m in cell.per_layer
                             if m["name"] == "answer_count"], None, root)
    assert got == {"answer_count": {"value": 42.0, "unit": "1"}}
    # the new metric is not read in the cells it does not list
    assert "answer_count" not in [
        m["name"] for m in spec.find_cell("paper7b-chat-steady",
                                          root).per_layer]


def test_a_generator_added_as_a_file(tmp_path):
    """A traffic file names its generator; a new one is a file under
    ``generators/`` found by that name."""
    from bench_port.lib import traffic
    root = tiny_root(tmp_path)
    (root / "bench_port/generators/burst.py").write_text(
        "import numpy as np\n"
        "from bench_port.lib.traffic import TrafficRequest\n"
        "def generate(traffic, *, rate, lead_in_s, seconds, seed, vocab):\n"
        "    n = traffic['size']\n"
        "    return [TrafficRequest(i, lead_in_s, np.zeros(n, np.int64), n,"
        " True) for i in range(int(rate * seconds))]\n")
    mix = {"generator": "burst", "size": 5}
    reqs = traffic.generate(mix, rate=2.0, lead_in_s=1.0, seconds=3.0,
                            seed=1, vocab=10, bench_dir=root / "bench_port")
    assert [(r.req_id, r.arrival, len(r.prompt)) for r in reqs] == \
        [(i, 1.0, 5) for i in range(6)]
    with pytest.raises(FileNotFoundError):
        traffic.generate({"generator": "nowhere"}, rate=1.0, lead_in_s=0.0,
                         seconds=1.0, seed=1, vocab=10,
                         bench_dir=root / "bench_port")


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell")
