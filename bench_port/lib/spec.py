"""Where the harness finds a cell's parts.

``BENCHMARK.json`` at the root of the checkout names every configuration,
cell and metric.  Each part has a file of its own under ``bench_port/``,
found by that name alone, so a later change adds a cell by adding files
and entries and edits nothing that is there:

* ``configs/<config>.json`` — the configuration as it is run (the entry's
  ``file``);
* ``traffic/<traffic>.json`` — a traffic mix's parameters, read by the
  generator it names, ``generators/<generator>.py`` (``lib/traffic.py``);
* ``cells/<workload>.json`` — a cell's offered rate and lead-in, set once
  from the knee sweep;
* ``metrics/<metric>.py`` — one reader per metric: ``read(run)`` returns
  the number, or None where the run has nothing to read;
* ``archs/<arch>.py`` — one module per model layout, named by a
  configuration file (``lib/model.py``): its sizes, its ``ModelConfig``,
  its plain reference and its counts (``README.md`` states the contract).
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    chips: int
    config_name: str
    config: dict           # the configuration file
    traffic_name: str
    traffic: dict          # the traffic file
    cell: dict             # the cell file (rate, lead-in)
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    run_seconds: int


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read_json(Path(root) / "BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    """A metric without ``workloads`` is reported in every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; KeyError if none."""
    root = Path(root)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(work)})")
    w = work[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    entry = cfgs[w["config"]]
    bench_dir = root / "bench_port"
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_read_json(root / entry["file"]),
        traffic_name=w["traffic"],
        traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        cell=_read_json(bench_dir / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        run_seconds=int(bench["run_seconds"]))


def _load(path: Path, name: str):
    """The module of the file ``path``, loaded by path: a name may hold
    dots (``decode_step_ms.steady``), and a file a later change adds needs
    no package entry."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = ROOT
                ) -> Callable[[object], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``."""
    return _load(Path(root) / "bench_port" / "metrics" / f"{metric}.py",
                 f"bench_port_metric_{metric}").read


def load_arch(name: str, root: Path = ROOT):
    """The architecture module ``archs/<name>.py``."""
    return _load(Path(root) / "bench_port" / "archs" / f"{name}.py",
                 f"bench_port_arch_{name}")


def read_metrics(metrics: List[dict], run, root: Path = ROOT
                 ) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read; the others are left out."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
