"""A traffic mix's requests, from its file's parameters.

A traffic file (``traffic/<name>.json``) names its generator
(``"generator"``), a module ``generators/<generator>.py`` found by that
name, as metric readers are, whose ``generate(traffic, *, rate, lead_in_s,
seconds, seed, vocab)`` returns the run's :class:`TrafficRequest` list by
arrival.  ``generators/openloop.py`` is the general one: a new mix of
open-loop arrivals, lengths, rate phases, shared prefixes or sessions is a
data file for it.

The lengths and gaps are a frozen copy of the port's ``sharegpt`` draw
(``repro_torch.serving.workload.poisson_requests`` with
``DATASETS["sharegpt"]``: exponential gaps, then lognormal prompt and
output lengths clipped to their ranges, all from one
``numpy.random.default_rng``), so the benchmark keeps its yardstick when
the program's generator changes.
"""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class TrafficRequest:
    req_id: int
    arrival: float          # seconds after the traffic starts
    prompt: np.ndarray      # int64 token ids
    output_len: int
    in_window: bool         # due inside the measured window


def lengths(rng, mu: float, sigma: float, n: int, lo: int, hi: int
            ) -> np.ndarray:
    """The port's ``workload._lengths``."""
    x = rng.lognormal(mu, sigma, size=n)
    return np.clip(x, lo, hi).astype(int)


def draw(traffic: dict, rate: float, n: int, seed
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(gaps, prompt lengths, output lengths) of ``n`` requests at ``rate``
    per second, in the order and from the generator state that
    ``poisson_requests(rate, n, dataset="sharegpt", seed=seed)`` uses."""
    p, o = traffic["prompt"], traffic["output"]
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    prompts = lengths(rng, p["mu"], p["sigma"], n, p["min"], p["max"])
    outputs = lengths(rng, o["mu"], o["sigma"], n, o["min"], o["max"])
    return gaps, prompts, outputs


def load_generator(name: str, bench_dir: Path = BENCH_DIR):
    """``generators/<name>.py``'s ``generate``, loaded by path."""
    path = Path(bench_dir) / "generators" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_generator_{name.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate


def generate(traffic: dict, *, rate: float, lead_in_s: float,
             seconds: float, seed: int, vocab: int,
             bench_dir: Path = BENCH_DIR) -> List[TrafficRequest]:
    """The run's requests, by arrival, from the generator the traffic file
    names."""
    return load_generator(traffic["generator"], bench_dir)(
        traffic, rate=rate, lead_in_s=lead_in_s, seconds=seconds, seed=seed,
        vocab=vocab)


def warmup(traffic: dict, *, rate: float, lead_in_s: float, seconds: float,
           seed: int, vocab: int, count: int, output_len: int,
           bench_dir: Path = BENCH_DIR) -> List[TrafficRequest]:
    """The set-up's requests: the first ``count`` of the generator's own
    draw for the run (the same lengths and sharing, ids from another seed
    stream), all due at once, each stopped after ``output_len`` tokens.
    They reach the chunk, decode and verify shapes the traffic starts
    with; the lead-in that follows runs the rest at the traffic's own
    arrivals."""
    reqs = generate(traffic, rate=rate, lead_in_s=lead_in_s, seconds=seconds,
                    seed=seed, vocab=vocab, bench_dir=bench_dir)[:count]
    return [TrafficRequest(i, 0.0, r.prompt, min(r.output_len, output_len),
                           False) for i, r in enumerate(reqs)]
