"""Every paged decoder call of a traced slice with its real rows, replayed
step graphs' included, and a kernel's roofline share over them.

The call log (``serve.CallLog``) wraps each model's ``decode_step_paged``
in Python: it sees each call the program makes eagerly, and each call it
records into a step graph at a capture, but no replay of a graph.  A
program that replays graphs lists each real row's context on the
``backend.pack`` span of a pure-decode or spec step (``starts``), and the
step's ``backend.dispatch`` says ``graph`` = ``replay``.  A replayed step
of gamma 0 ran the target once on rows (start, 1); one of gamma > 0 ran
the draft gamma + 1 times, the i-th on rows (start + i, 1), then the
target once on rows (start, gamma + 1).  A program without graphs
replays nothing, and the call log holds every call.
"""
from __future__ import annotations

import json
from typing import Callable, List, Optional, Tuple

import torch

from . import flops, model, spans, spec


def _configs(run, calls) -> dict:
    """The served models' ``ModelConfig`` by name: the call log's, and
    where it holds none of a model, the configuration file's whose
    ``name`` the run's models carry."""
    cfgs = {cfg.name: cfg for cfg, _ in calls}
    if set(run.archs) <= set(cfgs):
        return cfgs
    for entry in spec.load_benchmark()["configs"]:
        config = json.loads((spec.ROOT / entry["file"]).read_text())
        if config["name"] in run.archs:
            for cfg in model.pair(config):
                cfgs.setdefault(cfg.name, cfg)
    return cfgs


def every_call(run) -> Optional[List[tuple]]:
    """(cfg, [(start, n) of each real row]) of every paged decoder call
    of the traced slice; None where there is no slice or no spans."""
    sp = spans.of(run)
    if sp is None:
        return None
    calls = list(run.trace.calls)
    traced = set(run.trace.kernels_by_step)
    target = draft = None
    for e, _ in sp.steps(run, lambda rec: rec.index in traced):
        for x in sp.under(e["id"], "engine.execute"):
            if not any(d["args"].get("graph") == "replay"
                       for d in sp.under(x["id"], "backend.dispatch")):
                continue
            for p in sp.under(x["id"], "backend.pack"):
                starts = p["args"].get("starts")
                if not starts:
                    continue
                if target is None:
                    cfgs = _configs(run, calls)
                    target, draft = (next(c for n, c in cfgs.items()
                                          if n + "-draft" in cfgs),
                                     next(c for n, c in cfgs.items()
                                          if n.endswith("-draft")))
                gamma = p["args"]["positions_valid"] // len(starts) - 1
                if gamma:
                    calls += [(draft, [(s + i, 1) for s in starts])
                              for i in range(gamma + 1)]
                calls.append((target, [(s, gamma + 1) for s in starts]))
    return calls


def roofline(run, need: Callable[[object, object, List[Tuple[int, int]],
                                  int], Optional[Tuple[float, tuple]]]
             ) -> Optional[float]:
    """100 x the least time of every call of the slice over the device
    time of the kernels that do it.  ``need(arch, cfg, rows, elem_bytes)``
    gives a call's least seconds and the names of its kernels, or None
    for a call the share leaves out.  None where the slice holds no time
    in those kernels."""
    calls = every_call(run)
    if calls is None:
        return None
    least, kernels = 0.0, set()
    for cfg, rows in calls:
        elem = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        got = need(run.arch_of(cfg), cfg, rows, elem)
        if got is not None:
            least += got[0]
            kernels.update(got[1])
    spent = sum(s for name, s in run.trace.kernel_s.items()
                if any(k in name for k in kernels))
    if spent <= 0:
        return None
    return 100.0 * least / spent


def least_time(groups) -> float:
    """Σ layers x least time over (layers, flops, bytes) groups."""
    return sum(n * flops.least_time(f, b) for n, f, b in groups)
