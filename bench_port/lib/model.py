"""A configuration file read into its models' architecture modules, the
port's ``ModelConfig`` pair, and seeded weights in the port's parameter
layout.

A configuration file holds the target's published ``config.json`` keys at
its top level, the draft's in ``draft``, the serving deployment in
``deployment`` and what the port needs besides the published keys
(family, q/k/v bias, the MoE capacity factor) in ``port``.  Every value is
the one that runs.  Each model's layout is an architecture module,
``archs/<arch>.py``, named by ``port.arch`` (the target) and
``port.draft.arch`` (the draft); a file that names none gets ``gqa``.
The module reads the model's sizes, builds its ``ModelConfig``, and holds
its plain reference and its counts.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import spec

DEFAULT_ARCH = "gqa"


def archs(config: dict, root=spec.ROOT):
    """(target, draft) architecture modules of a configuration file."""
    port = config["port"]
    return (spec.load_arch(port.get("arch", DEFAULT_ARCH), root),
            spec.load_arch(port["draft"].get("arch", DEFAULT_ARCH), root))


def pair(config: dict, root=spec.ROOT):
    """(target, draft) ``ModelConfig`` of a configuration file."""
    tarch, darch = archs(config, root)
    return (tarch.port_config(config["name"], config,
                              config["port"]["target"]),
            darch.port_config(config["name"] + "-draft", config["draft"],
                              config["port"]["draft"]))


def make_weights(cfg, gen: torch.Generator, device) -> dict:
    """Seeded weights in the port's parameter layout
    (``registry.param_layout``), made on ``device`` in the type they are
    served in, one draw per stacked leaf: dense weights N(0, 1/fan_in),
    embeddings N(0, 0.02^2), norm scales 1 + N(0, 0.05^2) and biases
    N(0, 0.02^2) (neither left at its identity, so the comparison sees
    them), the fp32 router like a dense weight."""
    from repro_torch.models.registry import param_layout
    from repro_torch.models.common import Spec, leaf_dtype

    def make(s: Spec):
        t = torch.randn(s.shape, generator=gen, device=device,
                        dtype=leaf_dtype(cfg, s))
        if s.init == "dense":
            return t.mul_(max(s.fan_in, 1) ** -0.5)
        if s.init == "embed":
            return t.mul_(0.02)
        if s.init == "ones":
            return t.mul_(0.05).add_(1.0)
        if s.init == "zeros":
            return t.mul_(0.02)
        raise ValueError(f"{cfg.name}: no seeded init for {s.init!r}")

    def walk(layout):
        if isinstance(layout, dict):
            return {k: walk(v) for k, v in layout.items()}
        return make(layout)

    return walk(param_layout(cfg))


def make_pair_weights(tcfg, dcfg, seed: int, device) -> Tuple[dict, dict]:
    """Target and draft weights from one generator seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return make_weights(tcfg, gen, device), make_weights(dcfg, gen, device)
