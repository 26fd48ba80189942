"""Carry reference weights into the port.

The reference's parameter tree (stacked layers, einsum layouts, a MoE
layer's ``moe`` tree, a VLM's ``image_proj``, an SSM layer's fp32
``A_log`` / ``D`` / ``dt_bias``) arrives as nested dicts of numpy arrays;
the port keeps the same names and layouts, so the bridge is a dtype cast,
never a reshape.  The one exception: the reference keeps a hybrid's layers
as a list (``scan_layers=False``), which the bridge stacks on a leading
axis as the port holds them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .registry import param_specs


def params_from_numpy(cfg, tree, *, device="cuda"):
    """Nested dicts of numpy arrays -> the port's parameter tree on
    ``device``, each leaf in its own dtype (the config's, or fp32 for the
    MoE router and the SSM's A_log / D / dt_bias).  A list of per-layer
    trees is stacked.  Raises on a missing, extra or misshapen leaf."""
    dev = _device.resolve(device)

    def conv(spec, node, path):
        if isinstance(node, (list, tuple)) and node:
            node = _stack(node)
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"params{path}: keys {got} != "
                                 f"{sorted(spec)}")
            return {k: conv(spec[k], node[k], f"{path}[{k!r}]")
                    for k in spec}
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"params{path}: shape {arr.shape} != "
                             f"{tuple(spec.shape)}")
        # numpy has no bfloat16: go through float32, exact for bf16 values
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=dev, dtype=spec.dtype)

    return conv(param_specs(cfg), tree, "")


def _stack(trees):
    """A list of identically shaped trees -> one tree stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t, dtype=np.float32) for t in trees])
