"""Carry reference weights into the port.

The reference's parameter tree (stacked layers, einsum layouts) arrives as
nested dicts of numpy arrays; the port keeps the same names and layouts, so
the bridge is a rename and dtype cast, never a reshape.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .transformer import param_specs


def params_from_numpy(cfg, tree, *, device="cuda"):
    """Nested dicts of numpy arrays -> the port's parameter tree on
    ``device``, in the config's dtype.  Raises on a missing, extra or
    misshapen leaf."""
    dev = _device.resolve(device)

    def conv(spec, node, path):
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
