"""Carry reference weights into the port.

The reference's parameter tree (stacked layers, einsum layouts, a MoE
layer's ``moe`` tree, a VLM's ``image_proj``, an SSM layer's fp32
``A_log`` / ``D`` / ``dt_bias``) arrives as nested dicts of numpy arrays;
the port keeps the same names and layouts, so the bridge is a dtype cast,
never a reshape.  The one exception: the reference keeps a hybrid's layers
as a list (``scan_layers=False``), which the bridge stacks on a leading
axis as the port holds them.  The reference's AdamW state (step, m, v)
crosses the same way (``opt_state_from_numpy``), and ``params_to_numpy``
goes back.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .registry import param_specs


def params_from_numpy(cfg, tree, *, device="cuda", dtype=None):
    """Nested dicts of numpy arrays -> the port's parameter tree on
    ``device``, each leaf in its own dtype (the config's, or fp32 for the
    MoE router and the SSM's A_log / D / dt_bias), or every leaf in
    ``dtype`` when given.  A list of per-layer trees is stacked.  Raises on
    a missing, extra or misshapen leaf."""
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
        return t.to(device=dev, dtype=dtype or spec.dtype)

    return conv(param_specs(cfg), tree, "")


def opt_state_from_numpy(cfg, state, *, device="cuda",
                         m_dtype=torch.float32, v_dtype=torch.float32):
    """The reference's ``AdamWState`` (step, m, v) with numpy leaves -> the
    port's, on ``device``: m and v shaped like the parameters, in
    ``m_dtype`` / ``v_dtype``, the step a () int32 tensor."""
    from ..training.optimizer import AdamWState
    step, m, v = state
    dev = _device.resolve(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=params_from_numpy(cfg, m, device=dev, dtype=m_dtype),
        v=params_from_numpy(cfg, v, device=dev, dtype=v_dtype))


def params_to_numpy(tree):
    """The port's nested dicts of tensors -> nested dicts of float32 numpy
    arrays (exact for bfloat16 values; numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def _stack(trees):
    """A list of identically shaped trees -> one tree stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t, dtype=np.float32) for t in trees])
