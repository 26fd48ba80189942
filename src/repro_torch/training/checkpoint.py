"""Checkpointing: atomic, restart-safe save / restore of the training state,
in the reference's on-disk layout.

Layout: <dir>/step_<N>/
           arrays.npz      — flattened leaves ``leaf_<i>``
           manifest.json   — meta + leaf count + dtype strings
        <dir>/LATEST        — committed pointer (atomic rename)

The leaves of ``{"params": params, "opt": AdamWState}`` are flattened in
the order ``jax.tree.flatten`` gives the reference's trees (dict keys
sorted, so ``opt``'s step, m and v come before ``params``); bfloat16 is
stored as uint16 under the dtype string "bfloat16".  A checkpoint written by
either package therefore restores in the other.  The commit protocol
(write everything, then move the LATEST pointer atomically) means a crash
mid-write never corrupts the last valid checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import device as _device

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.int32: "int32"}


def flatten(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, a NamedTuple
    (``AdamWState``) or tuple in field order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(template, leaves):
    """``leaves`` (an iterator) poured into ``template``'s structure."""
    if isinstance(template, dict):
        out = {k: unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple):
        return type(template)(*(unflatten(v, leaves) for v in template))
    return next(leaves)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise ValueError(f"checkpoint: dtype {t.dtype} not supported "
                         f"({sorted(_DTYPE_NAMES.values())})")
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:   # npz cannot hold bfloat16: its bits
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if name not in ("float32", "int32"):
        raise ValueError(f"checkpoint: dtype {name!r} not supported")
    return torch.from_numpy(np.array(a, dtype=name))


def save(directory: str, params, opt, meta: dict) -> str:
    """Write ``step_<meta["step"]>`` and then point LATEST at it."""
    os.makedirs(directory, exist_ok=True)
    step = meta.get("step", 0)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = flatten({"params": params, "opt": opt})
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        a, name = _to_numpy(x)
        arrays[f"leaf_{i}"] = a
        dtypes.append(name)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"meta": meta, "num_leaves": len(leaves),
                   "dtypes": dtypes}, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # atomic pointer commit
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step}")
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def restore_latest(directory: str, *, template: Any, device=None
                   ) -> Optional[Tuple[Any, Any, dict]]:
    """(params, opt, meta) of the checkpoint LATEST points at, or None when
    there is none.  ``template`` is ``{"params": ..., "opt": AdamWState}``
    of tensors (meta tensors will do): it gives the structure, and every
    leaf's shape and dtype are checked against it.  Leaves go to ``device``,
    or to their template leaf's device when that is not ``meta``."""
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.isdir(path):
        return None
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if device is not None:
        device = _device.resolve(device)
    want = flatten(template)
    if manifest["num_leaves"] != len(want):
        raise ValueError(f"checkpoint {path}: {manifest['num_leaves']} "
                         f"leaves, the template has {len(want)}")
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves = []
    for i, w in enumerate(want):
        t = _from_numpy(data[f"leaf_{i}"], manifest["dtypes"][i])
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(f"checkpoint {path}: leaf {i} is "
                             f"{tuple(t.shape)} {t.dtype}, the template's "
                             f"{tuple(w.shape)} {w.dtype}")
        dev = device if device is not None else (
            "cpu" if w.device.type == "meta" else w.device)
        leaves.append(t.to(dev))
    state = unflatten(template, iter(leaves))
    return state["params"], state["opt"], manifest["meta"]
