"""Train step factory and the fault-tolerant training loop.

``make_train_step(cfg)`` builds ``(params, opt, batch) -> (metrics, params,
opt)``: the loss and its gradients by ``torch.autograd.grad`` over the
parameter leaves (which require grad), then the AdamW update under
``torch.no_grad``, which writes the parameters and moments in place.  On
the card every layer's attention runs the CUDA flash kernel forward and
its hand-written backward (``kernels/flash_attention.py``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from .. import device as _device
from ..models.common import leaves
from ..models.registry import get_model, param_specs
from .optimizer import (AdamWState, adamw_init, adamw_update,
                        cosine_schedule, tree_map)


def loss_and_grads(api, params, batch):
    """(loss, grads): ``api.loss`` and its gradients with respect to every
    parameter leaf (each requires grad), as a tree shaped like
    ``params``."""
    loss, _ = api.loss(params, batch)
    it = iter(torch.autograd.grad(loss, list(leaves(params))))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg, *, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, accum: int = 1,
                    accum_dtype=torch.float32):
    """-> (api, train_step).  With ``accum`` > 1 the batch's leaves carry a
    leading microbatch axis of that length; the loss and the gradients are
    averaged over it (gradients summed in ``accum_dtype``)."""
    api = get_model(cfg)
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def train_step(params, opt: AdamWState, batch):
        if accum == 1:
            loss, grads = loss_and_grads(api, params, batch)
        else:
            loss, grads = 0.0, tree_map(
                lambda p: torch.zeros_like(p, dtype=accum_dtype,
                                           requires_grad=False), params)
            for i in range(accum):
                l, g = loss_and_grads(api, params,
                                      {k: v[i] for k, v in batch.items()})
                loss = loss + l
                tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)
        params, opt, gnorm = adamw_update(grads, opt, params, lr_fn=lr_fn)
        return {"loss": loss, "grad_norm": gnorm}, params, opt

    return api, train_step


def _trainable(params):
    """Every leaf as a leaf tensor that requires grad."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def train(cfg, *, steps: int, batch_iter, seed: int = 0, device="cuda",
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 50,
          resume: bool = True, hooks: Optional[list] = None,
          base_lr: float = 1e-3, warmup: int = 10) -> Dict[str, Any]:
    """Single-device training loop with checkpoint / restart fault
    tolerance: seeded weights on ``device`` (or the latest checkpoint under
    ``checkpoint_dir`` when ``resume``), ``steps`` steps of
    ``batch_iter(step)``, a checkpoint every ``checkpoint_every`` steps and
    at the end.  ``hooks`` are called as ``hook(step, metrics)`` after each
    step.  Returns the history (every 10th step and the last), the final
    params and optimizer state, the wall time and the final loss."""
    from . import checkpoint as ckpt

    dev = _device.resolve(device)
    api, train_step = make_train_step(cfg, base_lr=base_lr, warmup=warmup,
                                      total_steps=max(steps, 100))
    start_step = 0
    params = opt = None
    if checkpoint_dir and resume:
        p_t = param_specs(cfg)
        restored = ckpt.restore_latest(
            checkpoint_dir, template={"params": p_t, "opt": adamw_init(p_t)},
            device=dev)
        if restored is not None:
            params, opt, meta = restored
            start_step = int(meta["step"])
    if params is None:
        params = api.init(device=dev, seed=seed)
        opt = adamw_init(params)
    params = _trainable(params)

    history = []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        batch = batch_iter(step)
        metrics, params, opt = train_step(params, opt, batch)
        if hooks:
            for h in hooks:
                h(step, metrics)
        if step % 10 == 0 or step == steps - 1:
            history.append({"step": step,
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"])})
        if checkpoint_dir and (step + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, params, opt, {"step": step + 1})
    elapsed = time.perf_counter() - t0
    if checkpoint_dir:
        ckpt.save(checkpoint_dir, params, opt, {"step": steps})
    return {"history": history, "params": params, "opt": opt,
            "elapsed_s": elapsed, "final_loss": history[-1]["loss"]}
