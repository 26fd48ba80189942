"""KV-cache block migration (paper §6.4 step 3, and the copy-on-write forks):
CUDA kernel on the card, plain PyTorch on the CPU.

``migrate_blocks`` copies block ``src[i]`` to ``dst[i]`` along axis 1 of a
pool (L, NB+1, ...), or of several pools that share NB+1 (the target's and
the draft's K and V pages), in place and in one kernel launch.  The kernel
is ``csrc/block_migration.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import migrate_blocks_ref

_DTYPES = (torch.float32, torch.bfloat16)
MAX_TENSORS = 8
# plans of at most this many pairs carry their ids in the launch's
# parameters, larger ones upload them first; at most 2,048, the kernel's
# largest inline instance (PERF.md: the two ways' launch times at 64, 512
# and 2,048 pairs on the H100)
INLINE_CAP = 2048


def check_plan(src, dst, num_blocks: int):
    """Host-side checks that make an in-place copy equal to the reference's
    gather-then-scatter: equal lengths, ids in range, ``dst`` unique and
    disjoint from ``src`` (one count of the ``dst`` ids over the pool).
    Returns both as int32 numpy arrays."""
    s = np.asarray(src, dtype=np.int64).reshape(-1)
    d = np.asarray(dst, dtype=np.int64).reshape(-1)
    if s.size != d.size:
        raise ValueError(f"migrate_blocks: {s.size} sources, {d.size} "
                         f"destinations")
    if s.size:
        for name, ids in (("src", s), ("dst", d)):
            if ids.min() < 0 or ids.max() >= num_blocks:
                raise ValueError(f"migrate_blocks: {name} id out of range "
                                 f"[0, {num_blocks})")
        seen = np.bincount(d, minlength=num_blocks)
        if seen.max() > 1:
            raise ValueError("migrate_blocks: dst ids repeat")
        if seen[s].any():
            raise ValueError("migrate_blocks: src and dst overlap; an "
                             "in-place copy would read blocks it already "
                             "overwrote")
    return s.astype(np.int32), d.astype(np.int32)


def _check_pools(pools) -> list:
    if not pools or len(pools) > MAX_TENSORS:
        raise ValueError(f"migrate_blocks: 1 to {MAX_TENSORS} pools, got "
                         f"{len(pools)}")
    for p in pools:
        if p.dim() < 2:
            raise ValueError("migrate_blocks: a pool is (L, NB+1, ...)")
        if p.shape[1] != pools[0].shape[1] or p.device != pools[0].device:
            raise ValueError(
                "migrate_blocks: the pools' NB+1 or device differ "
                f"({tuple(p.shape)} on {p.device} against "
                f"{tuple(pools[0].shape)} on {pools[0].device})")
    return pools


def _launch(pools, s: np.ndarray, d: np.ndarray, *, inline: bool) -> None:
    """One kernel launch over ``pools`` (checked CUDA tensors) for the
    checked plan; the ids travel in the launch when ``inline``, else they
    are uploaded first (pinned, non-blocking).  Counts nothing."""
    for p in pools:
        if p.dtype not in _DTYPES:
            raise ValueError(f"migrate_blocks: dtype {p.dtype} not supported "
                             f"(float32, bfloat16)")
        if p.dim() < 3 or not p.is_contiguous():
            raise ValueError("migrate_blocks: a pool must be a contiguous "
                             "(L, NB+1, ...) tensor")
    # (base, L, bytes per segment, bytes per layer) of each pool
    desc = np.array([(p.data_ptr(), p.shape[0], p.stride(1) * p.element_size(),
                      p.stride(0) * p.element_size()) for p in pools],
                    dtype=np.int64)
    ids = np.concatenate([s, d])
    dev = pools[0].device
    ids_dev = None
    if not inline:
        # the caching host allocator keeps the pinned buffer until the copy
        # has run, so the host does not wait for it
        ids_dev = torch.from_numpy(ids).pin_memory().to(dev,
                                                        non_blocking=True)
    err = _build.library().migrate_blocks_launch(
        desc.ctypes.data, len(pools), ids.ctypes.data,
        None if ids_dev is None else ids_dev.data_ptr(), s.size,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "migrate_blocks")


def migrate_blocks(pools, src, dst):
    """pools: one (L, NB+1, ...) float32 / bfloat16 tensor, or a sequence of
    such tensors on one device that share NB+1 (their L, block shapes and
    dtypes may differ); src/dst: host sequences (list, numpy, CPU tensor) of
    block ids.  Copies in place and returns ``pools``.

    CPU pools take the plain version; CUDA pools launch the kernel once for
    the whole call (and add one to ``migrate_blocks.launches``) or raise."""
    seq = _check_pools([pools] if isinstance(pools, torch.Tensor)
                       else list(pools))
    s, d = check_plan(src, dst, seq[0].shape[1])
    dev = seq[0].device
    if dev.type == "cpu":
        for p in seq:
            migrate_blocks_ref(p, s, d)
        return pools
    if dev.type != "cuda":
        raise ValueError(f"migrate_blocks: no kernel for device {dev}")
    if s.size:
        _launch(seq, s, d, inline=s.size <= INLINE_CAP)
        migrate_blocks.launches += 1
    return pools


migrate_blocks.launches = 0
