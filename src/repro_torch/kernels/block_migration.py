"""KV-cache block migration (paper §6.4 step 3, and the copy-on-write forks):
CUDA kernel on the card, plain PyTorch on the CPU.

``migrate_blocks`` copies block ``src[i]`` to ``dst[i]`` along axis 1 of a
pool (L, num_blocks, ...) in place.  The kernel is
``csrc/block_migration.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import migrate_blocks_ref

_ELEM_SIZES = {torch.float32: 4, torch.bfloat16: 2}


def check_plan(src, dst, num_blocks: int):
    """Host-side checks that make an in-place copy equal to the reference's
    gather-then-scatter: equal lengths, ids in range, ``dst`` unique and
    disjoint from ``src``.  Returns both as int32 numpy arrays."""
    s = np.asarray(src, dtype=np.int64).reshape(-1).tolist()
    d = np.asarray(dst, dtype=np.int64).reshape(-1).tolist()
    if len(s) != len(d):
        raise ValueError(f"migrate_blocks: {len(s)} sources, {len(d)} "
                         f"destinations")
    for name, ids in (("src", s), ("dst", d)):
        if ids and (min(ids) < 0 or max(ids) >= num_blocks):
            raise ValueError(f"migrate_blocks: {name} id out of range "
                             f"[0, {num_blocks})")
    if len(set(d)) != len(d):
        raise ValueError("migrate_blocks: dst ids repeat")
    if not set(s).isdisjoint(d):
        raise ValueError("migrate_blocks: src and dst overlap; an in-place "
                         "copy would read blocks it already overwrote")
    return np.asarray(s, np.int32), np.asarray(d, np.int32)


def migrate_blocks(pool, src, dst):
    """pool: (L, num_blocks, bs, KH, hd) float32 or bfloat16; src/dst: host
    sequences (list, numpy, CPU tensor) of block ids.  Copies in place and
    returns ``pool``.

    A CPU pool takes the plain version; a CUDA pool launches the kernel once
    (and adds one to ``migrate_blocks.launches``) or raises."""
    s, d = check_plan(src, dst, pool.shape[1])
    if pool.device.type == "cpu":
        return migrate_blocks_ref(pool, s, d)
    if not s.size:
        return pool
    if pool.device.type != "cuda":
        raise ValueError(f"migrate_blocks: no kernel for device {pool.device}")
    if pool.dtype not in _ELEM_SIZES:
        raise ValueError(f"migrate_blocks: dtype {pool.dtype} not supported "
                         f"(float32, bfloat16)")
    if pool.dim() < 3 or not pool.is_contiguous():
        raise ValueError("migrate_blocks: pool must be a contiguous "
                         "(L, num_blocks, ...) tensor")
    L, nb1 = pool.shape[:2]
    seg = pool[0, 0].numel()
    chunks = -(-seg // 256)       # thread blocks per segment, scalar path
    if L > 65535 or chunks > 65535:
        raise ValueError(f"migrate_blocks: pool {tuple(pool.shape)} exceeds "
                         f"the launch grid")
    # pinned + non-blocking: the host does not wait for the id upload, and
    # the caching host allocator keeps the buffer until the copy has run
    ids = torch.from_numpy(np.concatenate([s, d])).pin_memory().to(
        pool.device, non_blocking=True)
    lib = _build.library()
    err = lib.migrate_blocks_launch(
        pool.data_ptr(), ids.data_ptr(), ids[s.size:].data_ptr(), s.size, L,
        nb1, seg, _ELEM_SIZES[pool.dtype],
        torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(err, "migrate_blocks")
    migrate_blocks.launches += 1
    return pool


migrate_blocks.launches = 0
