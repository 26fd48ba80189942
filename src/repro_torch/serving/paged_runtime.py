"""Paged-KV runtime state for the real-execution backend.

One :class:`PagedKVRuntime` per model (target / draft) owns the physical
``(L, num_blocks + 1, block_size, KH, hd)`` key/value page tensors (the last
block is the write-off "trash" block absorbing padded-slot writes) and the
host-side per-sequence materialised lengths.  The logical layout — which
sequence owns which blocks — lives in the :class:`BlockManager`; this class
turns those tables into padded int32 step operands.

The zero-copy contract: admission, decode, speculative verification,
chunked prefill, eviction and completion never move the page tensors.  Per
step, the only host->device traffic is the (B, width) block tables, (B,)
lengths and the token ids; the only device->host traffic is the sampled
tokens (and acceptance counts).  The decoder writes the pages in place.
"""
from __future__ import annotations

from typing import Dict, List, Sequence as Seq, Tuple

import numpy as np
import torch

from ..kernels.block_migration import migrate_blocks
from ..models.registry import ModelAPI
from .kv_cache import BlockManager, MigrationPlan
from .request import Sequence


def bucket_size(n: int) -> int:
    """Next power of two (keeps the set of step shapes small)."""
    return 1 << max(n - 1, 0).bit_length()


def num_blocks_for(cost_model, target_cfg, draft_cfg, block_size: int, *,
                   min_blocks: int = 64, max_blocks: int = 4096,
                   reserve_frac: float = 0.1) -> int:
    """Size the physical pool from the device-memory budget: the tokens that
    fit beside the weights (``RooflineCostModel.kv_capacity_tokens``) divided
    into blocks, clamped to [min_blocks, max_blocks]."""
    toks = cost_model.kv_capacity_tokens(target_cfg, draft_cfg,
                                         reserve_frac=reserve_frac)
    return int(min(max(toks // block_size, min_blocks), max_blocks))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Raw bits on the host: numpy has no bfloat16, so bf16 travels as
    int16 and is reinterpreted on the way back."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


class PagedKVRuntime:
    """Physical paged KV pool + host length bookkeeping for one model."""

    def __init__(self, api: ModelAPI, bm: BlockManager, *, device):
        if not api.supports_paged:
            raise NotImplementedError(
                f"family {api.cfg.family!r} has no paged-KV path")
        self.api = api
        self.bm = bm
        self.num_blocks = bm.total_blocks
        self.block_size = bm.block_size
        self.trash = self.num_blocks          # id of the write-off block
        self.pages = api.init_paged_cache(self.num_blocks, self.block_size,
                                          device=device)
        self.ctx: Dict[int, int] = {}         # req_id -> materialised tokens

    @property
    def bytes_per_block(self) -> int:
        k = self.pages["k_pages"]
        L, _, bs, kh, hd = k.shape
        return 2 * L * bs * kh * hd * k.element_size()  # k + v

    # ------------------------------------------------------------------
    # copy-on-write + elastic physical pool (§6.3/6.4 on the real tier)
    # ------------------------------------------------------------------
    def apply_copies(self, src: Seq[int], dst: Seq[int]) -> None:
        """Block copies src[i] -> dst[i] on the device, ONE block-migration
        launch per page tensor (the CoW fork path and the §6.4 step-3 data
        movement share the kernel).  Only the int32 ids travel."""
        if not len(src):
            return
        for key in ("k_pages", "v_pages"):
            migrate_blocks(self.pages[key], src, dst)

    def apply_plan(self, plan: MigrationPlan) -> None:
        """§6.4 step 3 on the physical paged pools."""
        self.apply_copies(plan.src, plan.dst)

    def spill_blocks(self, ids: Seq[int]) -> Dict[str, np.ndarray]:
        """Device->host gather of whole blocks for the host KV offload tier:
        one batched index gather per page tensor.  Returned arrays have
        shape (L, n, block_size, KH, hd), so ``arr[:, i]`` is block
        ``ids[i]``'s payload (bf16 pools as int16 bit patterns)."""
        idx = torch.as_tensor(list(ids), dtype=torch.long,
                              device=self.pages["k_pages"].device)
        return {key: _to_host(arr[:, idx]) for key, arr in self.pages.items()}

    def restore_blocks(self, ids: Seq[int],
                       payloads: Dict[str, np.ndarray]) -> None:
        """Host->device scatter of spilled block payloads back into the page
        tensors, one batched index scatter per pool; ``payloads`` mirrors
        :meth:`spill_blocks`'s layout."""
        if not len(ids):
            return
        for key, arr in self.pages.items():
            idx = torch.as_tensor(list(ids), dtype=torch.long,
                                  device=arr.device)
            arr[:, idx] = _from_host(payloads[key], arr)

    def grow(self, extra_blocks: int) -> None:
        """§6.3 expansion of the physical pool: extend both page tensors by
        ``extra_blocks``, keeping the trash block LAST.  The old trash slot
        is recycled as ordinary storage — its garbage content is never read
        because per-sequence lengths gate every attention read, and every
        block is written before its positions become readable."""
        def pad(x):
            L, _, bs, kh, hd = x.shape
            z = x.new_zeros((L, extra_blocks, bs, kh, hd))
            return torch.cat([x, z], dim=1)
        self.pages = {k: pad(v) for k, v in self.pages.items()}
        self.num_blocks += extra_blocks
        self.trash = self.num_blocks

    def shrink(self, to_blocks: int) -> None:
        """§6.4 step 5 on the physical pool: trim to ``to_blocks`` + trash.
        Must run after the BlockManager committed its contraction (no table
        references an id >= to_blocks).  The surviving slot at index
        ``to_blocks`` becomes the new trash block."""
        assert to_blocks <= self.num_blocks, (to_blocks, self.num_blocks)
        self.pages = {k: v[:, :to_blocks + 1].clone()
                      for k, v in self.pages.items()}
        self.num_blocks = to_blocks
        self.trash = to_blocks

    def batch_tables(self, seqs: Seq[Sequence], batch: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded (batch, width) int32 block tables + (batch,) materialised
        lengths for one step.  Rows beyond ``len(seqs)`` and table entries
        beyond a sequence's allocation are the trash id, which both satisfies
        the kernel's "any valid id" padding contract and guarantees padded
        slots can only ever write to the trash block."""
        # the physical pool must follow BlockManager.expand()/contraction in
        # lockstep (``grow``/``shrink``, wired through the memory manager's
        # grow_fn/shrink_fn hooks) — a drifted allocator would hand out ids
        # colliding with the trash block / falling outside the pages, so
        # fail loudly instead of corrupting KV
        assert self.bm.total_blocks == self.num_blocks, (
            "BlockManager pool size drifted from the physical paged pool "
            f"({self.bm.total_blocks} != {self.num_blocks}); wire "
            "PagedKVRuntime.grow/shrink into the ElasticMemoryManager "
            "(see RealBackend.grow_pools/shrink_pools)")
        rows: List[List[int]] = [list(self.bm.tables.get(s.req_id, ()))
                                 for s in seqs]
        width = bucket_size(max((len(r) for r in rows), default=1) or 1)
        tables = np.full((batch, width), self.trash, np.int32)
        lengths = np.zeros((batch,), np.int32)
        for i, (s, row) in enumerate(zip(seqs, rows)):
            tables[i, :len(row)] = row
            lengths[i] = self.ctx.get(s.req_id, 0)
        return tables, lengths
