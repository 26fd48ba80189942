"""Plain PyTorch versions of the package's CUDA kernels.

The CPU path of the wrappers, and the ground truth the kernels are held
against on the card (``chip_smoke.py``, the ``cuda``-marked tests).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def migrate_blocks_ref(pool, src, dst):
    """pool: (L, num_blocks, ...); copy blocks src[i] -> dst[i] along axis 1,
    in place.  The source blocks are gathered before any destination is
    written, so overlapping maps behave like the functional
    ``x.at[dst].set(x[src])``."""
    src = torch.as_tensor(src, dtype=torch.long, device=pool.device)
    dst = torch.as_tensor(dst, dtype=torch.long, device=pool.device)
    pool[:, dst] = pool[:, src]
    return pool


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """Attention of a T-token extension over paged KV.

    q:            (B, H, D) single-query decode, or (B, T, H, D) multi-query
    k/v_pages:    (num_blocks, block_size, KH, D)
    block_tables: (B, max_blocks) int32, padded with any valid id
    lengths:      (B,) valid token counts INCLUDING the T new positions
                  (whose K/V are already written into the pages); query t
                  attends to positions <= lengths - T + t
    returns       same shape and dtype as q
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, T, H, D = q.shape
    _, bs, KH, _ = k_pages.shape
    G = H // KH
    S = block_tables.shape[1] * bs
    tables = block_tables.long()

    # gather each sequence's KV contiguously
    k = k_pages[tables].reshape(B, S, KH, D).float()
    v = v_pages[tables].reshape(B, S, KH, D).float()
    qg = q.reshape(B, T, KH, G, D).float() * (D ** -0.5)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    t_idx = torch.arange(T, device=q.device)
    limit = lengths.long()[:, None] - T + t_idx[None, :]          # (B, T)
    mask = torch.arange(S, device=q.device)[None, None, :] <= limit[:, :, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    out = out.reshape(B, T, H, D).to(q.dtype)
    return out[:, 0] if squeeze else out
