"""Paged multi-query attention: CUDA kernel on the card, plain PyTorch on the
CPU.

One call serves plain decode (T=1), speculative verification (T=gamma+1) and
prefill / chunked-prefill appends (T=chunk).  ``lengths`` counts the valid
tokens INCLUDING the T new positions; query t attends to page positions
<= lengths - T + t.  The kernel is ``csrc/paged_attention.cu``.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
BLOCK_SIZES = (4, 8, 16)


def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """q: (B, H, D) or (B, T, H, D); k/v_pages: (num_blocks, block_size, KH,
    D); block_tables: (B, max_blocks) int32, padded with any valid id;
    lengths: (B,) int32 -> output of q's shape and dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and adds one to ``paged_attention.launches``) or raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    B, T, H, D = q4.shape
    _, bs, KH, Dk = k_pages.shape
    _check(q4, k_pages, v_pages, block_tables, lengths, B, H, D, bs, KH, Dk)
    out = torch.empty_like(q4)
    lib = _build.library()
    err = lib.paged_attention_launch(
        q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, T, H, KH, D, bs, block_tables.shape[1], D ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out[:, 0] if squeeze else out


paged_attention.launches = 0


def _check(q, k_pages, v_pages, tables, lengths, B, H, D, bs, KH, Dk):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {dev}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_attention: q, k_pages and v_pages must share "
                         "a dtype")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and lengths must be "
                         "int32")
    if k_pages.shape != v_pages.shape or Dk != D:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit head_dim {D}")
    if H % KH:
        raise ValueError(f"paged_attention: {H} heads not a multiple of "
                         f"{KH} KV heads")
    if D not in HEAD_DIMS or bs not in BLOCK_SIZES:
        raise ValueError(f"paged_attention: head_dim {D} / block_size {bs} "
                         f"not in {HEAD_DIMS} / {BLOCK_SIZES}")
    if tables.dim() != 2 or tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError("paged_attention: block_tables must be (B, max_blocks)"
                         " and lengths (B,)")
    if B == 0 or tables.shape[1] == 0:
        raise ValueError("paged_attention: empty batch or block table")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
