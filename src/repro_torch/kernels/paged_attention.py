"""Paged multi-query attention: CUDA kernel on the card, plain PyTorch on the
CPU.

One call serves plain decode (T=1), speculative verification (T=gamma+1) and
prefill / chunked-prefill appends (T=chunk).  ``lengths`` counts the valid
tokens INCLUDING the T new positions; query t attends to page positions
<= lengths - T + t.  The kernel is ``csrc/paged_attention.cu``.

Long contexts are split across blocks (split-KV): ``split_plan`` picks the
number of splits on the host from the table width and the card's SM count,
so the call never waits for the device.  One split (every context the serve
runs today) is one device launch; more add a combine launch over fp32
partials in scratch allocated here.

A ``window`` > 0 (a sliding-window layer) lets query t see only positions
p - window + 1 .. p.  It launches the kernel's windowed twin, under kernel
names of its own (``paged_window_attention_kernel``,
``paged_window_combine_kernel``), and the split plan covers only the span
the window leaves (``window_span``), not the whole table.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
BLOCK_SIZES = (4, 8, 16)
TILE = 32             # key positions per tile (csrc kTile)
ROWS_PER_BLOCK = 16   # query rows per block (csrc kRows)
MIN_SPLIT_TILES = 4   # a split takes at least 128 positions
WAVES = 4             # blocks per SM over the whole table: a table the
                      # serve buckets to a power of two is at least half
                      # full, so about two blocks per SM hold positions


def split_plan(B: int, KH: int, rows: int, max_positions: int,
               sm_count: int) -> tuple:
    """(number of splits, tiles per split) for a call whose block table
    reaches ``max_positions`` (= width * block_size) positions.  Splits are
    added until the grid holds about ``WAVES`` blocks per SM, each split
    keeping at least ``MIN_SPLIT_TILES`` tiles; a grid that fills the card
    already, or a table of fewer than 2 * MIN_SPLIT_TILES tiles, takes one
    split."""
    tiles = max(-(-max_positions // TILE), 1)
    blocks = B * KH * -(-rows // ROWS_PER_BLOCK)
    want = -(-WAVES * sm_count // blocks)
    n = max(1, min(want, tiles // MIN_SPLIT_TILES))
    per = -(-tiles // n)
    return -(-tiles // per), per


def window_span(max_positions: int, T: int, window: int) -> int:
    """Positions a windowed call's splits walk: from the earliest window
    start of a row's T queries, rounded down to a tile, to its last
    position — at most window + T - 1 of them and a tile's slack, and never
    more than the table holds."""
    return min(max_positions, window + T + TILE - 2)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_attention(q, k_pages, v_pages, block_tables, lengths, window=0):
    """q: (B, H, D) or (B, T, H, D); k/v_pages: (num_blocks, block_size, KH,
    D); block_tables: (B, max_blocks) int32, padded with any valid id;
    lengths: (B,) int32 -> output of q's shape and dtype.  ``window`` > 0:
    query t sees positions lengths - T + t - window + 1 onwards only.

    A query row that sees no position (lengths[b] < T) gets the mean of V
    over the whole table, as the plain version and the JAX kernel give
    (without a window: a windowed call needs lengths >= T).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (adds one to ``paged_attention.launches``, and with a window to
    ``paged_attention.window_launches`` too, and sets
    ``paged_attention.last_splits``) or raises.  The kernel has no
    backward: under autograd with an input that requires grad it raises
    rather than return a result detached from the graph."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   window)
    if torch.is_grad_enabled() and (q.requires_grad or k_pages.requires_grad
                                    or v_pages.requires_grad):
        raise RuntimeError("paged_attention: the CUDA kernel has no backward; "
                           "call it under torch.no_grad() or on tensors "
                           "that do not require grad")
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    B, T, H, D = q4.shape
    _, bs, KH, Dk = k_pages.shape
    _check(q4, k_pages, v_pages, block_tables, lengths, B, H, D, bs, KH, Dk)
    if window < 0:
        raise ValueError(f"paged_attention: window {window} < 0")
    out = torch.empty_like(q4)
    maxb = block_tables.shape[1]
    rows = T * (H // KH)
    span = window_span(maxb * bs, T, window) if window else maxb * bs
    n_splits, per = split_plan(B, KH, rows, span, _sm_count(q.device.index))
    acc_ptr = ml_ptr = None
    if n_splits > 1:
        # fp32 partials indexed (b, kv head, row, split): accumulators and
        # (max, sum) pairs
        part_acc = torch.empty((B, KH, rows, n_splits, D),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, KH, rows, n_splits, 2),
                              dtype=torch.float32, device=q.device)
        acc_ptr, ml_ptr = part_acc.data_ptr(), part_ml.data_ptr()
    lib = _build.library()
    args = (q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            acc_ptr, ml_ptr, B, T, H, KH, D, bs, maxb, n_splits, per,
            D ** -0.5, _DTYPES[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if window:
        err = lib.paged_window_attention_launch(*args, window, stream)
    else:
        err = lib.paged_attention_launch(*args, stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.window_launches += bool(window)
    paged_attention.last_splits = n_splits
    return out[:, 0] if squeeze else out


paged_attention.launches = 0
paged_attention.window_launches = 0   # the launches with a window
paged_attention.last_splits = 0   # splits of the last launch


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
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             f"aligned (the kernel copies 16-byte chunks)")
