"""Full-sequence (flash) attention: CUDA kernel on the card, plain PyTorch on
the CPU.

The attention of ``models.common.blockwise_attention``: every prompt of the
dense-cache ``prefill`` and every layer of ``forward``.  Causal (query i sees
keys j <= i, and the bidirectional prefix j < ``prefix_len``) or non-causal;
any sequence length; GQA by head index.  The kernels are in
``csrc/flash_attention.cu``: bf16 runs on the tensor cores, float32 on the
CUDA cores (exact to 2e-5 with TF32 off, which the tensor cores are not).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def flash_attention(q, k, v, *, causal: bool, prefix_len: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and adds one to ``flash_attention.launches``) or raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   prefix_len=prefix_len)
    _check(q, k, v, causal, prefix_len)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KH, D, int(causal), prefix_len, D ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check(q, k, v, causal, prefix_len):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share a dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B, Sq, H, D) and two equal (B, Sk, KH, D)")
    B, Sq, H, D = q.shape
    Bk, Sk, KH, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if H % KH:
        raise ValueError(f"flash_attention: {H} heads not a multiple of {KH} "
                         f"KV heads")
    if B == 0 or Sq == 0 or Sk == 0:
        raise ValueError("flash_attention: empty batch or sequence")
    if causal and Sq != Sk:
        raise ValueError(f"flash_attention: causal needs Sq == Sk (got {Sq} "
                         f"and {Sk})")
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the kernel copies 16-byte chunks)")
