"""Full-sequence (flash) attention: CUDA kernels on the card, plain PyTorch on
the CPU.

The attention of ``models.common.blockwise_attention``: every prompt of the
dense-cache ``prefill`` and every layer of ``forward``.  Causal (query i sees
keys j <= i, and the bidirectional prefix j < ``prefix_len``) or non-causal;
any sequence length; GQA by head index.  The kernels are in
``csrc/flash_attention.cu``: bf16 runs on the tensor cores, float32 on the
CUDA cores (exact to 2e-5 with TF32 off, which the tensor cores are not).

Under autograd (grad mode on and an input that requires grad, as in
training) the forward kernel also writes each row's log-sum-exp, and the
backward is the hand-written ``csrc/flash_attention_bwd.cu`` at every
head_dim the forward takes (bf16 on the tensor cores with warpgroup
products, fp32 on the CUDA cores).  Every other call (all of serving) is
the plain forward launch.

The launches are three custom ops (``torch.ops.repro_torch.flash_attention``,
``flash_attention_lse`` with its autograd formula, and
``flash_attention_bwd``), each with a fake implementation and a flop
formula: under ``FakeTensorMode`` (the dry run) no pointer reaches a
launch, and ``torch.utils.flop_counter`` counts the attention.  A DTensor
never reaches them: ``models.common.blockwise_attention`` hands each rank
its local (batch, head) shards through ``local_map``, and this wrapper
raises on a DTensor.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def flash_attention(q, k, v, *, causal: bool, prefix_len: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype.

    A CPU tensor takes the plain version (which autograd differentiates); a
    CUDA tensor launches the kernel (and adds one to
    ``flash_attention.launches``) or raises.  On a CUDA tensor under
    autograd the result has a ``grad_fn`` whose backward launches
    :func:`flash_attention_bwd`.  A DTensor raises: its local shards are
    the caller's to pass (``blockwise_attention``)."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes local tensors, not DTensors "
                        "(models.common.blockwise_attention maps a DTensor "
                        "call onto its local shards)")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   prefix_len=prefix_len)
    _check(q, k, v, causal, prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return torch.ops.repro_torch.flash_attention_lse(
            q, k, v, causal, prefix_len)[0]
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, prefix_len)


flash_attention.launches = 0


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, prefix_len: int) -> torch.Tensor:
    return _forward(q, k, v, causal, prefix_len, with_lse=False)[0]


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def _flash_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, prefix_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return _forward(q, k, v, causal, prefix_len, with_lse=True)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool, prefix_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                               prefix_len=prefix_len)


def _lse_like(q):
    B, Sq, H, _ = q.shape
    return q.new_empty((B, H, Sq), dtype=torch.float32)


_flash_op.register_fake(lambda q, k, v, causal, prefix_len:
                        torch.empty_like(q))
_flash_lse_op.register_fake(lambda q, k, v, causal, prefix_len:
                            (torch.empty_like(q), _lse_like(q)))
_flash_bwd_op.register_fake(
    lambda q, k, v, out, lse, dout, causal, prefix_len:
    (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, prefix_len = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.prefix_len = causal, prefix_len


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.prefix_len)
    return dq, dk, dv, None, None


_flash_lse_op.register_autograd(_backward, setup_context=_setup_context)


def attention_pairs(Sq: int, Sk: int, causal: bool, prefix_len: int) -> int:
    """(query, key) pairs a call visits: every pair, or under ``causal``
    the keys at or before each query's position and the prefix."""
    if not causal:
        return Sq * Sk
    p = min(max(prefix_len, 0), Sk)
    # query i sees max(i + 1, p) keys
    below = min(p, Sq)                       # queries with i + 1 <= p
    return below * p + (Sq * (Sq + 1) - below * (below + 1)) // 2


def _fwd_flops(q_shape, k_shape, causal, prefix_len):
    B, Sq, H, D = q_shape
    return 4 * B * H * D * attention_pairs(Sq, k_shape[1], causal,
                                           prefix_len)


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse])
def _flash_flops(q_shape, k_shape, v_shape, causal, prefix_len, *args,
                 **kwargs) -> int:
    return _fwd_flops(q_shape, k_shape, causal, prefix_len)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape,
                     do_shape, causal, prefix_len, *args, **kwargs) -> int:
    # S recomputed, dV, dP, dQ, dK: five products where the forward has two
    return 5 * _fwd_flops(q_shape, k_shape, causal, prefix_len) // 2


def _forward(q, k, v, causal, prefix_len, *, with_lse):
    """One forward launch -> (out, lse (B, H, Sq) fp32 or None)."""
    _check_pointers(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, Sq, Sk, H, KH, D,
        int(causal), prefix_len, D ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool,
                        prefix_len: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    incoming gradient ``dout`` of its output ``out``, from the forward's
    log-sum-exp ``lse`` (B, H, Sq) fp32; each in its input's dtype.

    CUDA tensors only, any head_dim of ``HEAD_DIMS``: three launches
    (delta, dK/dV, dQ) of ``csrc/flash_attention_bwd.cu``, four when
    :func:`kv_splits` cuts a bf16 dK/dV grid, on the current stream of q's
    device (autograd calls this from its own thread); deterministic (two
    calls give the same bits); adds one to ``flash_attention_bwd.launches``.
    The plain version is ``ref.flash_attention_bwd_ref``."""
    _check(q, k, v, causal, prefix_len)
    _check_pointers(q, k, v)
    dout = dout.contiguous()
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (B, H, Sq), torch.float32)):
        if (t.device != q.device or tuple(t.shape) != tuple(shape)
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype} on "
                f"{t.device} is not a contiguous {tuple(shape)} {dtype} on "
                f"{q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} is not 16-byte "
                             f"aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    splits = (kv_splits(B, Sk, H, KH, _sm_count(q.device),
                        lib.flash_attention_bwd_rows())
              if q.dtype == torch.bfloat16 else 1)
    part = (torch.empty((2, splits, B, Sk, KH, D), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        part.data_ptr() if part is not None else None, splits,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KH, D,
        int(causal), prefix_len, D ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def kv_splits(B: int, Sk: int, H: int, KH: int, sms: int, rows: int) -> int:
    """Blocks the bf16 dK/dV pass gives each (b, KV head, key tile of
    ``rows`` keys, the library's ``flash_attention_bwd_rows()``): the
    smallest divisor of the group H / KH that fills the card's SMs.

    One block per triple walks the whole group and writes dK / dV itself.
    With few KV heads (MQA: paligemma's 8 heads over one) that leaves most
    SMs idle, so the group is cut into parts whose fp32 partial sums one
    more launch adds in order (deterministic).  Splitting a grid that
    already fills the card only adds that traffic."""
    blocks = B * KH * -(-Sk // rows)
    G = H // KH
    return next((d for d in range(1, G + 1)
                 if G % d == 0 and blocks * d >= sms), G)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _check_pointers(q, k, v):
    _check(q, k, v, False, 0)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the kernel copies 16-byte chunks)")
