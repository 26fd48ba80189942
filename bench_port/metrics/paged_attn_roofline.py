"""paged_attn_roofline: the paged-attention kernel's share of its roofline
over the traced slice: the least time its calls need (their real rows'
bytes over HBM bandwidth or flops over the bf16 peak, whichever is larger,
per call and layer) over the device time of ``paged_attention_kernel``
and ``paged_combine_kernel``."""
import torch

from bench_port.lib import flops

KERNELS = ("paged_attention_kernel", "paged_combine_kernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    spent = sum(s for n, s in tr.kernel_s.items()
                if any(k in n for k in KERNELS))
    if spent <= 0:
        return None
    need = 0.0
    for cfg, rows in tr.calls:
        elem = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        f, b = flops.paged_attention_need(
            rows, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, elem_bytes=elem)
        need += cfg.num_layers * flops.least_time(f, b)
    return 100.0 * need / spent
