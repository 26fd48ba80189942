"""paged_attn_roofline: the paged-attention kernel's share of its roofline
over the traced slice: the least time its calls need (their real rows'
bytes over HBM bandwidth or flops over the bf16 peak, whichever is larger,
per call and layer, as the architecture module of the model that made the
call counts them: ``attention_need``) over the device time of the kernels
those modules name (``ATTENTION_KERNELS``: ``paged_attention_kernel`` and
``paged_combine_kernel`` for ``gqa``)."""
import torch

from bench_port.lib import flops


def read(run):
    tr = run.trace
    if tr is None:
        return None
    need, kernels = 0.0, set()
    for cfg, rows in tr.calls:
        arch = run.arch_of(cfg)
        kernels.update(arch.ATTENTION_KERNELS)
        elem = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        need += sum(n * flops.least_time(f, b)
                    for n, f, b in arch.attention_need(cfg, rows, elem))
    spent = sum(s for n, s in tr.kernel_s.items()
                if any(k in n for k in kernels))
    if spent <= 0:
        return None
    return 100.0 * need / spent
