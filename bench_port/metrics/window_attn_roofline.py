"""window_attn_roofline: the windowed paged-attention launches' share of
their roofline over the traced slice: the least time the sliding layers'
calls need (per call and sliding layer, the real rows' bytes inside the
window over HBM bandwidth or their flops over the bf16 peak, whichever is
larger: the calling model's architecture module's ``window_need``) over
the device time of the kernels that module names ``WINDOW_KERNELS``
(``paged_window_attention_kernel`` and ``paged_window_combine_kernel``
for ``swa_moe``).  None where no model of the run has sliding layers or
the slice holds none of their launches."""
import torch

from bench_port.lib import flops


def read(run):
    tr = run.trace
    if tr is None:
        return None
    need, kernels = 0.0, set()
    for cfg, rows in tr.calls:
        arch = run.arch_of(cfg)
        if not hasattr(arch, "window_need"):
            continue
        kernels.update(arch.WINDOW_KERNELS)
        elem = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        n, f, b = arch.window_need(cfg, rows, elem)
        need += n * flops.least_time(f, b)
    spent = sum(s for name, s in tr.kernel_s.items()
                if any(k in name for k in kernels))
    if spent <= 0:
        return None
    return 100.0 * need / spent
