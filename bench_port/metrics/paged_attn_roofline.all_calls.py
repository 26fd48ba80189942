"""paged_attn_roofline.all_calls: ``paged_attn_roofline`` over every call
of the traced slice, the replayed step graphs' included: the least time
of each call's real rows (its architecture module's ``attention_need``),
the call log's calls and each replayed pure-decode or spec step's calls
read from its ``backend.pack`` span (``lib/call_rows.py``), over the
device time of the ``ATTENTION_KERNELS``.  A program without graphs reads
as ``paged_attn_roofline``."""
from bench_port.lib import call_rows


def _need(arch, cfg, rows, elem):
    return (call_rows.least_time(arch.attention_need(cfg, rows, elem)),
            arch.ATTENTION_KERNELS)


def read(run):
    return call_rows.roofline(run, _need)
