"""window_attn_roofline.all_calls: ``window_attn_roofline`` over every call
of the traced slice, the replayed step graphs' included: the least time
of the sliding layers' windowed launches on each call's real rows (its
architecture module's ``window_need``), the call log's calls and each
replayed pure-decode or spec step's calls read from its ``backend.pack``
span (``lib/call_rows.py``), over the device time of the
``WINDOW_KERNELS``.  None where no model of the run has sliding layers."""
from bench_port.lib import call_rows


def _need(arch, cfg, rows, elem):
    if not hasattr(arch, "window_need"):
        return None
    return (call_rows.least_time([arch.window_need(cfg, rows, elem)]),
            arch.WINDOW_KERNELS)


def read(run):
    return call_rows.roofline(run, _need)
