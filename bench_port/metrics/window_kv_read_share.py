"""window_kv_read_share: the K / V positions a sliding layer of the target
reads over those a full layer reads, over the target's calls in the traced
slice: the sum of ``kv_read_window`` over the sum of ``kv_read_full`` of
the ``backend.pack`` spans of model ``target`` or ``spec`` (whose verify
is the target's) in the window's steps that the slice traced.  None where
the program records no such counters (a target without a window)."""
from bench_port.lib import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    traced = set(run.trace.kernels_by_step)
    full = window = 0
    for e, _ in sp.steps(run, lambda rec: rec.index in traced):
        for p in sp.under(e["id"], "backend.pack"):
            a = p["args"]
            if a.get("model") in ("target", "spec") and "kv_read_full" in a:
                full += a["kv_read_full"]
                window += a["kv_read_window"]
    return 100.0 * window / full if full else None
