"""sync_wait_ms.decode: the host's time blocked in the device synchronise
of a pure-decode step: mean over the window's pure-decode steps of the
sum of their ``backend.sync`` spans."""
from bench_port.lib import spans


def read(run):
    return spans.decode_mean_ms(run, lambda sp, e: sum(
        c["dur"] for c in sp.under(e["id"], "backend.sync")))
