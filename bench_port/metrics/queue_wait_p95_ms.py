"""queue_wait_p95_ms: 95th percentile, over the requests due in the window,
of due time to the start of the step that ran their first prefill chunk."""
from bench_port.lib import stats


def read(run):
    v = stats.p95(stats.queue_wait_s(run))
    return None if v is None else 1e3 * v
