"""ttft_p95_ms: 95th percentile, over the requests due in the window, of
due time to first token (the queue included)."""
from bench_port.lib import stats


def read(run):
    v = stats.p95(stats.ttft_s(run))
    return None if v is None else 1e3 * v
