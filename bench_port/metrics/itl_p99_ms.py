"""itl_p99_ms: 99th percentile, over every gap between two consecutive
output tokens of one request inside the window (all requests together),
of the time a streaming user waits for the next token."""
from bench_port.lib import stats


def read(run):
    v = stats.percentile(stats.token_gaps_s(run), 99)
    return None if v is None else 1e3 * v
