"""decode_step_ms.steady: wall time of the window's pure-decode
``engine.step`` calls over their count, in a cell below the knee."""
from bench_port.lib import stats


def read(run):
    return stats.decode_step_ms(run)
