"""mixed_step_ms.steady: wall time of the window's ``engine.step`` calls
that run a prefill chunk beside decode rows, over their count, in a cell
below the knee: the stall a decoding request sees when a prompt arrives."""
from bench_port.lib import stats


def read(run):
    return stats.mixed_step_ms(run)
