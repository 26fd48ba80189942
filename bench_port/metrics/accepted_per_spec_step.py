"""accepted_per_spec_step: draft tokens accepted per row of a gamma > 0
step, (committed - batch) / batch averaged over the window's such steps."""
from bench_port.lib import stats


def read(run):
    st = [s for s in stats.window_steps(run) if s.pure_decode and s.gamma > 0]
    if not st:
        return None
    return sum((s.tokens - s.batch) / s.batch for s in st) / len(st)
