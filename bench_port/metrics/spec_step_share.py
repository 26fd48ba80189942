"""spec_step_share: share of the window's pure-decode steps that the
planner ran with gamma > 0 (each step's ``StepReport``)."""
from bench_port.lib import stats


def read(run):
    st = [s for s in stats.window_steps(run) if s.pure_decode]
    if not st:
        return None
    return 100.0 * sum(1 for s in st if s.gamma > 0) / len(st)
