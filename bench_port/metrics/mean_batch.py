"""mean_batch: decode rows per step, over the window's steps that ran any."""
from bench_port.lib import stats


def read(run):
    st = [s for s in stats.window_steps(run) if s.kind == "decode"
          and s.batch > 0]
    if not st:
        return None
    return sum(s.batch for s in st) / len(st)
