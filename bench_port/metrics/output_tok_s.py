"""output_tok_s: output tokens served inside the window over its seconds."""
from bench_port.lib import stats


def read(run):
    return stats.output_tok_s(run)
