"""step_mfu: the target's useful flops for the prompt positions prefilled
and output tokens served inside the window, over the window's seconds at
the card's dense bf16 peak."""
from bench_port.lib import flops, stats


def read(run):
    return 100.0 * stats.useful_flops(run) / (run.seconds
                                              * flops.PEAK_BF16_FLOPS)
