"""setup_s: process start to window open — imports, the kernel library's
load (its first build in a checkout), weights, pool, warm-up, lead-in."""


def read(run):
    return run.setup_s
