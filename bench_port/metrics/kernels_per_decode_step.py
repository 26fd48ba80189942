"""kernels_per_decode_step: device kernels (copies and fills left out) run
inside each pure-decode step of the traced slice, averaged."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = {s.index for s in run.steps if s.pure_decode}
    counts = [n for i, n in tr.kernels_by_step.items() if i in steps]
    if not counts:
        return None
    return sum(counts) / len(counts)
