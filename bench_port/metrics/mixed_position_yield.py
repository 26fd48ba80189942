"""mixed_position_yield: real positions over positions run in the target's
calls of the window's mixed steps: the sum of ``positions_valid`` over the
sum of ``positions_run`` of their ``backend.pack`` spans of model
``target``."""
from bench_port.lib import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    run_n = valid = 0
    for e, _ in sp.steps(run, spans.mixed):
        for p in sp.under(e["id"], "backend.pack"):
            if p["args"].get("model") == "target":
                run_n += p["args"]["positions_run"]
                valid += p["args"]["positions_valid"]
    return 100.0 * valid / run_n if run_n else None
