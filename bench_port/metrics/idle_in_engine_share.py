"""idle_in_engine_share: the traced slice's device-idle time under the
engine's own phases (the innermost range ``nightjar.engine.*`` other than
``engine.execute``), over all its idle time."""
from bench_port.lib import spans


def read(run):
    return spans.idle_share(run, lambda k: k.startswith("engine.")
                            and k != "engine.execute")
