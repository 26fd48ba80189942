"""idle_in_dispatch_share: the traced slice's device-idle time under the
innermost program range ``nightjar.backend.dispatch`` (the host enqueueing
a model call), over all its idle time."""
from bench_port.lib import spans


def read(run):
    return spans.idle_share(run, lambda k: k == "backend.dispatch")
