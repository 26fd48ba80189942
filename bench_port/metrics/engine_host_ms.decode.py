"""engine_host_ms.decode: the engine's own host time in a pure-decode
step: mean over the window's pure-decode steps of the ``step`` span less
its ``engine.execute`` and ``engine.catchup`` children."""
from bench_port.lib import spans


def read(run):
    return spans.decode_mean_ms(run, lambda sp, e: e["dur"] - sum(
        c["dur"] for c in sp.kids.get(e["id"], ())
        if c["name"] in ("engine.execute", "engine.catchup")))
