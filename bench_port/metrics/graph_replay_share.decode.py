"""graph_replay_share.decode: the share of the model calls of the window's
pure-decode steps that replayed a captured step graph: the
``backend.dispatch`` spans under each step's ``engine.execute`` whose
``graph`` arg is ``replay``, over all of them.  A draft catch-up (under
``engine.catchup``) is a packed call, eager by design, and is left out.
None where no such span carries ``graph``: a program without step
graphs."""
from bench_port.lib import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    modes = [d["args"].get("graph")
             for e, _ in sp.steps(run, lambda rec: rec.pure_decode)
             for x in sp.under(e["id"], "engine.execute")
             for d in sp.under(x["id"], "backend.dispatch")]
    if all(m is None for m in modes):
        return None
    return 100.0 * sum(m == "replay" for m in modes) / len(modes)
